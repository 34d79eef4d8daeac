// K1 in bf16, the inference biLSTM recurrence on Hopper's tensor cores with
// W_hh resident in the shared memory of a thread-block cluster. Replaces
// pepper_tpu/ops/fused_lstm.py::_bilstm_step_kernel for hidden sizes 64, 128
// and 256.
//
// What bounds it on the H100 (B=16384, T=33, H=256): 0.567 TFLOP in the
// recurrent product per launch (0.57 ms on bf16 tensor cores, 8.5 ms as f32
// FMAs) against 2.77 GB of xp in and h out (0.83 ms): the roofline is the
// memory's. W_hh (512 KiB per direction) fits no SM's 227 KB, so a kernel
// whose block owns all 4H columns re-reads it from L2 every step (35 GB a
// launch with 16-row tiles), and its FMAs run outside the tensor cores.
//
// What this design does about it: a cluster of H/64 blocks (4 at H=256) owns
// one 64-row batch tile of one direction. Block r keeps the W_hh rows of its
// 64 hidden units (all four gates: 256 rows of H, 128 KiB at H=256) in
// shared memory for all T steps, read once per launch, and both buffers of
// the tile's h (64 x H bf16 each). Per step its 8 warps compute
// [64, H] @ [H, 256] with mma.sync m16n8k16 (bf16 in, f32 accumulate),
// operands through ldmatrix from rows padded by 16 bytes (no bank
// conflicts). Warp w owns units 8w..8w+7: its four n-blocks are the four
// gates of those units, so a thread's accumulator fragment holds i, f, g, o
// of each (row, unit) pair it owns and the cell update needs no exchange; c
// stays in f32 registers. The raw xp of the step (16 bytes a thread per row:
// xp's columns are packed as [unit pair][gate][unit]) is loaded before the
// product and is in flight over it; the two biases are added in the step
// with the plain version's rounding. The new h slice goes to the block's own
// buffer, then in 16-byte pieces to every peer's (distributed shared memory)
// and to the output (the output stores go between the barrier's arrive and
// its wait), and the cluster meets at one barrier per step (h is
// double-buffered). The activations use tanh.approx (sigmoid(x) =
// 0.5 tanh(x/2) + 0.5): one special-function operation each, 2^-11 relative
// error, below bf16's resolution. As many clusters as the card holds at once
// are launched, and each walks over its share of the batch tiles with W_hh in
// place. Two variants that overlap one half-tile's product with the other's
// cell update and exchange measured slower on the H100 at B=16384, T=33 than
// this lockstep kernel: 32-row tiles in clusters of 8 blocks of 4 warps, two
// blocks per SM; and the 64-row tile split into two 32-row halves of 4 warps
// that take the tensor cores in turns and meet their peers at mbarriers.

#pragma once

#include "fused_lstm_cluster.cuh"

namespace {

constexpr int kMB = 4;                    // 16-row m-blocks per batch tile
constexpr int kMmaRows = 16 * kMB;        // batch rows per cluster
constexpr int kMmaUnits = 64;             // hidden units per block: 8 warps x 8
constexpr int kMmaThreads = 256;

// Two bf16 sums at once, each rounded to bf16. A sum of two bf16 values is
// exact in f32 unless their exponents differ by more than 16, and then the
// smaller one is under half a bf16 unit of the larger: either way this is
// the bf16 that the plain version's f32 add, rounded to bf16, gives.
__device__ __forceinline__ uint32_t add_pair(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// A 16-byte load that stays where it is written, before the product whose
// time hides its latency (a plain load may be moved down to its first use).
__device__ __forceinline__ uint4 load_early(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// element e (0 low, 1 high) of a packed pair of bf16, widened
__device__ __forceinline__ float pair_elem(uint32_t pair, int e) {
  return __uint_as_float(e ? (pair & 0xffff0000u) : (pair << 16));
}

// grid (kH/64 * clusters, 2 directions) in clusters of kH/64 blocks along x,
// block 256 threads, dynamic shared memory (4*64 + 2*64) * (kH + 8) * 2 bytes; cluster i takes the
// 64-row batch tiles i, i + clusters, ... of the n_tiles.
// xp_*:  [B, T, 4H] raw input projections; column 8*(u/2) + 2q + u%2 holds
//        gate q (i, f, g, o) of hidden unit u
// w_*:   [4H, H] rows of W_hh; row 32*(u/8) + 8q + u%8 holds gate q of unit u
// bias:  [2 directions][b_ih, b_hh][4H] in xp's column order
// out:   [B, T, 2H]; direction d writes columns [d*H, (d+1)*H)
template <int kH>
__global__ void __launch_bounds__(kMmaThreads, 1)
bilstm_mma_kernel(const __nv_bfloat16* __restrict__ xp_f,
                  const __nv_bfloat16* __restrict__ xp_b,
                  const __nv_bfloat16* __restrict__ w_f,
                  const __nv_bfloat16* __restrict__ w_b,
                  const __nv_bfloat16* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int B, int steps,
                  int n_tiles) {
  using bf16 = __nv_bfloat16;
  constexpr int kStride = kH + 8;           // elements per padded row
  constexpr int kCluster = kH / kMmaUnits;
  constexpr int kChunks = kH / 8;           // 16-byte pieces per row of W
  constexpr int G = 4 * kH;
  constexpr int kPieces = kMmaRows * (kMmaUnits / 8) / kMmaThreads;
  extern __shared__ __align__(16) unsigned char mma_smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(mma_smem_raw);     // [256][kStride]
  bf16* h_s = w_s + 4 * kMmaUnits * kStride;             // [2][64][kStride]

  const int rank = static_cast<int>(cluster_rank());
  const int dir = blockIdx.y;
  const bf16* __restrict__ xp = dir ? xp_b : xp_f;
  const bf16* __restrict__ w = dir ? w_b : w_f;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // this thread's unit pair: units pair_col, pair_col + 1 of the layer
  const int pair_col = rank * kMmaUnits + 8 * warp + 2 * tq;
  const int xp_col = 4 * pair_col;          // 8 * (u / 2)

  // this block's 256 rows of W_hh, for all steps of all its tiles
  for (int i = tid; i < 4 * kMmaUnits * kChunks; i += kMmaThreads) {
    const int n = i / kChunks, ch = i % kChunks;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        w + (size_t)(rank * 4 * kMmaUnits + n) * kH + 8 * ch));
    *reinterpret_cast<uint4*>(w_s + n * kStride + 8 * ch) = v;
  }
  const uint4 bi4 = __ldg(reinterpret_cast<const uint4*>(
      bias + (size_t)(2 * dir) * G + xp_col));
  const uint4 bh4 = __ldg(reinterpret_cast<const uint4*>(
      bias + (size_t)(2 * dir + 1) * G + xp_col));
  const uint32_t b_ih[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
  const uint32_t b_hh[4] = {bh4.x, bh4.y, bh4.z, bh4.w};
  // ldmatrix lane addresses: A rows (lane & 15), k offset 8 * (lane >> 4);
  // B rows (n) (lane & 7) + 8 * (lane >> 4), k offset 8 * ((lane >> 3) & 1)
  const uint32_t w_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      w_s + (32 * warp + (lane & 7) + 8 * (lane >> 4)) * kStride
      + 8 * ((lane >> 3) & 1)));
  const uint32_t h_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      h_s + (lane & 15) * kStride + 8 * (lane >> 4)));
  cluster_arrive();           // every peer is resident before the first
  cluster_wait();             // write into its shared memory

  // the cluster walks over its share of the batch tiles with W_hh in place
  const int n_clusters = gridDim.x / kCluster;
  for (int tile = blockIdx.x / kCluster; tile < n_tiles; tile += n_clusters) {
    const int b0 = tile * kMmaRows;
    // h_0 = 0 in buffer 0 (no peer writes there before the first barrier),
    // c_0 = 0
    for (int i = tid; i < kMmaRows * kStride / 8; i += kMmaThreads)
      reinterpret_cast<uint4*>(h_s)[i] = make_uint4(0u, 0u, 0u, 0u);
    float c[kMB][2][2];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        c[mb][half][0] = c[mb][half][1] = 0.0f;
    }
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      const int t = dir ? steps - 1 - s : s;
      const int cur = s & 1;
      bf16* h_next = h_s + (cur ^ 1) * kMmaRows * kStride;

      // this step's xp, in flight over the product
      uint4 xv[kMB][2];
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int b = b0 + 16 * mb + 8 * half + g;
          xv[mb][half] = make_uint4(0u, 0u, 0u, 0u);
          if (b < B)
            xv[mb][half] =
                load_early(xp + ((size_t)b * steps + t) * G + xp_col);
        }
      }

      float acc[kMB][4][4];                // [m-block][gate][fragment]
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mb][q][e] = 0.0f;
        }
      }
      const uint32_t a_addr = h_addr + cur * kMmaRows * kStride * 2;
#pragma unroll 4
      for (int kk = 0; kk < kH / 16; ++kk) {
        uint32_t b01[4], b23[4];           // gates i, f and g, o
        ldmatrix_x4(b01, w_addr + kk * 32);
        ldmatrix_x4(b23, w_addr + 16 * kStride * 2 + kk * 32);
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) {
          uint32_t a[4];
          ldmatrix_x4(a, a_addr + mb * 16 * kStride * 2 + kk * 32);
          mma_bf16(acc[mb][0], a, b01[0], b01[1]);
          mma_bf16(acc[mb][1], a, b01[2], b01[3]);
          mma_bf16(acc[mb][2], a, b23[0], b23[1]);
          mma_bf16(acc[mb][3], a, b23[2], b23[3]);
        }
      }

      // fragment e of an m-block: row g + 8 * (e / 2), unit pair_col + e % 2
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t xq[4] = {xv[mb][half].x, xv[mb][half].y,
                                  xv[mb][half].z, xv[mb][half].w};
          uint32_t xb[4];                  // round(round(xp + b_ih) + b_hh)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xb[q] = add_pair(add_pair(xq[q], b_ih[q]), b_hh[q]);
          float h_pair[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pre[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              pre[q] = pair_elem(xb[q], e) + acc[mb][q][2 * half + e];
            float& cell = c[mb][half][e];
            cell = sigmoid_fast(pre[1]) * cell
                   + sigmoid_fast(pre[0]) * tanh_fast(pre[2]);
            h_pair[e] = sigmoid_fast(pre[3]) * tanh_fast(cell);
          }
          const __nv_bfloat162 h2 =
              __floats2bfloat162_rn(h_pair[0], h_pair[1]);
          *reinterpret_cast<__nv_bfloat162*>(
              h_next + (16 * mb + 8 * half + g) * kStride + pair_col) = h2;
        }
      }
      __syncthreads();
      // the block's h slice (64 rows x 64 units), 16 bytes at a time, to
      // every peer's buffer, then (the barrier under way) to the output
      uint4 piece[kPieces];
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        const int i = tid + j * kMmaThreads;
        const int row = i / (kMmaUnits / 8), ch = i % (kMmaUnits / 8);
        const bf16* at = h_next + row * kStride + rank * kMmaUnits + 8 * ch;
        piece[j] = *reinterpret_cast<const uint4*>(at);
#pragma unroll
        for (int peer = 0; peer < kCluster; ++peer) {
          if (peer != rank) store_peer(peer_shared(at, peer), piece[j]);
        }
      }
      // also the last step's: no block may exit, or start its next tile,
      // before its peers' last write
      cluster_arrive();
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        const int i = tid + j * kMmaThreads;
        const int row = i / (kMmaUnits / 8), ch = i % (kMmaUnits / 8);
        const int b = b0 + row;
        if (b < B)
          *reinterpret_cast<uint4*>(out + ((size_t)b * steps + t) * 2 * kH
                                    + dir * kH + rank * kMmaUnits + 8 * ch) =
              piece[j];
      }
      cluster_wait();
    }
  }
}


template <int kH>
int launch_mma_h(const void* xp_f, const void* xp_b, const void* w_f,
                 const void* w_b, const void* bias, void* out, int B,
                 int steps, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem =
      (size_t)(4 * kMmaUnits + 2 * kMmaRows) * (kH + 8) * sizeof(bf16);
  const int n_tiles = (B + kMmaRows - 1) / kMmaRows;
  return launch_cluster(
      bilstm_mma_kernel<kH>, kH / kMmaUnits, n_tiles, kMmaThreads, smem,
      stream, static_cast<const bf16*>(xp_f), static_cast<const bf16*>(xp_b),
      static_cast<const bf16*>(w_f), static_cast<const bf16*>(w_b),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, steps,
      n_tiles);
}

inline int launch_mma(const void* xp_f, const void* xp_b, const void* w_f,
                      const void* w_b, const void* bias, void* out, int B,
                      int steps, int H, cudaStream_t stream) {
  if (H == 256)
    return launch_mma_h<256>(xp_f, xp_b, w_f, w_b, bias, out, B, steps, stream);
  if (H == 128)
    return launch_mma_h<128>(xp_f, xp_b, w_f, w_b, bias, out, B, steps, stream);
  return launch_mma_h<64>(xp_f, xp_b, w_f, w_b, bias, out, B, steps, stream);
}

}  // namespace
