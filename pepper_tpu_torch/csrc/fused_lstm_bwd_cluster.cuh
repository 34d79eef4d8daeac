// K4 for hidden sizes 64, 128 and 256: the biLSTM BPTT backward with W_hh
// resident in the shared memory of a thread-block cluster, then dW_hh as a
// register-blocked f32 product split over (b, t) and summed in a fixed
// order. Replaces pepper_tpu/ops/fused_lstm.py::_bilstm_bwd_kernel.
//
// What bounds it on the H100 (B=512, T=33, H=256, f32): the recurrence's
// dgates @ W_hh and dW_hh's h_prev^T @ dgates are 17.7 GFLOP each (0.26 ms
// each at the 67 TFLOP/s FP32 peak) against ~0.42 GB moved, so operations
// bound both. But the recurrence has 33 serial steps of a [16, 4H] @ [4H, H]
// product per batch tile, and W_hh (1 MiB of f32 per direction) fits no SM:
// a block that streams it from L2 every step (the generic kernel) waits
// ~70 us a step on that stream, whatever its batch.
//
// What this design does about it. The recurrence: a cluster of H/32 blocks
// owns one 16-row batch tile of one direction, block r the hidden units
// 32r..32r+31. Block r keeps, for the whole launch, the 128 rows of W_hh
// that hold its units' four gates, in f32 shared memory: exactly the slice
// K3's block r holds, columns 128r..128r+127 of the forward's pack (W_hh^T,
// column 4u+q = gate q of unit u), read from that pack (widened from bf16 on
// load). Per step a block rebuilds its units' dgates [16, 128] from the
// forward's residuals, its dc registers and the incoming dh of its units,
// writes them to dxp in the original gate order, and forms the partial
// product dh_part[16, H] = dgates_r @ W_rows_r: only its own gate columns
// contribute, so no block needs another's dgates. The 32-column slice of the
// partial that belongs to block p goes into p's shared memory (2 KiB per
// peer at H=256, the bytes K3 exchanges), the cluster meets at one barrier
// (the partial buffers alternate, so one barrier per step is enough), and
// each block sums the H/32 partials of its units in rank order: two calls
// give identical bits with no atomics. The last step (the direction's first
// forward step) needs no product: its dh would flow into the zero initial
// state. Inside a block, thread (k, row group) of the product owns output
// column k for 16 / (256 / H) rows: one 16-byte W load (its own row of the
// slice, rows padded so a quarter warp hits distinct banks) and one
// broadcast 16-byte dgates load per row and four k. As many clusters as the
// card holds are launched; each walks over its share of the tiles with
// W_hh in place.
//
// dW_hh[d] = sum over (b, t) of dgates^T h_prev is a [4H, N] x [N, H]
// product with N = B*T. A block owns a 128 x 128 tile (128 x 64 at H=64)
// and one of a fixed number of chunks of N, chosen from the shape alone so
// that a launch has ~256 blocks: two per SM. Each thread keeps an 8 x 8
// patch of the tile in registers (four 16-byte shared-memory loads per 64
// FMAs), and 16-row slabs of dgates and h_prev come in by cp.async, double
// buffered, zero-filled past the chunk and at each direction's first step.
// The chunks' partial tiles are summed in chunk order by a second kernel, so
// two calls give identical bits. f32 FMAs throughout: TF32 would change the
// trainer's gradients beyond its tolerance.

#pragma once

#include "fused_lstm_cluster.cuh"

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdCols = 4 * kFmaUnits;   // W_hh rows (pack columns) a
                                          // block keeps
constexpr int kBwdWStride = kBwdCols + 4; // floats per k row of the W slice:
                                          // a quarter warp's 16-byte reads
                                          // of 8 consecutive rows hit all
                                          // banks
constexpr int kRecvStride = kClusterRows + 2;  // floats per unit of a
                                          // partial buffer: float2 reads and
                                          // writes of 16 consecutive units
                                          // hit all banks

// A load that stays where it is written, before the product whose time
// hides its latency (a plain load may be moved down to its first use).
__device__ __forceinline__ float ldg_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ldg_early(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// What one (row, unit) pair of a step reads: K3's residuals and the
// gradient of the layer output. c_prev is 0 at the direction's first
// forward step; all are 0 past the batch.
struct BwdResiduals {
  float gi, gf, gg, go, c, c_prev, g_out;
};

template <typename T>
__device__ __forceinline__ BwdResiduals load_residuals(
    const T* __restrict__ gout, const float* __restrict__ gates,
    const float* __restrict__ cs, int B, int steps, int H, int dir, int b,
    int s, int unit) {
  BwdResiduals r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (b >= B) return r;
  // step s walks the direction's forward order in reverse; its previous
  // forward step is one index earlier in that order
  const int t = dir ? s : steps - 1 - s;
  const size_t row = ((size_t)dir * B + b) * steps + t;
  const float* __restrict__ gr = gates + row * 4 * H + unit;
  r.gi = ldg_early(gr);
  r.gf = ldg_early(gr + H);
  r.gg = ldg_early(gr + 2 * H);
  r.go = ldg_early(gr + 3 * H);
  r.c = ldg_early(cs + row * H + unit);
  if (s < steps - 1)
    r.c_prev = ldg_early(cs + (dir ? row + 1 : row - 1) * H + unit);
  r.g_out = ldg_early(gout + ((size_t)b * steps + t) * 2 * H + dir * H + unit);
  return r;
}

// grid (kH/32 * clusters, 2 directions) in clusters of kH/32 blocks along
// x, block 256 threads, dynamic shared memory bwd_cluster_smem(kH); cluster
// i takes the 16-row batch tiles i, i + clusters, ... of the n_tiles.
// gout:  [B, T, 2H] in T (gradient of the layer output)
// gates: [2, B, T, 4H] f32, cs: [2, B, T, H] f32 (K3's residuals)
// w_*:   [H, 4H] in T, the cluster_fma pack's W_hh^T (column 4u+q)
// dxp:   [2, B, T, 4H] f32, original gate order
template <typename T, int kH>
__global__ void __launch_bounds__(kBwdThreads, 1)
bilstm_bwd_cluster_kernel(const T* __restrict__ gout,
                          const float* __restrict__ gates,
                          const float* __restrict__ cs,
                          const T* __restrict__ w_f, const T* __restrict__ w_b,
                          float* __restrict__ dxp, int B, int steps,
                          int n_tiles) {
  constexpr int kCluster = kH / kFmaUnits;
  constexpr int G = 4 * kH;
  constexpr int kRows = kClusterRows * kH / kBwdThreads;  // product rows
                                                         // a thread
  extern __shared__ __align__(16) float bwd_smem[];
  float* __restrict__ w_s = bwd_smem;                      // [kH][kBwdWStride]
  float* __restrict__ dg_s = w_s + kH * kBwdWStride;       // [16][kBwdCols]
  // [2][kCluster][32][kRecvStride]: the partials peers send this block
  float* recv = dg_s + kClusterRows * kBwdCols;
  const int rank = static_cast<int>(cluster_rank());
  const int dir = blockIdx.y;
  const T* __restrict__ w = dir ? w_b : w_f;
  const int tid = threadIdx.x;
  // in the product: output column k (unit k of the layer), rows
  // kRows*rg .. kRows*rg + kRows - 1 of the tile
  const int k = tid % kH, rg = tid / kH;
  // in the cell: unit `unit` (local ul) at rows row0 and row0 + 1
  const int ul = tid & 31;
  const int unit = rank * kFmaUnits + ul;
  const int row0 = 2 * (tid >> 5);

  // this block's W_hh rows, as the pack's columns 128*rank.., widened to
  // f32, for all steps of all its tiles
  for (int i = tid; i < kH * (kBwdCols / 4); i += kBwdThreads) {
    const int kk = i / (kBwdCols / 4), c4 = 4 * (i % (kBwdCols / 4));
    float wv[4];
    load4(w + (size_t)kk * G + rank * kBwdCols + c4, wv);
    *reinterpret_cast<float4*>(w_s + kk * kBwdWStride + c4) =
        make_float4(wv[0], wv[1], wv[2], wv[3]);
  }
  cluster_arrive();           // every peer is resident before the first
  cluster_wait();             // write into its shared memory

  const int n_clusters = gridDim.x / kCluster;
  int exchange = 0;           // the partial buffers alternate across tiles too
  for (int tile = blockIdx.x / kCluster; tile < n_tiles; tile += n_clusters) {
    const int b0 = tile * kClusterRows;
    float dh[2] = {0.0f, 0.0f}, dc[2] = {0.0f, 0.0f};
    BwdResiduals res[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      res[rr] = load_residuals(gout, gates, cs, B, steps, kH, dir,
                               b0 + row0 + rr, 0, unit);

    for (int s = 0; s < steps; ++s) {
      const int t = dir ? s : steps - 1 - s;
      float dg[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const BwdResiduals& r = res[rr];
        const float dh_tot = r.g_out + dh[rr];
        const float tc = tanhf(r.c);
        const float d_o = dh_tot * tc;
        const float dc_tot = dc[rr] + dh_tot * r.go * (1.0f - tc * tc);
        dg[rr][0] = dc_tot * r.gg * r.gi * (1.0f - r.gi);
        dg[rr][1] = dc_tot * r.c_prev * r.gf * (1.0f - r.gf);
        dg[rr][2] = dc_tot * r.gi * (1.0f - r.gg * r.gg);
        dg[rr][3] = d_o * r.go * (1.0f - r.go);
        dc[rr] = dc_tot * r.gf;
        const int b = b0 + row0 + rr;
        if (b < B) {
          float* __restrict__ dx =
              dxp + (((size_t)dir * B + b) * steps + t) * G + unit;
#pragma unroll
          for (int q = 0; q < 4; ++q) dx[q * kH] = dg[rr][q];
        }
      }
      if (s == steps - 1) break;      // the first forward step: no dh needed

#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float4*>(dg_s + (row0 + rr) * kBwdCols + 4 * ul) =
            make_float4(dg[rr][0], dg[rr][1], dg[rr][2], dg[rr][3]);
      // the next step's residuals, in flight over the product
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        res[rr] = load_residuals(gout, gates, cs, B, steps, kH, dir,
                                 b0 + row0 + rr, s + 1, unit);
      __syncthreads();

      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      const float* __restrict__ wk = w_s + k * kBwdWStride;
      const float* __restrict__ dgr = dg_s + rg * kRows * kBwdCols;
#pragma unroll 4
      for (int j = 0; j < kBwdCols; j += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wk + j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 d4 =
              *reinterpret_cast<const float4*>(dgr + r * kBwdCols + j);
          acc[r] = fmaf(d4.x, w4.x, acc[r]);
          acc[r] = fmaf(d4.y, w4.y, acc[r]);
          acc[r] = fmaf(d4.z, w4.z, acc[r]);
          acc[r] = fmaf(d4.w, w4.w, acc[r]);
        }
      }
      // column k's partial goes to the block that owns unit k, into the
      // slot of this block's rank
      float* buf = recv + (exchange & 1) * kCluster * kFmaUnits * kRecvStride;
      const uint32_t slot = peer_shared(
          buf + (rank * kFmaUnits + k % kFmaUnits) * kRecvStride + rg * kRows,
          k / kFmaUnits);
#pragma unroll
      for (int r = 0; r < kRows; r += 2)
        store_peer(slot + 4 * r, make_float2(acc[r], acc[r + 1]));
      cluster_arrive();
      cluster_wait();
      // dh of this thread's two (row, unit) pairs: the partials in rank order
      const float* mine = buf + ul * kRecvStride + row0;
      dh[0] = dh[1] = 0.0f;
#pragma unroll
      for (int src = 0; src < kCluster; ++src) {
        const float2 v = *reinterpret_cast<const float2*>(
            mine + src * kFmaUnits * kRecvStride);
        dh[0] += v.x;
        dh[1] += v.y;
      }
      ++exchange;
    }
  }
}

inline size_t bwd_cluster_smem(int H) {
  const int cluster = H / kFmaUnits;
  return ((size_t)H * kBwdWStride + kClusterRows * kBwdCols
          + 2 * (size_t)cluster * kFmaUnits * kRecvStride) * sizeof(float);
}

// ------------------------------------------------------------------ dW_hh
constexpr int kDwRows = 128;      // gate rows of dW_hh per block tile
constexpr int kDwSlab = 16;       // (b, t) rows per shared-memory slab
constexpr int kDwBlocks = 256;    // blocks a launch aims at: two per SM

// four consecutive values in shared memory, widened to f32
__device__ __forceinline__ float4 smem4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 smem4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

inline int dwhh_units(int H) { return H == 64 ? 64 : 128; }

// How dW_hh's N = B*T rows are split: `rows` per chunk (a multiple of the
// slab), `chunks` of them. A function of the shape alone.
struct DwSplit {
  int rows, chunks;
};

inline DwSplit dwhh_split(int B, int steps, int H) {
  const int tiles = (4 * H / kDwRows) * (H / dwhh_units(H)) * 2;
  const long long want = kDwBlocks / tiles > 1 ? kDwBlocks / tiles : 1;
  const long long n = (long long)B * steps;
  long long rows = (n + want - 1) / want;
  rows = (rows + kDwSlab - 1) / kDwSlab * kDwSlab;
  return {static_cast<int>(rows), static_cast<int>((n + rows - 1) / rows)};
}

// f32 scratch the split needs for its partial tiles (none for one chunk)
inline size_t dwhh_scratch_floats(int B, int steps, int H) {
  const DwSplit split = dwhh_split(B, steps, H);
  return split.chunks > 1 ? (size_t)split.chunks * 2 * 4 * H * H : 0;
}

// grid (4H/128 * H/kUnits tiles, chunks, 2 directions), block
// 16 * kUnits/8 threads; thread (ty, tx) owns gate rows 4ty.. and 64+4ty..
// and units 4tx.. and kUnits/2+4tx.. of its tile.
// dxp:     [2, B, T, 4H] f32; out: [B, T, 2H] in T
// partial: [chunks, 2, 4H, H] f32 (dW_hh itself when there is one chunk)
template <typename T, int kUnits>
__global__ void __launch_bounds__(kDwRows / 8 * kUnits / 8)
bilstm_dwhh_split_kernel(const float* __restrict__ dxp,
                         const T* __restrict__ out, float* __restrict__ partial,
                         int B, int steps, int H, int chunk_rows) {
  constexpr int kThreads = kDwRows / 8 * kUnits / 8;
  constexpr int kTx = kUnits / 8;
  constexpr int kVec = 16 / sizeof(T);          // values per 16-byte copy
  __shared__ __align__(16) float a_s[2][kDwSlab][kDwRows];
  __shared__ __align__(16) T h_s[2][kDwSlab][kUnits];
  const int G = 4 * H;
  const int N = B * steps;
  const int dir = blockIdx.z;
  const int g_tiles = G / kDwRows;
  const int g0 = (blockIdx.x % g_tiles) * kDwRows;
  const int k0 = (blockIdx.x / g_tiles) * kUnits;
  const int n_begin = blockIdx.y * chunk_rows;
  const int n_end = min(N, n_begin + chunk_rows);
  const int tid = threadIdx.x;
  const int ty = tid / kTx, tx = tid % kTx;

  // slab `slab` of this block's chunk into buffer `buf`: dgates rows and
  // h_prev rows (the layer output one step earlier in the direction's own
  // order, zero at its first step); zeros past the chunk
  auto fetch = [&](int slab, int buf) {
    const int n0 = n_begin + slab * kDwSlab;
    for (int i = tid; i < kDwSlab * kDwRows / 4; i += kThreads) {
      const int r = i / (kDwRows / 4), c = 4 * (i % (kDwRows / 4));
      const int n = n0 + r;
      const bool ok = n < n_end;
      cp_async16(&a_s[buf][r][c],
                 ok ? dxp + ((size_t)dir * N + n) * G + g0 + c : dxp, ok);
    }
    for (int i = tid; i < kDwSlab * kUnits / kVec; i += kThreads) {
      const int r = i / (kUnits / kVec), c = kVec * (i % (kUnits / kVec));
      const int n = n0 + r;
      const T* src = out;
      bool ok = n < n_end;
      if (ok) {
        const int b = n / steps, t = n % steps;
        const int tp = dir ? t + 1 : t - 1;
        ok = tp >= 0 && tp < steps;
        if (ok) src = out + ((size_t)b * steps + tp) * 2 * H + dir * H + k0 + c;
      }
      cp_async16(&h_s[buf][r][c], src, ok);
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int n_slabs =
      n_end > n_begin ? (n_end - n_begin + kDwSlab - 1) / kDwSlab : 0;
  if (n_slabs > 0) fetch(0, 0);
  for (int s = 0; s < n_slabs; ++s) {
    if (s + 1 < n_slabs) {
      fetch(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = s & 1;
#pragma unroll
    for (int kk = 0; kk < kDwSlab; ++kk) {
      const float4 a_lo = smem4(&a_s[buf][kk][4 * ty]);
      const float4 a_hi = smem4(&a_s[buf][kk][kDwRows / 2 + 4 * ty]);
      const float4 h_lo = smem4(&h_s[buf][kk][4 * tx]);
      const float4 h_hi = smem4(&h_s[buf][kk][kUnits / 2 + 4 * tx]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float h[8] = {h_lo.x, h_lo.y, h_lo.z, h_lo.w,
                          h_hi.x, h_hi.y, h_hi.z, h_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], h[j], acc[i][j]);
      }
    }
    __syncthreads();          // before the buffer is refilled
  }

  float* __restrict__ dst = partial + ((size_t)blockIdx.y * 2 + dir) * G * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int g = g0 + (i < 4 ? 4 * ty + i : kDwRows / 2 + 4 * ty + i - 4);
    float* __restrict__ row = dst + (size_t)g * H + k0;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + kUnits / 2 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// dwhh[i] = partial[0][i] + partial[1][i] + ... in chunk order
__global__ void __launch_bounds__(256)
sum_chunks_kernel(const float4* __restrict__ partial, float4* __restrict__ dwhh,
                  int n4, int chunks) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    float4 s = partial[i];
    for (int c = 1; c < chunks; ++c) {
      const float4 v = partial[(size_t)c * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    dwhh[i] = s;
  }
}

template <typename T, int kH>
int launch_bwd_cluster_h(const void* gout, const float* gates,
                         const float* cs, const void* w_f, const void* w_b,
                         float* dxp, int B, int steps, cudaStream_t stream) {
  const int n_tiles = (B + kClusterRows - 1) / kClusterRows;
  return launch_cluster(
      bilstm_bwd_cluster_kernel<T, kH>, kH / kFmaUnits, n_tiles, kBwdThreads,
      bwd_cluster_smem(kH), stream, static_cast<const T*>(gout), gates, cs,
      static_cast<const T*>(w_f), static_cast<const T*>(w_b), dxp, B, steps,
      n_tiles);
}

template <typename T, int kUnits>
int launch_dwhh_split(const float* dxp, const void* out, float* dwhh,
                      float* scratch, int B, int steps, int H,
                      cudaStream_t stream) {
  const DwSplit split = dwhh_split(B, steps, H);
  float* partial = split.chunks > 1 ? scratch : dwhh;
  const dim3 grid((4 * H / kDwRows) * (H / kUnits), split.chunks, 2);
  bilstm_dwhh_split_kernel<T, kUnits><<<grid, kDwRows / 8 * kUnits / 8, 0,
                                        stream>>>(
      dxp, static_cast<const T*>(out), partial, B, steps, H, split.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split.chunks == 1) return static_cast<int>(err);
  const int n4 = 2 * 4 * H * H / 4;
  const int blocks = (n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056;
  sum_chunks_kernel<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(dwhh),
      n4, split.chunks);
  return static_cast<int>(cudaGetLastError());
}

// The cluster recurrence, then dW_hh. w_*: the pack's W_hh^T in T.
template <typename T>
int launch_bwd_cluster(const void* gout, const float* gates, const float* cs,
                       const void* out, const void* w_f, const void* w_b,
                       float* dxp, float* dwhh, float* scratch, int B,
                       int steps, int H, cudaStream_t stream) {
  int err = 1000;
  if (H == 256)
    err = launch_bwd_cluster_h<T, 256>(gout, gates, cs, w_f, w_b, dxp, B,
                                       steps, stream);
  else if (H == 128)
    err = launch_bwd_cluster_h<T, 128>(gout, gates, cs, w_f, w_b, dxp, B,
                                       steps, stream);
  else if (H == 64)
    err = launch_bwd_cluster_h<T, 64>(gout, gates, cs, w_f, w_b, dxp, B,
                                      steps, stream);
  if (err != 0) return err;
  if (H == 64)
    return launch_dwhh_split<T, 64>(dxp, out, dwhh, scratch, B, steps, H,
                                    stream);
  return launch_dwhh_split<T, 128>(dxp, out, dwhh, scratch, B, steps, H,
                                   stream);
}

}  // namespace
