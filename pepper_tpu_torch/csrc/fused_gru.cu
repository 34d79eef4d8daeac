// Fused bidirectional GRU recurrence with a carried hidden state (inference)
// for Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces pepper_tpu/ops/fused_gru.py::_bigru_step_kernel (called from
// fused_bigru). Per direction and time step it computes
//     hp = h_{t-1} @ W_hh^T + b_hh                      (f32 accumulation)
//     r = sigmoid(xp_r + hp_r); z = sigmoid(xp_z + hp_z)
//     n = tanh(xp_n + r * hp_n)                         (b_hn inside r*(...))
//     h = dtype((1 - z) * n + z * h_{t-1})              (rounded, then fed back)
// starting from h0 (the window carry, [B, 2, H]) and writing the final h
// ([B, 2, H]), with the reverse direction walking time index T-1-s (its
// final h is the one at time index 0). The input projection
// x @ W_ih^T + b_ih (WITHOUT b_hh) is a batched matmul done by the caller.
//
// What bounds it on the H100: at the polish shapes (B=128 sequences, T=100,
// H=128) one launch must move xp for both directions in (19.7 MB in bf16),
// W_hh^T (0.2 MB) and out (6.6 MB): ~7.9 us at 3.35 TB/s, while the recurrent
// product is 2*2*T*B*H*3H = 2.52 GFLOP, 2.5 us on the bf16 tensor cores. So
// the roofline is set by bytes, but neither bound is what limits a kernel:
// the 100 steps are serial, and each needs the whole h_{t-1} row of its
// batch tile, so the work per step is small and its latency is the cost.
//
// Two kernels, picked by the caller from shape and dtype:
//
// mma (bf16, H a multiple of 16 up to 128): the JAX kernel's own product,
// bf16 h times bf16 W_hh with f32 accumulation, on the tensor cores. One
// block owns a 16-row batch tile of one direction and loops over T inside
// the block (B=128 gives 8 x 2 = 16 blocks); H/16 warps each own 16 hidden
// units. W_hh for the direction ([3H, H] bf16, 96 KiB at H=128) comes into
// shared memory once by 16-byte cp.async, and each warp moves its 48 rows
// into registers as mma.sync m16n8k16 B fragments (96 registers a thread at
// H=128) for the whole launch: no step reads W again. The rows are packed so
// that a warp's six n8-blocks are (r, z, n) of its units 0-7 then of its
// units 8-15, so a thread's accumulator fragments hold r, z and n of the
// same (row, unit) pairs and the gate update stays in the thread. Per step a
// warp runs H/16 k16-steps of six independent mma.sync on the ldmatrix'd h
// tile (bf16 in shared memory, rows padded by 16 bytes so ldmatrix hits
// distinct banks, double-buffered, one __syncthreads a step); b_hh is added
// in f32 after the product, b_hn inside the reset product; the gates go
// through tanh.approx (kernel_util.cuh: with each exact sigmoid's division
// a branch, the compiler ran a thread's eight (row, unit) updates one after
// another); h is rounded to bf16, written back to the tile and fed back;
// the next step's xp values (4-byte unit pairs) are loaded a step ahead.
// After the barrier each thread copies one 16-byte piece of the new h tile
// to the output, which overlaps the next step's product. h0 and h_n are
// read and written in [B, 2, H] directly, and the ragged batch edge is
// masked.
//
// generic (the first version; f32, and bf16 at hidden sizes mma does not
// take, up to 128): one block owns 4 batch rows and all 3H gate columns of
// one direction (B=128 gives 64 blocks). W_hh^T for one direction, widened
// to f32 (192 KiB), fills dynamic shared memory once per block; the caller
// permutes its columns once so column 3j+q holds gate q (r, z, n) of hidden
// unit j: thread j reads its unit's three weights at stride 3 words across
// the warp (no bank conflicts), and the gate update stays in the thread.
// h_{t-1} is double-buffered in shared memory as f32 (one barrier per step)
// and read as a broadcast; the thread's own h and its 3*kBT accumulators
// live in registers; the product runs as f32 FMAs (no tensor cores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_util.cuh"

namespace {

constexpr int kBT = 4;           // batch rows per block (one float4 of h)
constexpr int kMaxH = 128;       // one thread per hidden unit; W_hh^T in smem

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// W_hh^T's share of shared memory, in floats, rounded up so that h_s after
// it stays 16-byte aligned for its float4 reads
__host__ __device__ __forceinline__ int w_floats(int H) {
  return (3 * H * H + 3) & ~3;
}

// grid (ceil(B / kBT), 2 directions), block H threads.
// xp_*:  [B, T, 3H] (gate order r, z, n; b_ih added, b_hh not)
// w_*:   [H, 3H] permuted W_hh^T: column 3j+q holds gate q of hidden unit j
// bhh:   [2 directions][3H] f32, gate order r, z, n
// h0:    [B, 2, H]; direction d reads h0[:, d]
// out:   [B, T, 2H]; direction d writes columns [d*H, (d+1)*H)
// h_n:   [B, 2, H]; direction d writes h_n[:, d]
template <typename T>
__global__ void __launch_bounds__(kMaxH)
bigru_kernel(const T* __restrict__ xp_f, const T* __restrict__ xp_b,
             const T* __restrict__ w_f, const T* __restrict__ w_b,
             const float* __restrict__ bhh_all, const T* __restrict__ h0,
             T* __restrict__ out, T* __restrict__ h_n, int B, int steps,
             int H) {
  extern __shared__ __align__(16) float smem[];
  const int G = 3 * H;
  float* __restrict__ w_s = smem;                 // [H][3H] as f32
  float* __restrict__ h_s = smem + w_floats(H);   // [2][H][kBT], h_{t-1}
  const int dir = blockIdx.y;
  const T* __restrict__ xp = dir ? xp_b : xp_f;
  const T* __restrict__ w = dir ? w_b : w_f;
  const float* __restrict__ bhh = bhh_all + dir * G;
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * kBT;

  for (int i = j; i < H * G; i += blockDim.x) w_s[i] = to_float(w[i]);
  const float b_r = bhh[j], b_z = bhh[H + j], b_n = bhh[2 * H + j];
  float h[kBT];
#pragma unroll
  for (int r = 0; r < kBT; ++r) {
    const int b = b0 + r;
    h[r] = b < B ? to_float(h0[((size_t)b * 2 + dir) * H + j]) : 0.0f;
    h_s[j * kBT + r] = h[r];
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int t = dir ? steps - 1 - s : s;
    const float* __restrict__ h_prev = h_s + (s & 1) * H * kBT;
    float* __restrict__ h_next = h_s + ((s + 1) & 1) * H * kBT;

    float x_r[kBT], x_z[kBT], x_n[kBT];
#pragma unroll
    for (int r = 0; r < kBT; ++r) {
      const int b = b0 + r;
      x_r[r] = x_z[r] = x_n[r] = 0.0f;
      if (b < B) {
        const T* __restrict__ xr = xp + ((size_t)b * steps + t) * G;
        x_r[r] = to_float(xr[j]);
        x_z[r] = to_float(xr[H + j]);
        x_n[r] = to_float(xr[2 * H + j]);
      }
    }

    float acc[kBT][3];
#pragma unroll
    for (int r = 0; r < kBT; ++r) {
      acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
    }
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float* __restrict__ wk = w_s + k * G + 3 * j;
      const float w_r = wk[0], w_z = wk[1], w_n = wk[2];
      const float4 hv = *reinterpret_cast<const float4*>(h_prev + k * kBT);
      const float hk[kBT] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int r = 0; r < kBT; ++r) {
        acc[r][0] = fmaf(hk[r], w_r, acc[r][0]);
        acc[r][1] = fmaf(hk[r], w_z, acc[r][1]);
        acc[r][2] = fmaf(hk[r], w_n, acc[r][2]);
      }
    }

#pragma unroll
    for (int r = 0; r < kBT; ++r) {
      const int b = b0 + r;
      float h_new = 0.0f;
      if (b < B) {
        const float rg = sigmoid(x_r[r] + (acc[r][0] + b_r));
        const float zg = sigmoid(x_z[r] + (acc[r][1] + b_z));
        const float ng = tanhf(x_n[r] + rg * (acc[r][2] + b_n));
        const T hv = from_float<T>((1.0f - zg) * ng + zg * h[r]);
        out[((size_t)b * steps + t) * 2 * H + dir * H + j] = hv;
        h_new = to_float(hv);
      }
      h[r] = h_new;
      h_next[j * kBT + r] = h_new;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kBT; ++r) {
    const int b = b0 + r;
    if (b < B) h_n[((size_t)b * 2 + dir) * H + j] = from_float<T>(h[r]);
  }
}

template <typename T>
int launch_generic(const void* xp_f, const void* xp_b, const void* w_f,
                   const void* w_b, const float* bhh, const void* h0,
                   void* out, void* h_n, int B, int steps, int H,
                   cudaStream_t stream) {
  if (H > kMaxH) return 1000;
  const size_t smem =
      ((size_t)w_floats(H) + 2 * (size_t)H * kBT) * sizeof(float);
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(bigru_kernel<T>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kBT - 1) / kBT, 2);
  bigru_kernel<T><<<grid, H, smem, stream>>>(
      static_cast<const T*>(xp_f), static_cast<const T*>(xp_b),
      static_cast<const T*>(w_f), static_cast<const T*>(w_b), bhh,
      static_cast<const T*>(h0), static_cast<T*>(out), static_cast<T*>(h_n),
      B, steps, H);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- mma
constexpr int kTileRows = 16;    // batch rows per mma block

// A 4-byte load that stays where it is written, a step before its use (a
// plain load may be moved down to its first use).
__device__ __forceinline__ uint32_t ldg_early_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// element e (0 low, 1 high) of a packed pair of bf16, widened
__device__ __forceinline__ float bf16_elem(uint32_t pair, int e) {
  return __uint_as_float(e ? (pair & 0xffff0000u) : (pair << 16));
}

// grid (ceil(B / 16), 2 directions), block 2H threads (H/16 warps), dynamic
// shared memory gru_mma_smem(kH).
// xp_*: [B, T, 3H] bf16 (gate order r, z, n; b_ih added, b_hh not)
// w_*:  [3H, H] bf16 rows of W_hh; row 48w + 8(3v + q) + c holds gate q of
//       hidden unit 16w + 8v + c (v = 0, 1; c = 0..7)
// bhh:  [2 directions][3H] f32, gate order r, z, n
// h0:   [B, 2, H] bf16; out: [B, T, 2H] bf16; h_n: [B, 2, H] bf16
template <int kH>
__global__ void __launch_bounds__(2 * kH, 1)
bigru_mma_kernel(const __nv_bfloat16* __restrict__ xp_f,
                 const __nv_bfloat16* __restrict__ xp_b,
                 const __nv_bfloat16* __restrict__ w_f,
                 const __nv_bfloat16* __restrict__ w_b,
                 const float* __restrict__ bhh_all,
                 const __nv_bfloat16* __restrict__ h0,
                 __nv_bfloat16* __restrict__ out,
                 __nv_bfloat16* __restrict__ h_n, int B, int steps) {
  using bf16 = __nv_bfloat16;
  constexpr int kThreads = 2 * kH;
  constexpr int kStride = kH + 8;       // bf16 per padded row
  constexpr int kK = kH / 16;           // k16-steps of the product
  constexpr int G = 3 * kH;
  extern __shared__ __align__(16) unsigned char gru_smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(gru_smem_raw);   // [3H][kStride]
  bf16* h_s = w_s + G * kStride;                       // [2][16][kStride]
  const int dir = blockIdx.y;
  const bf16* __restrict__ xp = dir ? xp_b : xp_f;
  const bf16* __restrict__ w = dir ? w_b : w_f;
  const float* __restrict__ bhh = bhh_all + dir * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b0 = blockIdx.x * kTileRows;
  // this thread's unit pairs: units unit[v], unit[v] + 1 for v = 0, 1, at
  // rows g and g + 8 of the tile (accumulator fragments 0-1 and 2-3)
  const int unit[2] = {16 * warp + 2 * tq, 16 * warp + 8 + 2 * tq};

  for (int i = tid; i < G * (kH / 8); i += kThreads) {
    const int n = i / (kH / 8), ch = 8 * (i % (kH / 8));
    cp_async16(w_s + n * kStride + ch, w + (size_t)n * kH + ch);
  }
  cp_async_commit();
  float h[2][2][2];                     // [v][row half][e]: h_{t-1}, f32
  float bh[2][3][2];                    // [v][gate][e]: b_hh
#pragma unroll
  for (int v = 0; v < 2; ++v) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = b0 + g + 8 * half;
      const uint32_t pair =
          b < B ? *reinterpret_cast<const uint32_t*>(
                      h0 + ((size_t)b * 2 + dir) * kH + unit[v])
                : 0u;
      h[v][half][0] = bf16_elem(pair, 0);
      h[v][half][1] = bf16_elem(pair, 1);
      *reinterpret_cast<uint32_t*>(h_s + (g + 8 * half) * kStride + unit[v]) =
          pair;
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float2 bv =
          *reinterpret_cast<const float2*>(bhh + q * kH + unit[v]);
      bh[v][q][0] = bv.x;
      bh[v][q][1] = bv.y;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 48 rows of W_hh as B fragments, for the whole launch:
  // ldmatrix pair p holds n-blocks 2p and 2p+1
  uint32_t wb[kK][6][2];
  const uint32_t w_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      w_s + (48 * warp + (lane & 7) + 8 * (lane >> 4)) * kStride
      + 8 * ((lane >> 3) & 1)));
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      uint32_t r[4];
      ldmatrix_x4(r, w_addr + (16 * p * kStride + 16 * kk) * 2);
      wb[kk][2 * p][0] = r[0];
      wb[kk][2 * p][1] = r[1];
      wb[kk][2 * p + 1][0] = r[2];
      wb[kk][2 * p + 1][1] = r[3];
    }
  }
  // A fragments: rows (lane & 15), k offset 8 * (lane >> 4)
  const uint32_t h_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      h_s + (lane & 15) * kStride + 8 * (lane >> 4)));

  // the xp pairs of step s: [v][row half][gate]
  auto fetch_xp = [&](int s, uint32_t (&x)[2][2][3]) {
    const int t = dir ? steps - 1 - s : s;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int b = b0 + g + 8 * half;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          x[v][half][q] =
              b < B ? ldg_early_u32(xp + ((size_t)b * steps + t) * G
                                    + q * kH + unit[v])
                    : 0u;
      }
    }
  };
  uint32_t xv[2][2][3];
  fetch_xp(0, xv);

  for (int s = 0; s < steps; ++s) {
    const int t = dir ? steps - 1 - s : s;
    const int cur = s & 1;
    uint32_t xn[2][2][3] = {};
    if (s + 1 < steps) fetch_xp(s + 1, xn);   // in flight over this step

    float acc[6][4];
#pragma unroll
    for (int nb = 0; nb < 6; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
    }
    const uint32_t a_addr = h_addr + cur * kTileRows * kStride * 2;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr + kk * 32);
#pragma unroll
      for (int nb = 0; nb < 6; ++nb)
        mma_bf16(acc[nb], a, wb[kk][nb][0], wb[kk][nb][1]);
    }

    bf16* h_next = h_s + (cur ^ 1) * kTileRows * kStride;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float h_new[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = 2 * half + e;           // accumulator fragment
          const float hr = acc[3 * v][f] + bh[v][0][e];
          const float hz = acc[3 * v + 1][f] + bh[v][1][e];
          const float hn = acc[3 * v + 2][f] + bh[v][2][e];
          const float rg = sigmoid_fast(bf16_elem(xv[v][half][0], e) + hr);
          const float zg = sigmoid_fast(bf16_elem(xv[v][half][1], e) + hz);
          const float ng = tanh_fast(bf16_elem(xv[v][half][2], e) + rg * hn);
          h_new[e] = (1.0f - zg) * ng + zg * h[v][half][e];
        }
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(h_new[0], h_new[1]);
        h[v][half][0] = __low2float(h2);
        h[v][half][1] = __high2float(h2);
        *reinterpret_cast<__nv_bfloat162*>(
            h_next + (g + 8 * half) * kStride + unit[v]) = h2;
      }
    }
    __syncthreads();
    // one 16-byte piece of the new h tile to the output, over the next
    // step's product (the tile is rewritten only after the next barrier)
    {
      const int row = tid / (kH / 8), ch = 8 * (tid % (kH / 8));
      const int b = b0 + row;
      if (b < B)
        *reinterpret_cast<uint4*>(out + ((size_t)b * steps + t) * 2 * kH
                                  + dir * kH + ch) =
            *reinterpret_cast<const uint4*>(h_next + row * kStride + ch);
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int q = 0; q < 3; ++q) xv[v][half][q] = xn[v][half][q];
      }
    }
  }

#pragma unroll
  for (int v = 0; v < 2; ++v) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = b0 + g + 8 * half;
      if (b < B)
        *reinterpret_cast<__nv_bfloat162*>(
            h_n + ((size_t)b * 2 + dir) * kH + unit[v]) =
            __floats2bfloat162_rn(h[v][half][0], h[v][half][1]);
    }
  }
}

inline size_t gru_mma_smem(int H) {
  return (size_t)(3 * H + 2 * kTileRows) * (H + 8) * sizeof(__nv_bfloat16);
}

template <int kH>
int launch_mma_h(const void* xp_f, const void* xp_b, const void* w_f,
                 const void* w_b, const float* bhh, const void* h0, void* out,
                 void* h_n, int B, int steps, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = gru_mma_smem(kH);
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(bigru_mma_kernel<kH>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kTileRows - 1) / kTileRows, 2);
  bigru_mma_kernel<kH><<<grid, 2 * kH, smem, stream>>>(
      static_cast<const bf16*>(xp_f), static_cast<const bf16*>(xp_b),
      static_cast<const bf16*>(w_f), static_cast<const bf16*>(w_b), bhh,
      static_cast<const bf16*>(h0), static_cast<bf16*>(out),
      static_cast<bf16*>(h_n), B, steps);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* xp_f, const void* xp_b, const void* w_f,
               const void* w_b, const float* bhh, const void* h0, void* out,
               void* h_n, int B, int steps, int H, cudaStream_t stream) {
  switch (H) {
#define PEPPER_GRU_MMA_CASE(N)                                              \
    case N:                                                                 \
      return launch_mma_h<N>(xp_f, xp_b, w_f, w_b, bhh, h0, out, h_n, B,   \
                             steps, stream);
    PEPPER_GRU_MMA_CASE(16) PEPPER_GRU_MMA_CASE(32) PEPPER_GRU_MMA_CASE(48)
    PEPPER_GRU_MMA_CASE(64) PEPPER_GRU_MMA_CASE(80) PEPPER_GRU_MMA_CASE(96)
    PEPPER_GRU_MMA_CASE(112) PEPPER_GRU_MMA_CASE(128)
#undef PEPPER_GRU_MMA_CASE
    default:
      return 1000;
  }
}

}  // namespace

extern "C" {

// kernel: 0 generic, 1 mma (bf16 only, H a multiple of 16 up to 128).
// dtype: 0 = float32, 1 = bfloat16 (xp, w, h0, out, h_n); bhh is float32.
// w_*: the kernel's packed W_hh (generic: [H, 3H] permuted W_hh^T; mma:
// [3H, H] rows). Returns cudaGetLastError() after the launch (0 on
// success); 1000 for arguments the kernel does not take.
int pepper_bigru_forward(int kernel, const void* xp_f, const void* xp_b,
                         const void* w_f, const void* w_b, const void* bhh,
                         const void* h0, void* out, void* h_n, int B,
                         int steps, int H, int dtype, void* stream) {
  if (B <= 0 || steps <= 0 || H <= 0) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bh = static_cast<const float*>(bhh);
  if (kernel == 1)
    return dtype == 1 ? launch_mma(xp_f, xp_b, w_f, w_b, bh, h0, out, h_n, B,
                                   steps, H, s)
                      : 1000;
  if (kernel != 0) return 1000;
  if (dtype == 0)
    return launch_generic<float>(xp_f, xp_b, w_f, w_b, bh, h0, out, h_n, B,
                                 steps, H, s);
  if (dtype == 1)
    return launch_generic<__nv_bfloat16>(xp_f, xp_b, w_f, w_b, bh, h0, out,
                                         h_n, B, steps, H, s);
  return 1000;
}

}  // extern "C"
