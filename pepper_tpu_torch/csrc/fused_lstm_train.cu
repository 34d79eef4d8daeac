// Training kernels of the fused bidirectional LSTM for Hopper (sm_90a),
// bound to Python through a plain C interface (ctypes).
//
// K3 replaces pepper_tpu/ops/fused_lstm.py::_bilstm_train_fwd_kernel: the
// inference recurrence that also stores, per step and direction, the
// activated gates [i, f, g, o] and the updated cell state in f32 at the
// original time index. For hidden sizes 64, 128 and 256 it is the cluster
// kernel of fused_lstm_cluster.cuh (W_hh^T resident in a cluster's shared
// memory, f32 FMAs; the header says what bounds it and what the design does
// about it), shared with K1 in f32; for other hidden sizes up to 256 the
// generic kernel of fused_lstm_common.cuh.
//
// K4 replaces pepper_tpu/ops/fused_lstm.py::_bilstm_bwd_kernel. Each
// direction walks its steps in reverse with a (dh, dc) carry. Per step
//     dh_tot = gout[t] + dh;  tc = tanh(c_t)
//     do     = dh_tot * tc;   dc_tot = dc + dh_tot * o * (1 - tc^2)
//     dgates = [dc_tot*g*i*(1-i), dc_tot*c_prev*f*(1-f),
//               dc_tot*i*(1-g^2), do*o*(1-o)]          -> dxp[t]
//     dh     = dgates @ W_hh;  dc = dc_tot * f
// with c_prev = 0 at the direction's first forward step; then dW_hh[g, k] =
// sum over (b, t) of dgates[b, t, g] * h_prev[b, t, k], where h_prev is the
// layer output one step earlier in the direction's own order (zero at its
// first step). Two pairs of kernels compute it:
// - cluster (fused_lstm_bwd_cluster.cuh, hidden sizes 64, 128 and 256): the
//   recurrence with W_hh resident in a cluster's shared memory, read from
//   the forward's pack, and a split, register-blocked dW_hh; the header says
//   what bounds them and what the design does about it.
// - generic (below, any hidden size that is a multiple of 4 up to 256):
//   bilstm_bwd_kernel gives a block 16 rows and all 4H gate columns of one
//   direction; the tile's dgates go through shared memory (64 KiB at H=256)
//   laid out [4H][16], and thread j streams column j of W_hh ([4H, H] as
//   torch stores it) from L2 every step, so a step costs that stream's
//   latency whatever the batch. bilstm_dwhh_kernel then gives a block a
//   64x64 tile of dW_hh and all (b, t) in a fixed order, 4x4 accumulators a
//   thread. Neither uses atomics, so two calls give identical bits.
//
// What bounds K4 on the H100 (B=512, T=33, H=256, f32): its two products
// are 35.4 GFLOP (0.53 ms at the 67 TFLOP/s FP32 peak) against ~0.42 GB
// moved, so operations bound it. Both products run as f32 FMAs: TF32 would
// change the trainer's numerics, bf16 more so.

#include "fused_lstm_bwd_cluster.cuh"   // includes the cluster and
                                        // common headers

namespace {

// ---------------------------------------------------------- generic K4 (1)
// grid (ceil(B / kBT), 2 directions), block H threads, dynamic shared
// memory 4H * kBT floats.
// gout:  [B, T, 2H] in the layer's dtype (gradient of the layer output)
// gates: [2, B, T, 4H] f32, cs: [2, B, T, H] f32 (K3's residuals)
// whh_*: [4H, H] f32 (W_hh, torch layout)
// dxp:   [2, B, T, 4H] f32
template <typename T>
__global__ void __launch_bounds__(kMaxH, 1)
bilstm_bwd_kernel(const T* __restrict__ gout, const float* __restrict__ gates,
                  const float* __restrict__ cs,
                  const float* __restrict__ whh_f,
                  const float* __restrict__ whh_b, float* __restrict__ dxp,
                  int B, int steps, int H) {
  extern __shared__ __align__(16) float dg_smem[];   // [4H][kBT] dgates
  const int dir = blockIdx.y;
  const float* __restrict__ w = dir ? whh_b : whh_f;
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * kBT;
  const int G = 4 * H;

  float dh[kBT], dc[kBT];
#pragma unroll
  for (int r = 0; r < kBT; ++r) {
    dh[r] = 0.0f;
    dc[r] = 0.0f;
  }

  for (int s = 0; s < steps; ++s) {
    // reverse of the direction's forward order; t_prev is one forward step
    // earlier, and the last reverse step is the first forward step
    const int t = dir ? s : steps - 1 - s;
    const int t_prev = dir ? t + 1 : t - 1;
    const bool first = s == steps - 1;

#pragma unroll
    for (int r4 = 0; r4 < kBT / 4; ++r4) {
      float dg[4][4];                      // [gate][row of this group]
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 4 * r4 + u;
        const int b = b0 + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) dg[q][u] = 0.0f;
        if (b < B) {
          const size_t row = ((size_t)dir * B + b) * steps + t;
          const float* __restrict__ gr = gates + row * G;
          const float gi = gr[j];
          const float gf = gr[H + j];
          const float gg = gr[2 * H + j];
          const float go = gr[3 * H + j];
          const float c_prev =
              first ? 0.0f
                    : cs[(((size_t)dir * B + b) * steps + t_prev) * H + j];
          const float dh_tot =
              to_float(gout[((size_t)b * steps + t) * 2 * H + dir * H + j])
              + dh[r];
          const float tc = tanhf(cs[row * H + j]);
          const float d_o = dh_tot * tc;
          const float dc_tot = dc[r] + dh_tot * go * (1.0f - tc * tc);
          dg[0][u] = dc_tot * gg * gi * (1.0f - gi);
          dg[1][u] = dc_tot * c_prev * gf * (1.0f - gf);
          dg[2][u] = dc_tot * gi * (1.0f - gg * gg);
          dg[3][u] = d_o * go * (1.0f - go);
          dc[r] = dc_tot * gf;
          float* __restrict__ dx = dxp + row * G;
#pragma unroll
          for (int q = 0; q < 4; ++q) dx[q * H + j] = dg[q][u];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(dg_smem + (size_t)(q * H + j) * kBT + 4 * r4) =
            make_float4(dg[q][0], dg[q][1], dg[q][2], dg[q][3]);
    }
    __syncthreads();

    // dh[r] = sum over g of dgates[r, g] * W_hh[g, j]
#pragma unroll
    for (int r = 0; r < kBT; ++r) dh[r] = 0.0f;
#pragma unroll 4
    for (int g = 0; g < G; ++g) {
      const float wg = __ldg(w + (size_t)g * H + j);
      const float4* dgk = reinterpret_cast<const float4*>(dg_smem + g * kBT);
#pragma unroll
      for (int r4 = 0; r4 < kBT / 4; ++r4) {
        const float4 v = dgk[r4];
        dh[4 * r4 + 0] = fmaf(v.x, wg, dh[4 * r4 + 0]);
        dh[4 * r4 + 1] = fmaf(v.y, wg, dh[4 * r4 + 1]);
        dh[4 * r4 + 2] = fmaf(v.z, wg, dh[4 * r4 + 2]);
        dh[4 * r4 + 3] = fmaf(v.w, wg, dh[4 * r4 + 3]);
      }
    }
    __syncthreads();                       // before the next step's dgates
  }
}

// ---------------------------------------------------------- generic K4 (2)
constexpr int kTile = 64;                  // dW_hh tile: 64 gate rows x 64 units
constexpr int kTileN = 16;                 // (b, t) rows per shared-memory slab

// Row n = (b, t) of a slab: dgates[n, g..g+3] and h_prev[n, k..k+3], where
// h_prev is the layer output one step earlier in the direction's own order
// (zero at its first step); zeros beyond the arrays' edges.
template <typename T>
__device__ __forceinline__ void fetch_slab(const float* __restrict__ dxp,
                                           const T* __restrict__ out, int n,
                                           int B, int steps, int H, int dir,
                                           int g, int k, float (&dv)[4],
                                           float (&hv)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dv[c] = 0.0f;
    hv[c] = 0.0f;
  }
  const int N = B * steps;
  if (n >= N) return;
  const int b = n / steps, t = n % steps;
  if (g < 4 * H) load4(dxp + ((size_t)dir * N + n) * 4 * H + g, dv);
  const int t_prev = dir ? t + 1 : t - 1;
  if (t_prev >= 0 && t_prev < steps && k < H)
    load4(out + ((size_t)b * steps + t_prev) * 2 * H + dir * H + k, hv);
}

// grid (ceil(4H / 64), ceil(H / 64), 2 directions), block 256 threads; thread
// (ty, tx) of 16 x 16 owns a 4 x 4 patch of the tile. H % 4 == 0.
// dxp:  [2, B, T, 4H] f32; out: [B, T, 2H] in the layer's dtype
// dwhh: [2, 4H, H] f32 (torch layout of weight_hh_l0)
template <typename T>
__global__ void __launch_bounds__(256)
bilstm_dwhh_kernel(const float* __restrict__ dxp, const T* __restrict__ out,
                   float* __restrict__ dwhh, int B, int steps, int H) {
  __shared__ __align__(16) float dg_s[kTileN][kTile];
  __shared__ __align__(16) float hp_s[kTileN][kTile];
  const int dir = blockIdx.z;
  const int g0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const int G = 4 * H;
  const int N = B * steps;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lrow = tid / 16, lcol = 4 * (tid % 16);   // this thread's loads

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
  }

  float dv[4], hv[4];
  fetch_slab(dxp, out, lrow, B, steps, H, dir, g0 + lcol, k0 + lcol, dv, hv);
  for (int n0 = 0; n0 < N; n0 += kTileN) {
    *reinterpret_cast<float4*>(&dg_s[lrow][lcol]) =
        make_float4(dv[0], dv[1], dv[2], dv[3]);
    *reinterpret_cast<float4*>(&hp_s[lrow][lcol]) =
        make_float4(hv[0], hv[1], hv[2], hv[3]);
    __syncthreads();
    // the next slab's loads are in flight over this slab's FMAs
    fetch_slab(dxp, out, n0 + kTileN + lrow, B, steps, H, dir, g0 + lcol,
               k0 + lcol, dv, hv);
#pragma unroll
    for (int nn = 0; nn < kTileN; ++nn) {
      const float4 a4 = *reinterpret_cast<const float4*>(&dg_s[nn][4 * ty]);
      const float4 h4 = *reinterpret_cast<const float4*>(&hp_s[nn][4 * tx]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], h[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = g0 + 4 * ty + i;
    if (g >= G) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + 4 * tx + c;
      if (k < H) dwhh[((size_t)dir * G + g) * H + k] = acc[i][c];
    }
  }
}

template <typename T>
int launch_forward(int kernel, const void* xp_f, const void* xp_b,
                   const void* w_f, const void* w_b, const void* bias,
                   void* out, float* gates, float* cs, int B, int steps,
                   int H, cudaStream_t stream) {
  if (kernel == 1) {
    if (!cluster_hidden_ok(H)) return 1000;
    return launch_cluster_fma<T, true>(xp_f, xp_b, w_f, w_b, bias, out, gates,
                                       cs, B, steps, H, stream);
  }
  if (kernel != 0) return 1000;
  const dim3 grid((B + kBT - 1) / kBT, 2);
  const size_t smem = 2 * (size_t)H * kBT * sizeof(float);
  bilstm_kernel<T, true><<<grid, H, smem, stream>>>(
      static_cast<const T*>(xp_f), static_cast<const T*>(xp_b),
      static_cast<const T*>(w_f), static_cast<const T*>(w_b),
      static_cast<const T*>(bias), static_cast<T*>(out), gates, cs, B, steps,
      H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(int kernel, const void* gout, const float* gates,
                    const float* cs, const void* out, const void* w_f,
                    const void* w_b, float* dxp, float* dwhh, float* scratch,
                    int B, int steps, int H, cudaStream_t stream) {
  if (kernel == 1) {
    if (!cluster_hidden_ok(H)) return 1000;
    return launch_bwd_cluster<T>(gout, gates, cs, out, w_f, w_b, dxp, dwhh,
                                 scratch, B, steps, H, stream);
  }
  if (kernel != 0) return 1000;
  const size_t smem = 4 * (size_t)H * kBT * sizeof(float);
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(bilstm_bwd_kernel<T>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kBT - 1) / kBT, 2);
  bilstm_bwd_kernel<T><<<grid, H, smem, stream>>>(
      static_cast<const T*>(gout), gates, cs, static_cast<const float*>(w_f),
      static_cast<const float*>(w_b), dxp, B, steps, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 wgrid((4 * H + kTile - 1) / kTile, (H + kTile - 1) / kTile, 2);
  bilstm_dwhh_kernel<T><<<wgrid, 256, 0, stream>>>(
      dxp, static_cast<const T*>(out), dwhh, B, steps, H);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int steps, int H) {
  return B <= 0 || steps <= 0 || H <= 0 || H > kMaxH || H % 4 != 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xp, w, out, gout, the cluster K4's
// w); gates, cs, the generic K4's w, dxp, dwhh and scratch are float32.
// Each returns cudaGetLastError() after its launches (0 on success); 1000
// for arguments the kernels do not take, 1001 where the card cannot hold one
// cluster of a cluster kernel.

// K3. kernel: 0 generic, 1 cluster FMA; xp_*, w_* and bias as for
// pepper_bilstm_forward with the same kernel.
int pepper_bilstm_train_forward(int kernel, const void* xp_f,
                                const void* xp_b, const void* w_f,
                                const void* w_b, const void* bias, void* out,
                                void* gates, void* cs, int B, int steps,
                                int H, int dtype, void* stream) {
  if (bad_shape(B, steps, H)) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ga = static_cast<float*>(gates);
  float* c = static_cast<float*>(cs);
  if (dtype == 0)
    return launch_forward<float>(kernel, xp_f, xp_b, w_f, w_b, bias, out, ga,
                                 c, B, steps, H, s);
  if (dtype == 1)
    return launch_forward<__nv_bfloat16>(kernel, xp_f, xp_b, w_f, w_b, bias,
                                         out, ga, c, B, steps, H, s);
  return 1000;
}

// K4: the reverse-time recurrence, then dW_hh. kernel: 0 generic (w_* are
// W_hh [4H, H] in f32, torch layout), 1 cluster (w_* are the cluster_fma
// pack's W_hh^T [H, 4H] in dtype); scratch: as many floats as
// pepper_bilstm_train_backward_scratch gives (may be null where that is 0).
int pepper_bilstm_train_backward(int kernel, const void* gout,
                                 const void* gates, const void* cs,
                                 const void* out, const void* w_f,
                                 const void* w_b, void* dxp, void* dwhh,
                                 void* scratch, int B, int steps, int H,
                                 int dtype, void* stream) {
  if (bad_shape(B, steps, H)) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gates);
  const float* c = static_cast<const float*>(cs);
  float* dx = static_cast<float*>(dxp);
  float* dw = static_cast<float*>(dwhh);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch_backward<float>(kernel, gout, ga, c, out, w_f, w_b, dx, dw,
                                  sc, B, steps, H, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(kernel, gout, ga, c, out, w_f, w_b,
                                          dx, dw, sc, B, steps, H, s);
  return 1000;
}

// f32 scratch floats K4's kernel `kernel` needs at this shape (0: none).
long long pepper_bilstm_train_backward_scratch(int kernel, int B, int steps,
                                               int H) {
  if (kernel != 1 || bad_shape(B, steps, H)) return 0;
  return static_cast<long long>(dwhh_scratch_floats(B, steps, H));
}

}  // extern "C"
