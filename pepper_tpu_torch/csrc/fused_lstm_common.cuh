// Device code shared by the biLSTM kernels: fused_lstm.cu (K1, inference)
// and fused_lstm_train.cu (K3, the residual-saving forward, and K4, the
// backward). The recurrence itself is one template: K1 instantiates it
// without residuals, K3 with them, so the two forwards cannot drift apart.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBT = 16;          // batch rows per block
constexpr int kMaxH = 256;       // one thread per hidden unit

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

// four consecutive values (16-byte aligned f32, 8-byte aligned bf16),
// widened to f32
__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The biLSTM recurrence, zero initial state.
// grid (ceil(B / kBT), 2 directions), block H threads, dynamic shared
// memory 2 * H * kBT floats.
// xp_*:  [B, T, 4H] (gate order i, f, g, o; biases folded in)
// w_*:   [H, 4H] permuted W_hh^T: column 4j+q holds gate q of hidden unit j
// out:   [B, T, 2H]; direction d writes columns [d*H, (d+1)*H)
// With kResiduals (K3) each step also stores, at the original time index,
// gates: [2, B, T, 4H] f32, the activated gates i, f, g, o (gate-major)
// cs:    [2, B, T, H] f32, the updated cell state
template <typename T, bool kResiduals>
__global__ void __launch_bounds__(kMaxH, kResiduals ? 1 : 2)
bilstm_kernel(const T* __restrict__ xp_f, const T* __restrict__ xp_b,
              const T* __restrict__ w_f, const T* __restrict__ w_b,
              T* __restrict__ out, float* __restrict__ gates,
              float* __restrict__ cs, int B, int steps, int H) {
  extern __shared__ float h_smem[];        // [2][H][kBT], h_{t-1} as f32
  const int dir = blockIdx.y;
  const T* __restrict__ xp = dir ? xp_b : xp_f;
  const T* __restrict__ w = dir ? w_b : w_f;
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * kBT;
  const int G = 4 * H;

  for (int i = j; i < H * kBT; i += blockDim.x) h_smem[i] = 0.0f;
  float c[kBT];
#pragma unroll
  for (int r = 0; r < kBT; ++r) c[r] = 0.0f;
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int t = dir ? steps - 1 - s : s;
    const float* __restrict__ h_prev = h_smem + (s & 1) * H * kBT;
    float* __restrict__ h_next = h_smem + ((s + 1) & 1) * H * kBT;

    float acc[kBT][4];
#pragma unroll
    for (int r = 0; r < kBT; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    }

#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      float wk[4];
      load4(w + (size_t)k * G + 4 * j, wk);
      const float4* hk = reinterpret_cast<const float4*>(h_prev + k * kBT);
#pragma unroll
      for (int r4 = 0; r4 < kBT / 4; ++r4) {
        const float4 hv = hk[r4];
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[4 * r4 + u][q] = fmaf(hr[u], wk[q], acc[4 * r4 + u][q]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kBT; ++r) {
      const int b = b0 + r;
      float h_new = 0.0f;
      if (b < B) {
        const T* __restrict__ xr = xp + ((size_t)b * steps + t) * G;
        const float pi = to_float(xr[j]) + acc[r][0];
        const float pf = to_float(xr[H + j]) + acc[r][1];
        const float pg = to_float(xr[2 * H + j]) + acc[r][2];
        const float po = to_float(xr[3 * H + j]) + acc[r][3];
        T h;
        // K1 keeps the activations inside the cell update: written out as
        // four named gates first (as K3 must, to store them) it ran 11%
        // slower on the H100 (19.1 against 17.2 ms at B=16384, bf16).
        if constexpr (kResiduals) {
          const float gi = sigmoid(pi), gf = sigmoid(pf), gg = tanhf(pg),
                      go = sigmoid(po);
          c[r] = gf * c[r] + gi * gg;
          const size_t row = ((size_t)dir * B + b) * steps + t;
          float* __restrict__ gr = gates + row * G;
          gr[j] = gi;
          gr[H + j] = gf;
          gr[2 * H + j] = gg;
          gr[3 * H + j] = go;
          cs[row * H + j] = c[r];
          h = from_float<T>(go * tanhf(c[r]));
        } else {
          c[r] = sigmoid(pf) * c[r] + sigmoid(pi) * tanhf(pg);
          h = from_float<T>(sigmoid(po) * tanhf(c[r]));
        }
        out[((size_t)b * steps + t) * 2 * H + dir * H + j] = h;
        h_new = to_float(h);
      }
      h_next[j * kBT + r] = h_new;
    }
    __syncthreads();
  }
}

}  // namespace
