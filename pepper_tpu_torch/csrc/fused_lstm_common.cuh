// Device code shared by the biLSTM kernels: fused_lstm.cu (K1, inference)
// and fused_lstm_train.cu (K3, the residual-saving forward, and K4, the
// backward): scalar helpers, the bias add with the plain version's rounding,
// and the generic recurrence, the kernel for the shapes the cluster kernels
// (fused_lstm_cluster.cuh, fused_lstm_mma.cuh) do not take. Each recurrence
// is one template: K1 instantiates it without residuals, K3 with them, so
// the two forwards cannot drift apart.
//
// The generic recurrence replaces pepper_tpu/ops/fused_lstm.py::
// _bilstm_step_kernel and ::_bilstm_train_fwd_kernel for any hidden size up
// to 256. One block owns 16 batch rows and all 4H gate columns of one
// direction; W_hh^T does not fit its shared memory, so every step streams
// it from L2, and the product runs as f32 FMAs. It is bound by the latency
// of that stream (a step takes the same time for 8 blocks as for 64).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_util.cuh"

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

// xp + b_ih + b_hh with the plain version's rounding: each sum is rounded
// to T before the next (in bf16 round(round(xp + b_ih) + b_hh), computed in
// f32 as torch computes a bf16 add), then widened to f32.
template <typename T>
__device__ __forceinline__ float add_biases(float xp, float b_ih, float b_hh) {
  const float first = to_float(from_float<T>(xp + b_ih));
  return to_float(from_float<T>(first + b_hh));
}

// The biLSTM recurrence, zero initial state.
// grid (ceil(B / kBT), 2 directions), block H threads, dynamic shared
// memory 2 * H * kBT floats.
// xp_*:  [B, T, 4H] raw input projections, column 4j+q = gate q (i, f, g,
//        o) of hidden unit j
// w_*:   [H, 4H] W_hh^T in the same column order
// bias:  [2 directions][b_ih, b_hh][4H] in the same column order
// out:   [B, T, 2H]; direction d writes columns [d*H, (d+1)*H)
// With kResiduals (K3) each step also stores, at the original time index,
// gates: [2, B, T, 4H] f32, the activated gates i, f, g, o (gate-major)
// cs:    [2, B, T, H] f32, the updated cell state
template <typename T, bool kResiduals>
__global__ void __launch_bounds__(kMaxH, kResiduals ? 1 : 2)
bilstm_kernel(const T* __restrict__ xp_f, const T* __restrict__ xp_b,
              const T* __restrict__ w_f, const T* __restrict__ w_b,
              const T* __restrict__ bias, T* __restrict__ out,
              float* __restrict__ gates,
              float* __restrict__ cs, int B, int steps, int H) {
  extern __shared__ float h_smem[];        // [2][H][kBT], h_{t-1} as f32
  const int dir = blockIdx.y;
  const T* __restrict__ xp = dir ? xp_b : xp_f;
  const T* __restrict__ w = dir ? w_b : w_f;
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * kBT;
  const int G = 4 * H;

  for (int i = j; i < H * kBT; i += blockDim.x) h_smem[i] = 0.0f;
  float b_ih[4], b_hh[4];
  load4(bias + (size_t)(2 * dir) * G + 4 * j, b_ih);
  load4(bias + (size_t)(2 * dir + 1) * G + 4 * j, b_hh);
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
        float xv[4];
        load4(xp + ((size_t)b * steps + t) * G + 4 * j, xv);
        const float pi = add_biases<T>(xv[0], b_ih[0], b_hh[0]) + acc[r][0];
        const float pf = add_biases<T>(xv[1], b_ih[1], b_hh[1]) + acc[r][1];
        const float pg = add_biases<T>(xv[2], b_ih[2], b_hh[2]) + acc[r][2];
        const float po = add_biases<T>(xv[3], b_ih[3], b_hh[3]) + acc[r][3];
        T h;
        // K1 keeps the activations inside the cell update: written out as
        // four named gates first (as K3 must, to store them) this kernel
        // ran 11% slower on the H100 (19.1 against 17.2 ms at B=16384, bf16).
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
