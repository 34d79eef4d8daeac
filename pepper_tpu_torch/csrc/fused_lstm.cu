// Fused bidirectional LSTM recurrence (inference, zero initial state) for
// Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces pepper_tpu/ops/fused_lstm.py::_bilstm_step_kernel. Per direction
// and time step it computes
//     gates = float(xp[t]) + h_{t-1} @ W_hh^T          (f32 accumulation)
//     i, f, o = sigmoid(gates[i|f|o]); g = tanh(gates[g])
//     c = f * c + i * g                                 (c kept in f32)
//     h = dtype(o * tanh(c))                            (rounded, then fed back)
// with the reverse direction walking time index T-1-s. The input projection
// (both biases folded in) is a batched matmul done by the caller.
//
// What bounds it on the H100: the recurrent product is 2*T*B*H*4H operations
// per direction (0.567 TFLOP per launch at B=16384, T=33, H=256), and the
// unavoidable HBM traffic is xp in and h out (2.77 GB in bf16), so the
// roofline is ~0.83 ms, memory-bound but close to the tensor-core line.
// The step is serial in T, so a block must see the whole h_{t-1} row of its
// batch tile: one block owns BT batch rows and all 4H gate columns of one
// direction and loops over T inside the block. W_hh^T (512 KiB in bf16) does
// not fit in an SM's 227 KB of shared memory, so every step streams it from
// L2 (it stays L2-resident: 1 MiB for both directions); L2 traffic per launch
// is ~(B/BT)*T*2*512 KiB, 35 GB at BT=16.
//
// What this design does about it (the simple first version): W_hh^T's
// columns are permuted once by the wrapper so thread j owns the four gates
// of hidden unit j; it reads those four weights as one vector load per k
// (coalesced across the warp), and h_{t-1} comes from shared memory as a
// broadcast. The cell update stays in the thread's registers (c, 4*BT
// accumulators). The product runs as f32 FMAs, so it is bound by the FP32
// pipe (~67 TFLOP/s), not by the tensor cores; wgmma/TMA with a
// cluster-resident W_hh is the redesign left for a later change. The
// ragged batch edge is masked here instead of padding the batch.

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

// the four consecutive weights of one hidden unit's gates, widened to f32
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

// grid (ceil(B / kBT), 2 directions), block H threads.
// xp_*: [B, T, 4H] (gate order i, f, g, o; biases folded in)
// w_*:  [H, 4H] permuted W_hh^T: column 4j+q holds gate q of hidden unit j
// out:  [B, T, 2H]; direction d writes columns [d*H, (d+1)*H)
template <typename T>
__global__ void __launch_bounds__(kMaxH, 2)
bilstm_kernel(const T* __restrict__ xp_f, const T* __restrict__ xp_b,
              const T* __restrict__ w_f, const T* __restrict__ w_b,
              T* __restrict__ out, int B, int steps, int H) {
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
        const float gi = to_float(xr[j]) + acc[r][0];
        const float gf = to_float(xr[H + j]) + acc[r][1];
        const float gg = to_float(xr[2 * H + j]) + acc[r][2];
        const float go = to_float(xr[3 * H + j]) + acc[r][3];
        c[r] = sigmoid(gf) * c[r] + sigmoid(gi) * tanhf(gg);
        const T h = from_float<T>(sigmoid(go) * tanhf(c[r]));
        out[((size_t)b * steps + t) * 2 * H + dir * H + j] = h;
        h_new = to_float(h);
      }
      h_next[j * kBT + r] = h_new;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* xp_f, const void* xp_b, const void* w_f,
           const void* w_b, void* out, int B, int steps, int H,
           cudaStream_t stream) {
  const dim3 grid((B + kBT - 1) / kBT, 2);
  const size_t smem = 2 * (size_t)H * kBT * sizeof(float);
  bilstm_kernel<T><<<grid, H, smem, stream>>>(
      static_cast<const T*>(xp_f), static_cast<const T*>(xp_b),
      static_cast<const T*>(w_f), static_cast<const T*>(w_b),
      static_cast<T*>(out), B, steps, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); 1000 for arguments the kernel does not take.
int pepper_bilstm_forward(const void* xp_f, const void* xp_b, const void* w_f,
                          const void* w_b, void* out, int B, int steps, int H,
                          int dtype, void* stream) {
  if (B <= 0 || steps <= 0 || H <= 0 || H > kMaxH) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xp_f, xp_b, w_f, w_b, out, B, steps, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp_f, xp_b, w_f, w_b, out, B, steps, H, s);
  return 1000;
}

int pepper_bilstm_max_hidden(void) { return kMaxH; }

}  // extern "C"
