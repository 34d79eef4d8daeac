// K1, the fused bidirectional LSTM recurrence (inference, zero initial
// state) for Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes).
//
// Replaces pepper_tpu/ops/fused_lstm.py::_bilstm_step_kernel. Per direction
// and time step it computes
//     gates = float(xp[t] + b_ih + b_hh) + h_{t-1} @ W_hh^T  (f32 accumulation)
//     i, f, o = sigmoid(gates[i|f|o]); g = tanh(gates[g])
//     c = f * c + i * g                                 (c kept in f32)
//     h = dtype(o * tanh(c))                            (rounded, then fed back)
// with the reverse direction walking time index T-1-s. The input projection
// xp = x @ W_ih^T is a batched matmul done by the caller; the two biases are
// added here, each sum rounded to the dtype as the plain version rounds it.
//
// What bounds it on the H100: the recurrent product is 2*T*B*H*4H operations
// per direction (0.567 TFLOP per launch at B=16384, T=33, H=256), and the
// unavoidable HBM traffic is xp in and h out (2.77 GB in bf16), so the
// roofline is ~0.83 ms, memory-bound but close to the tensor-core line. The
// step is serial in T and needs the whole h_{t-1} row of its batch tile.
//
// Three kernels, chosen by the caller from shape and dtype:
//   2  bf16, H in {64, 128, 256}: fused_lstm_mma.cuh. W_hh resident in a
//      cluster's shared memory, the step product on tensor cores.
//   1  f32, H in {64, 128, 256}, small batches: fused_lstm_cluster.cuh.
//      W_hh^T resident in a cluster's shared memory, f32 FMAs (the same
//      template as K3).
//   0  any H up to 256, and f32 at large batches (where its 2112 rows a
//      wave beat the cluster kernel's 128): the generic kernel of
//      fused_lstm_common.cuh, which streams W_hh^T from L2 every step.
// Each header says what its design does about the bound. The ragged batch
// edge is masked in the kernels instead of padding the batch.

#include "fused_lstm_mma.cuh"    // includes the cluster and common headers

namespace {

template <typename T>
int launch_generic(const void* xp_f, const void* xp_b, const void* w_f,
                   const void* w_b, const void* bias, void* out, int B,
                   int steps, int H, cudaStream_t stream) {
  const dim3 grid((B + kBT - 1) / kBT, 2);
  const size_t smem = 2 * (size_t)H * kBT * sizeof(float);
  bilstm_kernel<T, false><<<grid, H, smem, stream>>>(
      static_cast<const T*>(xp_f), static_cast<const T*>(xp_b),
      static_cast<const T*>(w_f), static_cast<const T*>(w_b),
      static_cast<const T*>(bias), static_cast<T*>(out), nullptr, nullptr, B,
      steps, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// kernel: 0 generic, 1 cluster FMA (f32 only), 2 cluster tensor-core (bf16
// only).
// dtype: 0 = float32, 1 = bfloat16. xp, w and bias in the layout the chosen
// kernel's header states. Returns the CUDA error of the launch (0 on
// success); 1000 for arguments the kernel does not take, 1001 where the card
// cannot hold one cluster of the kernel.
int pepper_bilstm_forward(int kernel, const void* xp_f, const void* xp_b,
                          const void* w_f, const void* w_b, const void* bias,
                          void* out, int B, int steps, int H, int dtype,
                          void* stream) {
  if (B <= 0 || steps <= 0 || H <= 0 || H > kMaxH) return 1000;
  if (dtype != 0 && dtype != 1) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) {
    if (dtype == 0)
      return launch_generic<float>(xp_f, xp_b, w_f, w_b, bias, out, B, steps,
                                   H, s);
    return launch_generic<__nv_bfloat16>(xp_f, xp_b, w_f, w_b, bias, out, B,
                                         steps, H, s);
  }
  if (!cluster_hidden_ok(H)) return 1000;
  // bf16 goes to the tensor-core kernel at every shape the FMA cluster
  // kernel takes, so that one is built for f32 only
  if (kernel == 1 && dtype == 0)
    return launch_cluster_fma<float, false>(xp_f, xp_b, w_f, w_b, bias, out,
                                            nullptr, nullptr, B, steps, H, s);
  if (kernel == 2 && dtype == 1)
    return launch_mma(xp_f, xp_b, w_f, w_b, bias, out, B, steps, H, s);
  return 1000;
}

}  // extern "C"
