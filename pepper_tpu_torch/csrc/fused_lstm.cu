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

#include "fused_lstm_common.cuh"   // the recurrence template and its helpers

namespace {

template <typename T>
int launch(const void* xp_f, const void* xp_b, const void* w_f,
           const void* w_b, void* out, int B, int steps, int H,
           cudaStream_t stream) {
  const dim3 grid((B + kBT - 1) / kBT, 2);
  const size_t smem = 2 * (size_t)H * kBT * sizeof(float);
  bilstm_kernel<T, false><<<grid, H, smem, stream>>>(
      static_cast<const T*>(xp_f), static_cast<const T*>(xp_b),
      static_cast<const T*>(w_f), static_cast<const T*>(w_b),
      static_cast<T*>(out), nullptr, nullptr, B, steps, H);
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
