// Helpers shared by the port's kernel libraries: the tensor-core fragment
// loads and product (mma.sync m16n8k16, bf16 in, f32 accumulate), cp.async
// copies, and the host-side shared-memory opt-in that every launcher above
// 48 KB needs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a @ b: a 16 x 16 (row major), b 16 x 8 (column major), bf16; d f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The gate activations of the tensor-core kernels: tanh.approx (one
// special-function operation, 2^-11 relative error, below bf16's
// resolution) and sigmoid(x) = 0.5 tanh(x/2) + 0.5. Built with
// -DPEPPER_EXACT_ACTIVATIONS they are tanhf and 1 / (1 + expf(-x)) as in the
// other kernels: the smoke run times that build beside this one to tell
// what the approximation buys.
__device__ __forceinline__ float tanh_fast(float x) {
#ifdef PEPPER_EXACT_ACTIVATIONS
  return tanhf(x);
#else
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#endif
}

__device__ __forceinline__ float sigmoid_fast(float x) {
#ifdef PEPPER_EXACT_ACTIVATIONS
  return sigmoid(x);
#else
  return fmaf(0.5f, tanh_fast(0.5f * x), 0.5f);
#endif
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// `valid` is false (gmem is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid = true) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most kPending committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// Let `kernel` launch with `smem` bytes of dynamic shared memory on the
// current device. The runtime is asked only when `smem` exceeds what was
// granted before for that (kernel, device): the limit belongs to the kernel,
// whatever shape asked for it, so it is only ever raised, and a launch that
// needs no more costs the host one table look-up.
inline cudaError_t raise_smem_limit(const void* kernel, size_t smem) {
  static std::mutex mutex;
  static std::map<std::pair<const void*, int>, size_t> granted;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(mutex);
  size_t& allowed = granted[std::make_pair(kernel, device)];
  if (smem <= allowed) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

}  // namespace
