// The biLSTM recurrence with W_hh^T resident in the shared memory of a
// thread-block cluster, f32 FMA arithmetic: K3 (the trainer's residual-saving
// forward, pepper_tpu/ops/fused_lstm.py::_bilstm_train_fwd_kernel) and K1 in
// f32 (::_bilstm_step_kernel), for hidden sizes 64, 128 and 256.
//
// What bounds the recurrence on the H100: 33 serial steps, each a
// [rows, H] @ [H, 4H] product. W_hh^T in f32 (1 MiB per direction at H=256)
// fits no SM's 227 KB, and a block that streams it from L2 every step is
// bound by that stream's latency (~45 us a step), however few rows it owns.
//
// What this design does about it: a cluster of H/32 blocks (8 at H=256)
// owns one 16-row batch tile of one direction. Each block keeps the W_hh^T
// columns of its 32 hidden units (all four gates, 128 KiB at H=256) in
// shared memory for all T steps: read once per launch. Per step a block
// computes its 16 x 128 slice of the gate pre-activations from the whole
// h_{t-1} of the tile (its own shared memory), updates its slice of c (f32,
// registers) and h, writes the h slice into every block of the cluster
// (distributed shared memory), and the cluster meets at one barrier. h is
// double-buffered, so one barrier per step is enough. The trainer's batch of
// 64 runs 64 blocks where the generic kernel runs 8. As many clusters as the
// card holds at once are launched (16 at H=256), and each walks over its
// share of the batch tiles with W_hh^T in place.
//
// Inside a block, thread (unit, ks) of 32 x 8 owns the four gates of one
// unit for all 16 rows over the k with k % 8 == ks (64 accumulators, one
// 16-byte W and four 16-byte h loads per 64 FMAs). The eight partial sums of
// a unit sit in one warp and are reduce-scattered by shuffles in a fixed
// order, which leaves every thread two rows of its unit for the cell update.
// The arithmetic stays f32 FMA (the trainer's gradients are held to 5e-4),
// and two calls give identical bits.
//
// A step takes ~7 us for 16 rows, so a tile costs ~0.25 ms at T=33 whatever
// the batch and the kernel scales with ceil(tiles / 8) per direction: it
// beats the generic kernel (one ~1.45 ms wave up to 1056 rows) below ~700
// rows, which is where the caller's choice between the two switches. A
// 32-row tile (128 accumulators a thread) measured ~1.8 times a 16-row
// tile's time on the H100, so it buys nothing: the step is bound by its
// FMAs and shared-memory loads, not by the exchange.

#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "fused_lstm_common.cuh"

namespace {

constexpr int kClusterRows = 16;    // batch rows per cluster
constexpr int kFmaUnits = 32;       // hidden units per block
constexpr int kFmaThreads = 256;    // 32 units x 8 k-slices
constexpr int kFmaWStride = 4 * kFmaUnits + 16;   // floats per k row of W:
                                    // +64 B so that the two k rows a quarter
                                    // warp reads fall into different banks
constexpr int kNoCluster = 1001;    // returned where no cluster can be resident

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The cluster's barrier in its two halves. Every thread of every block
// arrives, then waits: writes to a peer's shared memory made before the
// arrive are visible to the peer after its wait. Work that touches no
// shared memory of the cluster may go between the two.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of `local` (in this block's shared memory) in block `rank`'s.
__device__ __forceinline__ uint32_t peer_shared(const void* local,
                                                uint32_t rank) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(peer) : "r"(addr), "r"(rank));
  return peer;
}

__device__ __forceinline__ void store_peer(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
               :: "r"(addr), "f"(v.x), "f"(v.y) : "memory");
}

__device__ __forceinline__ void store_peer(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// One half of a reduce-scatter over the lanes that differ in bit `kMask`:
// of 2 * kRows rows of partial sums each lane keeps kRows (the upper ones
// where its bit is set) and adds its partner's partial sums of those rows.
template <int kRows, int kMask>
__device__ __forceinline__ void reduce_half(const float (&in)[2 * kRows][4],
                                            float (&out)[kRows][4],
                                            bool upper) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float keep = upper ? in[r + kRows][q] : in[r][q];
      const float send = upper ? in[r][q] : in[r + kRows][q];
      out[r][q] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
    }
  }
}

// grid (H/32 * clusters, 2 directions) in clusters of H/32 blocks along x,
// block 256 threads, dynamic shared memory cluster_fma_smem(H); cluster i
// takes the 16-row batch tiles i, i + clusters, ... of the n_tiles.
// xp_*, w_*, bias, out, gates, cs: as for bilstm_kernel (column 4j+q = gate
// q of unit j); H is 32 times the cluster size.
template <typename T, bool kResiduals>
__global__ void __launch_bounds__(kFmaThreads, 1)
bilstm_cluster_fma_kernel(const T* __restrict__ xp_f,
                          const T* __restrict__ xp_b,
                          const T* __restrict__ w_f, const T* __restrict__ w_b,
                          const T* __restrict__ bias, T* __restrict__ out,
                          float* __restrict__ gates, float* __restrict__ cs,
                          int B, int steps, int H, int n_tiles) {
  extern __shared__ __align__(16) float cluster_smem[];
  float* __restrict__ w_s = cluster_smem;                  // [H][kFmaWStride]
  float* h_s = cluster_smem + (size_t)H * kFmaWStride;     // [2][H][16 rows]
  const int cluster_size = H / kFmaUnits;
  const int rank = static_cast<int>(cluster_rank());
  const int dir = blockIdx.y;
  const T* __restrict__ xp = dir ? xp_b : xp_f;
  const T* __restrict__ w = dir ? w_b : w_f;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ks = lane >> 2;                                // k slice, 0..7
  const int unit = rank * kFmaUnits + 4 * (tid >> 5) + (lane & 3);
  const int row0 = 2 * ks;            // this thread's rows in the cell update
  const int G = 4 * H;

  // this block's W_hh^T columns, widened to f32, for all steps of all its
  // tiles
  for (int i = tid; i < H * kFmaUnits; i += kFmaThreads) {
    const int k = i / kFmaUnits, u = i % kFmaUnits;
    float wv[4];
    load4(w + (size_t)k * G + 4 * (rank * kFmaUnits + u), wv);
    *reinterpret_cast<float4*>(w_s + k * kFmaWStride + 4 * u) =
        make_float4(wv[0], wv[1], wv[2], wv[3]);
  }
  float b_ih[4], b_hh[4];
  load4(bias + (size_t)(2 * dir) * G + 4 * unit, b_ih);
  load4(bias + (size_t)(2 * dir + 1) * G + 4 * unit, b_hh);
  cluster_arrive();           // every peer is resident before the first
  cluster_wait();             // write into its shared memory

  // the cluster walks over its share of the batch tiles with W_hh^T in place
  const int n_clusters = gridDim.x / cluster_size;
  for (int tile = blockIdx.x / cluster_size; tile < n_tiles;
       tile += n_clusters) {
    const int b0 = tile * kClusterRows;
    // h_0 = 0 in buffer 0 (no peer writes there before the first barrier),
    // c_0 = 0
    for (int i = tid; i < H * kClusterRows; i += kFmaThreads) h_s[i] = 0.0f;
    float c[2] = {0.0f, 0.0f};
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      const int t = dir ? steps - 1 - s : s;
      const float* h_prev = h_s + (s & 1) * H * kClusterRows;
      const float* h_next = h_s + ((s + 1) & 1) * H * kClusterRows;

      // this step's xp, in flight over the product
      float xv[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int b = b0 + row0 + rr;
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[rr][q] = 0.0f;
        if (b < B) load4(xp + ((size_t)b * steps + t) * G + 4 * unit, xv[rr]);
      }

      float acc[kClusterRows][4];
#pragma unroll
      for (int r = 0; r < kClusterRows; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      }
      const float* __restrict__ wk = w_s + 4 * (unit - rank * kFmaUnits);
#pragma unroll 4
      for (int k = ks; k < H; k += 8) {
        const float4 wv4 =
            *reinterpret_cast<const float4*>(wk + k * kFmaWStride);
        const float wv[4] = {wv4.x, wv4.y, wv4.z, wv4.w};
        const float4* hk =
            reinterpret_cast<const float4*>(h_prev + k * kClusterRows);
#pragma unroll
        for (int r4 = 0; r4 < kClusterRows / 4; ++r4) {
          const float4 hv = hk[r4];
          const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[4 * r4 + u][q] = fmaf(hr[u], wv[q], acc[4 * r4 + u][q]);
          }
        }
      }
      // the eight k slices of a unit are lanes that differ in bits 2..4;
      // afterwards this thread holds the full sums of rows 2*ks and 2*ks+1
      float acc8[8][4], acc4[4][4], pre[2][4];
      reduce_half<8, 16>(acc, acc8, lane & 16);
      reduce_half<4, 8>(acc8, acc4, lane & 8);
      reduce_half<2, 4>(acc4, pre, lane & 4);

      float h_new[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int b = b0 + row0 + rr;
        const float pi = add_biases<T>(xv[rr][0], b_ih[0], b_hh[0]) + pre[rr][0];
        const float pf = add_biases<T>(xv[rr][1], b_ih[1], b_hh[1]) + pre[rr][1];
        const float pg = add_biases<T>(xv[rr][2], b_ih[2], b_hh[2]) + pre[rr][2];
        const float po = add_biases<T>(xv[rr][3], b_ih[3], b_hh[3]) + pre[rr][3];
        // one form of the cell update for K1 and K3: unlike in the generic
        // kernel, naming the four gates first costs this kernel nothing
        // (measured on the H100)
        const float gi = sigmoid(pi), gf = sigmoid(pf), gg = tanhf(pg),
                    go = sigmoid(po);
        c[rr] = gf * c[rr] + gi * gg;
        const T h = from_float<T>(go * tanhf(c[rr]));
        h_new[rr] = to_float(h);       // rows past the batch stay finite
        if constexpr (kResiduals) {
          if (b < B) {
            const size_t row = ((size_t)dir * B + b) * steps + t;
            float* __restrict__ gr = gates + row * G;
            gr[unit] = gi;
            gr[H + unit] = gf;
            gr[2 * H + unit] = gg;
            gr[3 * H + unit] = go;
            cs[row * H + unit] = c[rr];
          }
        }
        if (b < B) out[((size_t)b * steps + t) * 2 * H + dir * H + unit] = h;
      }
      const float* mine = h_next + unit * kClusterRows + row0;
      for (int peer = 0; peer < cluster_size; ++peer)
        store_peer(peer_shared(mine, peer), make_float2(h_new[0], h_new[1]));
      // also the last step's: no block may exit, or start its next tile,
      // before its peers' last write
      cluster_arrive();
      cluster_wait();
    }
  }
}

inline size_t cluster_fma_smem(int H) {
  return ((size_t)H * kFmaWStride + 2 * (size_t)H * kClusterRows)
         * sizeof(float);
}

inline bool cluster_hidden_ok(int H) { return H == 64 || H == 128 || H == 256; }

// How many clusters of `cluster` blocks of `kernel` (with `smem` bytes of
// dynamic shared memory each) the current device holds at once, in
// *resident; 0 where it holds none. The first call for a (kernel, smem,
// device) raises the kernel's shared-memory limit (raise_smem_limit) and
// asks the occupancy calculator; later calls read the answer from a table,
// so a launch costs the host no more than the launch itself. Returns the
// CUDA error of the first call that failed.
inline cudaError_t resident_clusters(const void* kernel, int cluster,
                                     int threads, size_t smem,
                                     int* resident) {
  static std::mutex mutex;
  static std::map<std::tuple<const void*, size_t, int>, int> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(kernel, smem, device);
  std::lock_guard<std::mutex> guard(mutex);
  const auto found = known.find(key);
  if (found != known.end()) {
    *resident = found->second;
    return cudaSuccess;
  }
  err = raise_smem_limit(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, 2);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(resident, kernel, &config);
  if (err != cudaSuccess) return err;
  known[key] = *resident;
  return cudaSuccess;
}

// Launch `kernel` over `n_tiles` batch tiles and both directions, in
// clusters of `cluster` blocks along x with `smem` bytes of dynamic shared
// memory: per direction as many clusters as the card holds at once (half of
// resident_clusters), at most one per tile; each walks over its tiles.
// Returns the CUDA error of the first call that failed, kNoCluster where the
// card cannot hold one such cluster, 0 else.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int cluster, int n_tiles,
                   int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  int resident = 0;
  cudaError_t err = resident_clusters(reinterpret_cast<const void*>(kernel),
                                      cluster, threads, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return kNoCluster;
  const int per_direction = resident / 2 > 1 ? resident / 2 : 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(
      cluster * (n_tiles < per_direction ? n_tiles : per_direction), 2);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kResiduals>
int launch_cluster_fma(const void* xp_f, const void* xp_b, const void* w_f,
                       const void* w_b, const void* bias, void* out,
                       float* gates, float* cs, int B, int steps, int H,
                       cudaStream_t stream) {
  const int n_tiles = (B + kClusterRows - 1) / kClusterRows;
  return launch_cluster(
      bilstm_cluster_fma_kernel<T, kResiduals>, H / kFmaUnits, n_tiles,
      kFmaThreads, cluster_fma_smem(H), stream, static_cast<const T*>(xp_f),
      static_cast<const T*>(xp_b), static_cast<const T*>(w_f),
      static_cast<const T*>(w_b), static_cast<const T*>(bias),
      static_cast<T*>(out), gates, cs, B, steps, H, n_tiles);
}

}  // namespace
