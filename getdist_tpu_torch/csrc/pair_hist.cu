// Weighted pair histograms for Hopper (sm_90a), at any bin count up to 1024.
//
// pair_hist_kernel replaces getdist_tpu/ops/pallas_kernels.py:
// pair_histograms_tiled (K1, the static all-pairs schedule) and
// pair_histograms (K4, dynamic pair lists such as parity mode's sheared
// lead/residual stacks); pair_hist_grouped_kernel (below) replaces
// pair_histograms_grouped (K5, b-anchored groups).  Both compute, for every
// pair k,
// out[k, b, a] = sum of w[i] over samples i with ix[pb[k], i] == b and
// ix[pa[k], i] == a (rows = b, cols = a).  Samples whose a or b index lies
// outside [0, nbins) are dropped, as the TPU's one-hot contractions drop them.
//
// The TPU kernels built weighted one-hot stacks and contracted them on the
// MXU; on Hopper that is ~7.7 GB of one-hot traffic for 30 params x 1M
// samples at 256 bins, so this kernel bins directly instead.  What bounds
// it: shared-memory atomics (one per sample per pair and slab pass) and the
// index reads, which stay L2-resident (30 x 1M uint8 = 30 MB < 50 MB L2).
// A full histogram tile does not fit a block's shared memory (256 KB at
// 256 bins, 3.7 MB at 960), so each block owns a slab of R rows of one
// pair's histogram (R * nbins * 4 bytes <= 128 KB: R = 128 at 256 bins,
// 34 at 960) over one chunk of samples, skips samples whose b bin lies in
// another slab, and flushes its nonzero bins with global atomics.  Integer
// weights accumulate in int32 (bit-exact, order independent); float
// weights accumulate in f32 (atomic order varies from run to run).  Index
// rows may be uint8 (<= 256 bins), int16 or int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSlabBytes = 128 * 1024;

template <typename Acc>
__device__ __forceinline__ Acc weight_at(const float* w, long long i);

template <>
__device__ __forceinline__ int weight_at<int>(const float* w, long long i) {
  return __float2int_rn(w[i]);
}

template <>
__device__ __forceinline__ float weight_at<float>(const float* w, long long i) {
  return w[i];
}

// kFixedBins: the bin count when known at compile time (256, the main
// path's), else 0 and the runtime nbins is used.
template <typename Idx, typename Acc, int kFixedBins>
__global__ void __launch_bounds__(kThreads)
    pair_hist_kernel(const Idx* __restrict__ ix, const float* __restrict__ w, const int* __restrict__ pa,
                     const int* __restrict__ pb, long long n, long long chunk, int runtime_bins, int rows,
                     Acc* __restrict__ out) {
  const int nbins = kFixedBins ? kFixedBins : runtime_bins;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* tile = reinterpret_cast<Acc*>(smem_raw);
  const int k = blockIdx.z;
  const int row0 = blockIdx.y * rows;
  const int slab_rows = min(rows, nbins - row0);
  const int slab = slab_rows * nbins;
  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long stop = min(start + chunk, n);

  for (int j = threadIdx.x; j < slab; j += kThreads) tile[j] = Acc(0);
  __syncthreads();

  const Idx* col_a = ix + static_cast<long long>(pa[k]) * n;
  const Idx* col_b = ix + static_cast<long long>(pb[k]) * n;
  for (long long i = start + threadIdx.x; i < stop; i += kThreads) {
    const int b = static_cast<int>(col_b[i]) - row0;
    if (b < 0 || b >= slab_rows) continue;
    const int a = static_cast<int>(col_a[i]);
    if (a < 0 || a >= nbins) continue;
    atomicAdd(&tile[b * nbins + a], weight_at<Acc>(w, i));
  }
  __syncthreads();

  Acc* dst = out + static_cast<long long>(k) * nbins * nbins + static_cast<long long>(row0) * nbins;
  for (int j = threadIdx.x; j < slab; j += kThreads) {
    const Acc v = tile[j];
    if (v != Acc(0)) atomicAdd(&dst[j], v);
  }
}

template <typename Idx, typename Acc, int kFixedBins>
cudaError_t launch_kernel(const void* ix, const float* w, const int* pa, const int* pb, long long n, int n_pairs,
                          int nbins, int rows, int n_chunks, Acc* out, cudaStream_t stream) {
  auto* kernel = pair_hist_kernel<Idx, Acc, kFixedBins>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabBytes);
  if (err != cudaSuccess) return err;
  const long long chunk = (n + n_chunks - 1) / n_chunks;
  const dim3 grid(n_chunks, (nbins + rows - 1) / rows, n_pairs);
  const int bytes = rows * nbins * static_cast<int>(sizeof(Acc));
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const Idx*>(ix), w, pa, pb, n, chunk, nbins, rows, out);
  return cudaGetLastError();
}

template <typename Idx, typename Acc>
cudaError_t launch(const void* ix, const float* w, const int* pa, const int* pb, long long n, int n_pairs,
                   int nbins, int rows, int n_chunks, Acc* out, cudaStream_t stream) {
  if (rows < 1 || nbins < 1 || rows * nbins * static_cast<int>(sizeof(Acc)) > kSlabBytes) return cudaErrorInvalidValue;
  if (nbins == 256) return launch_kernel<Idx, Acc, 256>(ix, w, pa, pb, n, n_pairs, nbins, rows, n_chunks, out, stream);
  return launch_kernel<Idx, Acc, 0>(ix, w, pa, pb, n, n_pairs, nbins, rows, n_chunks, out, stream);
}

template <typename Acc>
cudaError_t launch_acc(int index_bytes, const void* ix, const float* w, const int* pa, const int* pb, long long n,
                       int n_pairs, int nbins, int rows, int n_chunks, Acc* out, cudaStream_t s) {
  switch (index_bytes) {
    case 1:
      return launch<uint8_t, Acc>(ix, w, pa, pb, n, n_pairs, nbins, rows, n_chunks, out, s);
    case 2:
      return launch<int16_t, Acc>(ix, w, pa, pb, n, n_pairs, nbins, rows, n_chunks, out, s);
    case 4:
      return launch<int32_t, Acc>(ix, w, pa, pb, n, n_pairs, nbins, rows, n_chunks, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// K5: b-anchored groups of kGroup = 8 pairs (a_0 .. a_7, b), uint8
// indices, 256 bins.  What the TPU kernel saved, and this one keeps: the b
// column is read and tested once per group instead of once per pair.  A
// block owns one group (blockIdx.z), one slab of R b-rows of all 8
// histograms (8 * R * 256 * 4 bytes <= 128 KB of shared memory: R = 16) and
// one chunk of samples (blockIdx.x).  It reads each sample's b index once;
// where b lies in the slab it reads the 8 a indices and adds 8
// shared-memory atomics, then flushes the nonzero bins with global atomics
// straight into the pair's place in the output.  Slots whose pair index is
// negative (the a = b padding of a group that its b does not fill) are
// neither binned nor flushed.  Bounded, like K1, by the shared-memory
// atomics and by the latency of the L2-resident index reads: each thread
// reads the b indices of 4 samples together, and the 8 a indices of a
// sample into registers before its atomics.  On an H100 at 30 x 1M, 435
// pairs (chip_smoke.py): 8.06 ms with one sample per step and the a indices
// read between the atomics, 4.89 ms with them in registers, 3.70 ms with 4
// samples per step; K1 took 2.76-2.96 ms on the same rows in the same runs
// (it makes 870 passes over a b column against K5's 1088: 68 groups x 16
// slabs of 16 rows).
constexpr int kGroupBins = 256;
constexpr int kGroup = 8;

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
    pair_hist_grouped_kernel(const uint8_t* __restrict__ ix, const float* __restrict__ w,
                             const int* __restrict__ grp_a, const int* __restrict__ grp_b,
                             const int* __restrict__ slot_pair, long long n, long long chunk, int rows,
                             Acc* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* tile = reinterpret_cast<Acc*>(smem_raw);  // (kGroup, rows, 256)
  __shared__ const uint8_t* col_a[kGroup];
  __shared__ int pair_of[kGroup];
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * rows;
  const int slab_rows = min(rows, kGroupBins - row0);
  const int slot_stride = rows * kGroupBins;
  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long stop = min(start + chunk, n);

  if (threadIdx.x < kGroup) {
    col_a[threadIdx.x] = ix + static_cast<long long>(grp_a[g * kGroup + threadIdx.x]) * n;
    pair_of[threadIdx.x] = slot_pair[g * kGroup + threadIdx.x];
  }
  for (int j = threadIdx.x; j < kGroup * slot_stride; j += kThreads) tile[j] = Acc(0);
  __syncthreads();

  // kUnroll samples per thread and step, their b indices read together: most
  // samples lie outside a slab of 16 rows and cost only that L2 read, so the
  // scan is bound by its latency
  constexpr int kUnroll = 4;
  const uint8_t* col_b = ix + static_cast<long long>(grp_b[g]) * n;
  for (long long base = start + threadIdx.x; base < stop; base += static_cast<long long>(kThreads) * kUnroll) {
    int b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * kThreads;
      b[u] = i < stop ? static_cast<int>(col_b[i]) - row0 : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (b[u] >= 0 && b[u] < slab_rows) {
        const long long i = base + static_cast<long long>(u) * kThreads;
        const Acc wi = weight_at<Acc>(w, i);
        Acc* row = tile + b[u] * kGroupBins;
        int a[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) a[j] = col_a[j][i];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (pair_of[j] >= 0) atomicAdd(&row[j * slot_stride + a[j]], wi);
      }
  }
  __syncthreads();

  const long long hist = static_cast<long long>(kGroupBins) * kGroupBins;
  for (int j = threadIdx.x; j < kGroup * slot_stride; j += kThreads) {
    const int slot = j / slot_stride;
    const int within = j - slot * slot_stride;
    if (pair_of[slot] < 0 || within >= slab_rows * kGroupBins) continue;
    const Acc v = tile[j];
    if (v != Acc(0)) atomicAdd(&out[pair_of[slot] * hist + static_cast<long long>(row0) * kGroupBins + within], v);
  }
}

template <typename Acc>
cudaError_t launch_grouped(const uint8_t* ix, const float* w, const int* grp_a, const int* grp_b,
                           const int* slot_pair, long long n, int n_groups, int rows, int n_chunks, Acc* out,
                           cudaStream_t stream) {
  const int bytes = kGroup * rows * kGroupBins * static_cast<int>(sizeof(Acc));
  if (rows < 1 || rows > kGroupBins || bytes > kSlabBytes || n_chunks < 1) return cudaErrorInvalidValue;
  auto* kernel = pair_hist_grouped_kernel<Acc>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabBytes);
  if (err != cudaSuccess) return err;
  const long long chunk = (n + n_chunks - 1) / n_chunks;
  const dim3 grid(n_chunks, (kGroupBins + rows - 1) / rows, n_groups);
  kernel<<<grid, kThreads, bytes, stream>>>(ix, w, grp_a, grp_b, slot_pair, n, chunk, rows, out);
  return cudaGetLastError();
}

}  // namespace

// ix (P, N) uint8 / int16 / int32 (index_bytes 1 / 2 / 4), w (N,) f32,
// pa/pb (K,) int32, out (K, nbins, nbins) zeroed: int32 when
// integer_weights (weights rounded to int), else f32.  rows: histogram rows
// per block slab (rows * nbins * 4 <= 128 KB).
extern "C" int pair_hist_launch(int device, const void* ix, int index_bytes, const void* w, const void* pa,
                                const void* pb, long long n, int n_pairs, int nbins, int rows, int n_chunks,
                                int integer_weights, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* wf = static_cast<const float*>(w);
  const auto* a = static_cast<const int*>(pa);
  const auto* b = static_cast<const int*>(pb);
  auto s = static_cast<cudaStream_t>(stream);
  if (integer_weights)
    err = launch_acc<int>(index_bytes, ix, wf, a, b, n, n_pairs, nbins, rows, n_chunks, static_cast<int*>(out), s);
  else
    err = launch_acc<float>(index_bytes, ix, wf, a, b, n, n_pairs, nbins, rows, n_chunks, static_cast<float*>(out), s);
  return static_cast<int>(err);
}

// K5.  ix (P, N) uint8, w (N,) f32, grp_a (n_groups, 8) and grp_b
// (n_groups,) int32 parameter indices, slot_pair (n_groups * 8,) int32: the
// output pair of each slot, -1 for padding.  out (K, 256, 256) zeroed: int32
// when integer_weights (weights rounded to int), else f32.  rows: b-rows per
// slab (8 * rows * 256 * 4 <= 128 KB).
extern "C" int pair_hist_grouped_launch(int device, const void* ix, const void* w, const void* grp_a,
                                        const void* grp_b, const void* slot_pair, long long n, int n_groups, int rows,
                                        int n_chunks, int integer_weights, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* idx = static_cast<const uint8_t*>(ix);
  const auto* wf = static_cast<const float*>(w);
  const auto* ga = static_cast<const int*>(grp_a);
  const auto* gb = static_cast<const int*>(grp_b);
  const auto* sp = static_cast<const int*>(slot_pair);
  auto s = static_cast<cudaStream_t>(stream);
  if (integer_weights)
    err = launch_grouped<int>(idx, wf, ga, gb, sp, n, n_groups, rows, n_chunks, static_cast<int*>(out), s);
  else
    err = launch_grouped<float>(idx, wf, ga, gb, sp, n, n_groups, rows, n_chunks, static_cast<float*>(out), s);
  return static_cast<int>(err);
}
