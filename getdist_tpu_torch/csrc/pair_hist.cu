// Weighted pair histograms for Hopper (sm_90a), at any bin count up to 1024.
//
// Replaces getdist_tpu/ops/pallas_kernels.py:pair_histograms_tiled (K1, the
// static all-pairs schedule) and pair_histograms (K4, dynamic pair lists
// such as parity mode's sheared lead/residual stacks), and computes what
// pair_histograms_grouped computes: for every pair k,
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
