// Weighted all-pairs 256x256 histograms for Hopper (sm_90a).
//
// Replaces getdist_tpu/ops/pallas_kernels.py:pair_histograms_tiled (and
// computes what pair_histograms / pair_histograms_grouped compute): for
// every pair k, out[k, b, a] = sum of w[i] over samples i with
// ix[pb[k], i] == b and ix[pa[k], i] == a (rows = b, cols = a).
//
// The TPU kernel built weighted one-hot stacks and contracted them on the
// MXU; on Hopper that is ~7.7 GB of one-hot traffic for 30 params x 1M
// samples, so this kernel bins directly instead.  What bounds it: shared
// memory atomics (one per sample per pair) and the index reads, which are
// L2-resident (30 x 1M uint8 = 30 MB < 50 MB L2).  A full 256x256 int32
// tile is 256 KB, above the 227 KB a block may hold, so each block owns
// one 128-row half of one pair's histogram (128 KB of shared memory) over
// one chunk of samples, skips samples whose b bin lies in the other half,
// and flushes its nonzero bins with global atomics.  Integer weights
// accumulate in int32 (bit-exact, order independent); float weights
// accumulate in f32 (atomic order varies from run to run).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kHalfRows = kBins / 2;
constexpr int kThreads = 1024;
constexpr int kTileBytes = kHalfRows * kBins * 4;

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

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
    pair_hist_kernel(const uint8_t* __restrict__ ix, const float* __restrict__ w, const int* __restrict__ pa,
                     const int* __restrict__ pb, long long n, long long chunk, Acc* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* tile = reinterpret_cast<Acc*>(smem_raw);
  const int k = blockIdx.z;
  const int half = blockIdx.y;
  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long stop = min(start + chunk, n);

  for (int j = threadIdx.x; j < kHalfRows * kBins; j += kThreads) tile[j] = Acc(0);
  __syncthreads();

  const uint8_t* col_a = ix + static_cast<long long>(pa[k]) * n;
  const uint8_t* col_b = ix + static_cast<long long>(pb[k]) * n;
  for (long long i = start + threadIdx.x; i < stop; i += kThreads) {
    const int b = col_b[i];
    if ((b >> 7) == half) atomicAdd(&tile[(b & (kHalfRows - 1)) * kBins + col_a[i]], weight_at<Acc>(w, i));
  }
  __syncthreads();

  Acc* dst = out + static_cast<long long>(k) * kBins * kBins + half * kHalfRows * kBins;
  for (int j = threadIdx.x; j < kHalfRows * kBins; j += kThreads) {
    const Acc v = tile[j];
    if (v != Acc(0)) atomicAdd(&dst[j], v);
  }
}

template <typename Acc>
cudaError_t launch(const uint8_t* ix, const float* w, const int* pa, const int* pb, long long n, int n_pairs,
                   int n_chunks, Acc* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(pair_hist_kernel<Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kTileBytes);
  if (err != cudaSuccess) return err;
  const long long chunk = (n + n_chunks - 1) / n_chunks;
  const dim3 grid(n_chunks, 2, n_pairs);
  pair_hist_kernel<Acc><<<grid, kThreads, kTileBytes, stream>>>(ix, w, pa, pb, n, chunk, out);
  return cudaGetLastError();
}

}  // namespace

// ix (P, N) uint8, w (N,) f32, pa/pb (K,) int32, out (K, 256, 256) zeroed:
// int32 when integer_weights (weights rounded to int), else f32.
extern "C" int pair_hist_launch(int device, const void* ix, const void* w, const void* pa, const void* pb,
                                long long n, int n_pairs, int n_chunks, int integer_weights, void* out,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* ix8 = static_cast<const uint8_t*>(ix);
  const auto* wf = static_cast<const float*>(w);
  const auto* a = static_cast<const int*>(pa);
  const auto* b = static_cast<const int*>(pb);
  auto s = static_cast<cudaStream_t>(stream);
  if (integer_weights) err = launch<int>(ix8, wf, a, b, n, n_pairs, n_chunks, static_cast<int*>(out), s);
  else err = launch<float>(ix8, wf, a, b, n, n_pairs, n_chunks, static_cast<float*>(out), s);
  return static_cast<int>(err);
}
