// Weighted pair histograms for Hopper (sm_90a).
//
// Every kernel here computes, for each pair k of a pair list,
// out[k, b, a] = sum of w[i] over samples i with ix[pb[k], i] == b and
// ix[pa[k], i] == a (rows = b, cols = a).  Samples whose a or b index lies
// outside [0, nbins) are dropped, as the TPU's one-hot contractions drop them.
// The TPU kernels (getdist_tpu/ops/pallas_kernels.py) built weighted one-hot
// stacks and contracted them on the MXU; on Hopper that is ~7.7 GB of one-hot
// traffic at 30 params x 1M samples and 256 bins, so these kernels bin
// directly with shared-memory atomics.  The index rows stay L2-resident
// (30 x 1M uint8 = 30 MB < 50 MB L2).  Integer weights accumulate in int32
// (bit-exact, order independent); float weights in f32 (the atomic order
// varies from run to run).
//
// pair_hist_uint8_kernel: uint8 index rows, nbins <= 256.  Replaces
// pair_histograms_tiled (K1, the static all-pairs schedule, via
// pair_histograms) and pair_histograms_grouped (K5, b-anchored groups, via
// pair_histograms_grouped, whose non-padding slots become the pair list).
// Two blocks per pair (and sample chunk), each owning half of the pair's
// rows: [0, R) or [R, nbins), R = ceil(nbins / 2), 128 KB of int32 or f32 at
// 256 bins, the most one block's shared memory holds.  Each block reads a, b
// and w of every sample and adds those whose b lies in its rows.  What
// bounds it: those reads, from L2 (each sample is read once per half: 5.2 GB
// at 30 x 1M, 435 pairs with f32 weights, 2.6 GB with uint8), ahead of its
// one shared-memory atomic per sample and pair (435 M).  The design against
// both:
// - a scan built for L2 bandwidth and latency: each thread reads 16 samples
//   of a, b and w as 16-byte vectors (no per-sample branch between dependent
//   loads), all of them in registers before the first atomic.  A column
//   starts at byte p * N, so where N % 16 != 0 a column's vectors are read as
//   two aligned 16-byte loads funnel-shifted into place; the weights' vectors
//   are always aligned (a block's sample range starts at a multiple of 16),
//   and a scalar tail takes the last samples;
// - integer weights that fit come as uint8 (the callers that know them
//   narrow them), a quarter of the f32 weight stream, which is 4 of the 6
//   bytes a sample;
// - f32 written by the kernel: a block that owns its rows over all samples
//   converts its int32 sums (__int2float_rn, the rounding of a .to(float32)
//   of the exact integer) and writes them with 16-byte streaming stores
//   (__stcs), so the output (114 MB at 435 pairs) does not push the index
//   rows out of L2.  No zero fill, no global atomics, no conversion pass.
//   Where the pairs' blocks would not fill the card (few pairs), each pair's
//   samples are split over several chunks, which flush their nonzero bins
//   with global atomics into a zeroed accumulator instead.
// A cluster of 2 CTAs holding the whole histogram in distributed shared
// memory, each CTA scanning half the samples once and adding into its
// peer's rows with red.shared::cluster, halves the reads but measured 3x
// slower on an H100: the remote adds are far slower than local ones.  f32
// adds to shared memory take twice the time of int32 ones.
//
// pair_hist_kernel: any bin count up to 1024, uint8 / int16 / int32 rows.
// Replaces pair_histograms (K4, dynamic pair lists such as parity mode's
// sheared lead/residual stacks) and serves K1's entry for int16 / int32 rows
// (parity's fine grids past 256 bins).  A full histogram tile does not fit
// a block's shared memory (3.7 MB at 960 bins), so each block owns a slab of
// R rows of one pair's histogram (R * nbins * 4 bytes <= 128 KB: R = 128 at
// 256 bins, 34 at 960) over one chunk of samples, skips samples whose b bin
// lies in another slab, and flushes its nonzero bins with global atomics into
// a zeroed output.  Bounded by the same atomics and by the latency of its
// scalar index reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The uint8 kernel (uint8 index rows, nbins <= 256)

constexpr int kVec = 16;  // samples per vector: 16 bytes of a uint8 column

constexpr int kGroup = 8;  // slots per group of a K5 plan

struct Uint8Args {
  const uint8_t* ix;  // (P, n) uint8 index rows
  const void* w;      // (n,) f32 or uint8 weights, 16-byte aligned
  const int* pa;      // (K,) a rows, or a K5 plan's (slots,) grp_a
  const int* pb;      // (K,) b rows, or the plan's (slots / kGroup,) grp_b
  const int* inv;     // null, or the plan's (K,) inv_perm: pair k is slot inv[k]
  int slots;
  int p;              // rows, slots and inv are clamped: the wrapper checks them after the launch
  long long n;
  long long chunk;  // samples per chunk, a multiple of kVec
  int nbins;
  void* out;  // (K, nbins, nbins): f32 written (one chunk), else Acc accumulated
};

template <typename Acc>
__device__ __forceinline__ Acc to_acc(float w);

template <>
__device__ __forceinline__ int to_acc<int>(float w) {
  return __float2int_rn(w);
}

template <>
__device__ __forceinline__ float to_acc<float>(float w) {
  return w;
}

__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// A column of uint8 values whose first byte lies `shift` bytes past a
// 16-byte boundary: `base` is that boundary.
struct Column {
  const uint8_t* base;
  int word;  // shift / 4
  int bits;  // 8 * (shift % 4)
};

__device__ __forceinline__ Column column_at(const uint8_t* col) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(col) & 15);
  return {col - shift, shift >> 2, 8 * (shift & 3)};
}

// samples [i, i + 16) of a column, i a multiple of 16, as 4 words.  kShifted:
// two aligned loads funnel-shifted by the column's shift (reads up to byte
// i + 31 of the column)
template <bool kShifted>
__device__ __forceinline__ uint4 load16(const Column& c, long long i) {
  const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(c.base + i));
  if constexpr (!kShifted) {
    return v0;
  } else {
    const uint4 v1 = __ldg(reinterpret_cast<const uint4*>(c.base + i + kVec));
    const uint32_t words[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    uint32_t x[5];  // words[word .. word + 4], selected without indexing by the runtime word
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const uint32_t lo = (c.word & 1) ? words[j + 1] : words[j];
      const uint32_t hi = (c.word & 1) ? words[j + 3] : words[j + 2];
      x[j] = (c.word & 2) ? hi : lo;
    }
    return make_uint4(__funnelshift_r(x[0], x[1], c.bits), __funnelshift_r(x[1], x[2], c.bits),
                      __funnelshift_r(x[2], x[3], c.bits), __funnelshift_r(x[3], x[4], c.bits));
  }
}

__device__ __forceinline__ int byte_of(const uint4& v, int u) {
  const uint32_t word = u < 4 ? v.x : u < 8 ? v.y : u < 12 ? v.z : v.w;
  return static_cast<int>((word >> (8 * (u & 3))) & 0xffu);
}

// 16 weights of samples [i, i + 16), as f32 (4 aligned 16-byte loads) or
// uint8 (one)
template <typename W>
struct Weights16;

template <>
struct Weights16<float> {
  float4 v[4];
  __device__ __forceinline__ void load(const void* w, long long i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(w) + i) + j);
  }
  template <typename Acc>
  __device__ __forceinline__ Acc at(int u) const {
    const float4& q = v[u >> 2];
    return to_acc<Acc>((u & 3) == 0 ? q.x : (u & 3) == 1 ? q.y : (u & 3) == 2 ? q.z : q.w);
  }
  template <typename Acc>
  __device__ __forceinline__ static Acc scalar(const void* w, long long i) {
    return to_acc<Acc>(static_cast<const float*>(w)[i]);
  }
};

template <>
struct Weights16<uint8_t> {
  uint4 v;
  __device__ __forceinline__ void load(const void* w, long long i) {
    v = __ldg(reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(w) + i));
  }
  template <typename Acc>
  __device__ __forceinline__ Acc at(int u) const {
    return Acc(byte_of(v, u));
  }
  template <typename Acc>
  __device__ __forceinline__ static Acc scalar(const void* w, long long i) {
    return Acc(static_cast<const uint8_t*>(w)[i]);
  }
};

// The block's adds: rows [row0, row0 + rows) of the histogram, in its tile.
template <typename Acc, int kFixedBins>
struct Adder {
  Acc* tile;
  int row0;
  int rows;
  int nbins;

  __device__ __forceinline__ void operator()(int a, int b, Acc v) const {
    const int bins = kFixedBins ? kFixedBins : nbins;
    const int row = b - row0;
    // at 256 bins a uint8 index is always in range
    if (static_cast<unsigned>(row) >= static_cast<unsigned>(rows) || (!kFixedBins && a >= bins)) return;
    atomicAdd(&tile[row * bins + a], v);
  }
};

template <typename Acc, typename W, int kFixedBins, bool kShifted>
__device__ __forceinline__ void scan(const Adder<Acc, kFixedBins>& add, const Column& ca, const Column& cb,
                                     const void* w, const uint8_t* col_a, const uint8_t* col_b, long long start,
                                     long long body_end, long long stop) {
  for (long long i = start + static_cast<long long>(kVec) * threadIdx.x; i < body_end;
       i += static_cast<long long>(kVec) * kThreads) {
    const uint4 bv = load16<kShifted>(cb, i);
    const uint4 av = load16<kShifted>(ca, i);
    Weights16<W> wv;
    wv.load(w, i);
#pragma unroll
    for (int u = 0; u < kVec; ++u) add(byte_of(av, u), byte_of(bv, u), wv.template at<Acc>(u));
  }
  for (long long i = body_end + threadIdx.x; i < stop; i += kThreads)
    add(static_cast<int>(col_a[i]), static_cast<int>(col_b[i]), Weights16<W>::template scalar<Acc>(w, i));
}

// One block per (pair, half of its rows, sample chunk): blockIdx.y the pair,
// blockIdx.x & 1 the half (rows [0, R) or [R, nbins), R = ceil(nbins / 2)),
// blockIdx.x >> 1 the chunk (kSplit: more than one chunk per pair).
template <typename Acc, typename W, int kFixedBins, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1) pair_hist_uint8_kernel(const Uint8Args args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* tile = reinterpret_cast<Acc*>(smem_raw);
  const int nbins = kFixedBins ? kFixedBins : args.nbins;
  const int half = (nbins + 1) / 2;
  const int k = blockIdx.y;
  Adder<Acc, kFixedBins> add;
  add.tile = tile;
  add.row0 = (blockIdx.x & 1) * half;
  add.rows = min(half, nbins - add.row0);
  add.nbins = nbins;

  const int count = add.rows * nbins;
  for (int j = threadIdx.x; j < (count + 3) / 4; j += kThreads) reinterpret_cast<int4*>(tile)[j] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const long long start = static_cast<long long>(blockIdx.x >> 1) * args.chunk;
  const long long stop = min(start + args.chunk, args.n);
  int a_row = args.pa[k], b_row = args.pb[k];
  if (args.inv) {  // K5's work list: the slot its plan picks for pair k
    const int slot = min(max(args.inv[k], 0), args.slots - 1);
    a_row = args.pa[slot];
    b_row = args.pb[slot / kGroup];
  }
  const uint8_t* col_a = args.ix + static_cast<long long>(min(max(a_row, 0), args.p - 1)) * args.n;
  const uint8_t* col_b = args.ix + static_cast<long long>(min(max(b_row, 0), args.p - 1)) * args.n;
  const Column ca = column_at(col_a), cb = column_at(col_b);
  if ((ca.word | ca.bits | cb.word | cb.bits) == 0) {
    const long long body_end = start + (stop - start) / kVec * kVec;
    scan<Acc, W, kFixedBins, false>(add, ca, cb, args.w, col_a, col_b, start, body_end, stop);
  } else {
    // the second aligned load of a shifted vector reads to sample i + 31
    const long long last = args.n >= 2 * kVec ? (args.n - 2 * kVec) / kVec * kVec + kVec : 0;
    const long long body_end = max(start, min(start + (stop - start) / kVec * kVec, last));
    scan<Acc, W, kFixedBins, true>(add, ca, cb, args.w, col_a, col_b, start, body_end, stop);
  }
  __syncthreads();

  const long long offset = static_cast<long long>(k) * nbins * nbins + static_cast<long long>(add.row0) * nbins;
  if constexpr (kSplit) {
    Acc* dst = static_cast<Acc*>(args.out) + offset;
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const Acc v = tile[j];
      if (v != Acc(0)) atomicAdd(&dst[j], v);
    }
  } else {
    // the block owns its rows: f32 straight out, streaming past L2
    float* dst = static_cast<float*>(args.out) + offset;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (count & 3) == 0) {
      using Vec4 = typename std::conditional<std::is_same<Acc, int>::value, int4, float4>::type;
      const Vec4* src = reinterpret_cast<const Vec4*>(tile);
      for (int j = threadIdx.x; j < count / 4; j += kThreads) {
        const Vec4 v = src[j];
        __stcs(reinterpret_cast<float4*>(dst) + j, make_float4(to_f32(v.x), to_f32(v.y), to_f32(v.z), to_f32(v.w)));
      }
    } else {
      for (int j = threadIdx.x; j < count; j += kThreads) __stcs(dst + j, to_f32(tile[j]));
    }
  }
}

template <typename Acc, typename W, int kFixedBins, bool kSplit>
cudaError_t launch_uint8(const Uint8Args& args, int n_pairs, int n_split, cudaStream_t stream) {
  auto* kernel = pair_hist_uint8_kernel<Acc, W, kFixedBins, kSplit>;
  const int half = (args.nbins + 1) / 2;
  const int bytes = (half * args.nbins + 3) / 4 * 16;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(2 * n_split, n_pairs), kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

template <typename Acc, typename W>
cudaError_t launch_uint8_bins(const Uint8Args& args, int n_pairs, int n_split, cudaStream_t stream) {
  if (n_split > 1) {
    if (args.nbins == 256) return launch_uint8<Acc, W, 256, true>(args, n_pairs, n_split, stream);
    return launch_uint8<Acc, W, 0, true>(args, n_pairs, n_split, stream);
  }
  if (args.nbins == 256) return launch_uint8<Acc, W, 256, false>(args, n_pairs, n_split, stream);
  return launch_uint8<Acc, W, 0, false>(args, n_pairs, n_split, stream);
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

// ix (P, N) uint8, w (N,) 16-byte aligned: uint8 (integer weights) or f32
// (weight_bytes 1 / 4), pa/pb (K,) int32; or, with inv (K,) non-null, a
// K5 plan: pa (slots,) = grp_a, pb (slots / 8,) = grp_b, pair k the slot
// inv[k] (rows and slots clamped into range).  1 <= nbins <= 256.  n_split == 1: out (K, nbins, nbins) f32, every
// element written.  n_split > 1: each pair's samples split over n_split
// chunks, which add into out, zeroed: int32 when integer_weights (f32
// weights rounded to int) else f32.
extern "C" int pair_hist_uint8_launch(int device, const void* ix, int p, const void* w, int weight_bytes,
                                      const void* pa, const void* pb, const void* inv, int slots, long long n,
                                      int n_pairs, int nbins, int n_split, int integer_weights, void* out,
                                      void* stream) {
  if (p < 1 || (inv && slots < 1) || nbins < 1 || nbins > 256 || n_split < 1 || (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (weight_bytes == 1 && !integer_weights) || (weight_bytes != 1 && weight_bytes != 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Uint8Args args;
  args.ix = static_cast<const uint8_t*>(ix);
  args.w = w;
  args.pa = static_cast<const int*>(pa);
  args.pb = static_cast<const int*>(pb);
  args.inv = static_cast<const int*>(inv);
  args.slots = slots;
  args.p = p;
  args.n = n;
  args.chunk = ((n + n_split - 1) / n_split + kVec - 1) / kVec * kVec;
  args.nbins = nbins;
  args.out = out;
  auto s = static_cast<cudaStream_t>(stream);
  if (weight_bytes == 1)
    err = launch_uint8_bins<int, uint8_t>(args, n_pairs, n_split, s);
  else if (integer_weights)
    err = launch_uint8_bins<int, float>(args, n_pairs, n_split, s);
  else
    err = launch_uint8_bins<float, float>(args, n_pairs, n_split, s);
  return static_cast<int>(err);
}
