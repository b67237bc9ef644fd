// Weighted pair histograms for Hopper (sm_90a).
//
// Every kernel here computes, for each pair k of a pair list,
// out[k, b, a] = sum of w[i] over samples i with ix[pb[k], i] == b and
// ix[pa[k], i] == a (rows = b, cols = a).  Samples whose a or b index lies
// outside [0, nbins) are dropped, as the TPU's one-hot contractions drop them.
// The TPU kernels (getdist_tpu/ops/pallas_kernels.py) built weighted one-hot
// stacks and contracted them on the MXU; on Hopper that is ~7.7 GB of one-hot
// traffic at 30 params x 1M samples and 256 bins, so these kernels bin
// directly with shared-memory atomics.  Integer weights accumulate in int32
// (bit-exact, order independent).  Fractional weights: in 64-bit fixed point
// on the uint8 kernel (each weight rounded once to a multiple of 2^-62 of
// max |w| * N, then integer adds: order independent, so every call and both
// of its routes give the same bits, within f32 rounding of an f64 sum); in
// f32 on the wide kernels (the atomic order varies from run to run).
//
// pair_hist_uint8_kernel: uint8 index rows, nbins <= 256.  Replaces
// pair_histograms_tiled (K1, pallas_kernels.py:309, the static all-pairs
// schedule, via pair_histograms), pair_histograms (K4, pallas_kernels.py:65,
// dynamic pair lists such as parity mode's sheared lead/residual stacks,
// via pair_histograms_dynamic) and pair_histograms_grouped (K5,
// pallas_kernels.py:170, b-anchored groups, via pair_histograms_grouped,
// whose non-padding slots become the pair list).  K1's rows stay in L2 (30
// x 1M uint8 = 30 MB < 50 MB); K4's sheared stack (139 rows x 1M, 112 pairs
// whose a rows repeat) does not, and comes once from HBM (139 MB).
// Two blocks per pair (and sample chunk), each owning half of the pair's
// rows: [0, R) or [R, nbins), R = ceil(nbins / 2), 128 KB of int32 at 256
// bins, the most one block's shared memory holds; four blocks of a quarter
// each with fixed-point (8-byte) bins.  Each block reads a, b and w of every
// sample and adds those whose b lies in its rows.  What
// bounds it: those reads, from L2 (each sample is read once per part: 2.6 GB
// at 30 x 1M, 435 pairs with uint8 weights, 5.2 GB with f32 integer ones,
// 10.4 GB with fractional ones in four parts), ahead of its
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
// Two designs that halve those reads lost to this one on an H100, both as
// a 2-CTA cluster per pair: one holding the whole histogram in distributed
// shared memory, each CTA scanning half the samples and adding into its
// peer's rows with red.shared::cluster (3x slower: remote adds are far
// slower than local ones); and one whose CTA 0 multicast each chunk of a, b
// and w into both CTAs' shared memory with bulk asynchronous copies
// (cp.async.bulk .multicast::cluster into a ring of mbarrier-completed
// stages), each CTA adding its own rows from the staged chunk (2-9% slower
// on K4's sheared stack, 9-10% on K1's rows: halving the L2 reads bought
// nothing once the adds bound the scan, and the staging writes and reads
// the shared memory that the atomics use).  f32 adds to shared memory take
// twice the time of int32 ones.
//
// The wide kernels: int16 / int32 index rows, any bin count up to 1024.
// Serve K1's and K4's entries for rows that are not uint8: the fine grids
// past 256 bins that both the public fused entry's regrids and parity mode
// stretch along tight degeneracies (384 bins at |corr| 0.9, 576 at 0.95,
// 960 at 0.98 and above), and rows that their caller cannot narrow to uint8
// (a narrowing never wraps an index outside [0, nbins) into range, so such
// a row stays wide, and these kernels drop the index).  The JAX package has
// no Pallas kernel for this work: past 256 bins it bins with
// getdist_tpu/ops/batched.py:125 _pair_hist_256(..., nbins=fine), bf16
// one-hot matmuls under lax.map (its Pallas kernels only take fine_bins ==
// 256, the gate at batched.py:1451), and parity through
// getdist_tpu/ops/parity_device.py:119 _hists_one_part.
//
// A full histogram (3.7 MB at 960 bins) does not fit a block's shared
// memory, so a block can own only a slab of R rows (R * nbins * 4 bytes of
// int32 or f32, at most 232,000 of the 232,448 a block may opt in to).  A
// block that scans all of a pair's samples and keeps those of its slab reads
// the pair's data once per slab (16 times at 960 bins).  Two designs
// instead, each held bit-exact against the plain version:
// - bucket (pair_hist_wide_count / _plan / _scatter / _bin kernels):
//   * count: entries per (pair, slab, scan block), from the b column only;
//   * plan (one block): each slab's segment of a per-pair entry buffer,
//     each scan block's range in it, and the slab's bin blocks (one, or
//     ceil(entries / part) for a long segment);
//   * scatter: each sample once into its range, as a 16-bit in-slab key
//     (b - row0) * nbins + a (R * nbins <= 58,000) with its weight (4 bytes
//     with uint8 weights, 8 with f32); a shared-memory atomic gives each
//     sample its place, so the samples of one slab in a warp take
//     consecutive places and the writes coalesce;
//   * bin: one block per slab bins its segment in shared memory (16-byte
//     entry loads, 4 in flight a thread) and writes its rows as f32 (no
//     zero fill, no flush, no conversion pass).  Gaussian marginals put
//     most samples in the central slabs: the blocks of a long segment
//     flush into a zeroed accumulator slab with global atomics, and the
//     last of them to finish writes the slab's f32 rows.
//   Each sample is read twice (count, scatter) and its entry written and
//   read once, about 3x a pair's data, whatever the slab count.  About 12
//   slabs a histogram (smaller tiles than the most that fit: two bin blocks
//   a multiprocessor) and two bin blocks' worth of entries a multiprocessor
//   measured fastest.  What bounds it: the entry traffic (8 bytes a sample
//   and pair with uint8 weights) and the bin blocks' tiles, written once.
// - direct (pair_hist_wide_direct_kernel): one global atomic per sample
//   into a zeroed (K, nbins, nbins) accumulator, then (integer weights) an
//   in-place int32 -> f32 pass.  Bound by the L2's atomic rate; no fixed
//   cost beyond three launches, so it wins for few pair samples.  Merging
//   equal keys in a warp first (__match_any_sync) bought nothing and was
//   removed: a warp's 32 samples of a chain in random order rarely share a
//   bin (a 0.995-correlated Gaussian pair at 960 bins spreads its mass over
//   ~1,000 cells of its densest slab), and the match is slow.
// The route rule (pair_hist.py:wide_plan) picks the faster for a shape
// (PERF.md has the times of both).  In both, each thread reads a, b and w
// as 16-byte vectors (8 int16 or 4 int32 samples; a column that starts off
// a 16-byte boundary is read as two aligned loads funnel-shifted into
// place), the slab of a row is a multiply (no division), and pair indices
// are clamped into the rows (the wrapper checks them after the launch).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 1024;

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
  const float* wmax;  // fixed point: max |w| (the scale's source), on the card
  void* out;  // (K, nbins, nbins): f32 written (one chunk), else Acc accumulated
};

template <typename Acc>
__device__ __forceinline__ Acc to_acc(float w);

// The uint8 kernel's fixed-point bins: a fractional weight w adds
// round(w * scale), scale = 2^(62 - e) with max |w| * N < 2^e, so no sum of
// at most N of them leaves int64, whatever the order (two's complement in
// unsigned adds).  Bins read back as sum / scale, rounded to f32 once.
using Fixed = unsigned long long;

template <typename Acc>
constexpr int kParts = sizeof(Acc) == 8 ? 4 : 2;  // blocks sharing one pair's rows

__device__ __forceinline__ double fixed_scale(const float* wmax, long long n) {
  int e;
  frexp(static_cast<double>(__ldg(wmax)) * static_cast<double>(n), &e);
  return ldexp(1.0, 62 - e);
}

// A weight as a bin's addend: an f32 weight rounded (int32 bins) or scaled
// and rounded (fixed point); a uint8 weight as it is.
template <typename Acc>
__device__ __forceinline__ Acc acc_of(float w, double scale);

template <typename Acc>
__device__ __forceinline__ Acc acc_of(int w, double) {
  return Acc(w);
}

template <>
__device__ __forceinline__ int acc_of<int>(float w, double) {
  return __float2int_rn(w);
}

template <>
__device__ __forceinline__ Fixed acc_of<Fixed>(float w, double scale) {
  return static_cast<Fixed>(__double2ll_rn(static_cast<double>(w) * scale));
}

__device__ __forceinline__ float out_value(int v, double) { return __int2float_rn(v); }
__device__ __forceinline__ float out_value(Fixed v, double inv_scale) {
  return __double2float_rn(__ll2double_rn(static_cast<long long>(v)) * inv_scale);
}

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
  __device__ __forceinline__ float at(int u) const {
    const float4& q = v[u >> 2];
    return (u & 3) == 0 ? q.x : (u & 3) == 1 ? q.y : (u & 3) == 2 ? q.z : q.w;
  }
  __device__ __forceinline__ static float scalar(const void* w, long long i) {
    return static_cast<const float*>(w)[i];
  }
};

template <>
struct Weights16<uint8_t> {
  uint4 v;
  __device__ __forceinline__ void load(const void* w, long long i) {
    v = __ldg(reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(w) + i));
  }
  __device__ __forceinline__ int at(int u) const { return byte_of(v, u); }
  __device__ __forceinline__ static int scalar(const void* w, long long i) {
    return static_cast<const uint8_t*>(w)[i];
  }
};

// The block's adds: rows [row0, row0 + rows) of the histogram, in its tile.
template <typename Acc, int kFixedBins>
struct Adder {
  Acc* tile;
  int row0;
  int rows;
  int nbins;
  double scale;  // fixed point's (1 for int32 bins)

  // w: the sample's f32 or uint8 weight, converted only where it is added
  template <typename Raw>
  __device__ __forceinline__ void operator()(int a, int b, Raw w) const {
    const int bins = kFixedBins ? kFixedBins : nbins;
    const int row = b - row0;
    // at 256 bins a uint8 index is always in range
    if (static_cast<unsigned>(row) >= static_cast<unsigned>(rows) || (!kFixedBins && a >= bins)) return;
    atomicAdd(&tile[row * bins + a], acc_of<Acc>(w, scale));
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
    for (int u = 0; u < kVec; ++u) add(byte_of(av, u), byte_of(bv, u), wv.at(u));
  }
  for (long long i = body_end + threadIdx.x; i < stop; i += kThreads)
    add(static_cast<int>(col_a[i]), static_cast<int>(col_b[i]), Weights16<W>::scalar(w, i));
}

// One block per (pair, part of its rows, sample chunk): blockIdx.y the pair,
// blockIdx.x % kParts the part (rows [part * R, (part + 1) * R), R =
// ceil(nbins / kParts)), blockIdx.x / kParts the chunk (kSplit: more than
// one chunk per pair).  Acc: int (integer weights) or Fixed.
template <typename Acc, typename W, int kFixedBins, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1) pair_hist_uint8_kernel(const Uint8Args args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* tile = reinterpret_cast<Acc*>(smem_raw);
  constexpr int parts = kParts<Acc>;
  const int nbins = kFixedBins ? kFixedBins : args.nbins;
  const int span = (nbins + parts - 1) / parts;
  const int k = blockIdx.y;
  Adder<Acc, kFixedBins> add;
  add.tile = tile;
  add.row0 = static_cast<int>(blockIdx.x % parts) * span;
  add.rows = max(0, min(span, nbins - add.row0));
  add.nbins = nbins;
  add.scale = 1.0;
  if constexpr (std::is_same<Acc, Fixed>::value) add.scale = fixed_scale(args.wmax, args.n);

  const int count = add.rows * nbins;
  const int words = (count * static_cast<int>(sizeof(Acc)) + 15) / 16;
  for (int j = threadIdx.x; j < words; j += kThreads) reinterpret_cast<int4*>(tile)[j] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const long long start = static_cast<long long>(blockIdx.x / parts) * args.chunk;
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
    const double inv_scale = 1.0 / add.scale;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (count & 3) == 0) {
      for (int j = threadIdx.x; j < count / 4; j += kThreads) {
        const Acc* v = tile + 4 * j;
        __stcs(reinterpret_cast<float4*>(dst) + j, make_float4(out_value(v[0], inv_scale), out_value(v[1], inv_scale),
                                                               out_value(v[2], inv_scale), out_value(v[3], inv_scale)));
      }
    } else {
      for (int j = threadIdx.x; j < count; j += kThreads) __stcs(dst + j, out_value(tile[j], inv_scale));
    }
  }
}

// The split route's fixed-point sums (K, nbins, nbins) as f32.
__global__ void pair_hist_fixed_convert_kernel(const Fixed* acc, float* out, long long count, const float* wmax,
                                               long long n) {
  const double inv_scale = 1.0 / fixed_scale(wmax, n);
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; q < count;
       q += static_cast<long long>(gridDim.x) * blockDim.x)
    out[q] = out_value(acc[q], inv_scale);
}

template <typename Acc, typename W, int kFixedBins, bool kSplit>
cudaError_t launch_uint8(const Uint8Args& args, int n_pairs, int n_split, cudaStream_t stream) {
  auto* kernel = pair_hist_uint8_kernel<Acc, W, kFixedBins, kSplit>;
  const int span = (args.nbins + kParts<Acc> - 1) / kParts<Acc>;
  const int bytes = (span * args.nbins * static_cast<int>(sizeof(Acc)) + 15) / 16 * 16;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(kParts<Acc> * n_split, n_pairs), kThreads, bytes, stream>>>(args);
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


// ---------------------------------------------------------------------------
// The wide kernels (int16 / int32 index rows, nbins <= 1024)

constexpr int kWideThreads = 512;  // count, scatter and direct kernels
constexpr int kPlanThreads = 1024;
// a slab's tile: 232,000 of the 232,448 bytes of shared memory a block may
// hold (the rest for the bin kernel's static shared memory)
constexpr int kTileWords = 58000;
constexpr int kMaxSlabs = 64;
constexpr unsigned kDropped = 0xffffu;  // the key of a sample whose a index lies outside the grid

struct WideArgs {
  const void* ix;  // (P, n) int16 / int32 index rows
  const void* w;   // (n,) uint8 or f32 weights, 16-byte aligned
  const int* pa;   // (K,) a rows, clamped into [0, P)
  const int* pb;   // (K,) b rows, clamped into [0, P)
  int p;
  long long n;
  long long chunk;  // samples per block of the count, scatter and direct kernels, a multiple of 16
  int n_chunks;     // C: blocks per pair of those kernels
  int n_pairs;
  int nbins;
  int rows;   // R: rows per slab
  int slabs;  // S = ceil(nbins / R)
  unsigned long long slab_magic;  // ceil(2^32 / R): b / R == (b * slab_magic) >> 32 for b < 2^32 / R
  long long part;  // most entries one block of the bin kernel takes from a segment
  void* out;       // (K, nbins, nbins) f32 (the direct route accumulates in it first)
  // the bucket route's workspace: 8 * K * S * (C + 1) + 4 * (4 * K * S + 2) bytes
  long long* seg;          // (K * S,) first entry of each slab's segment
  long long* block_first;  // (K, S, C) entries of each count block per slab, then the offset of its first
  int* counts;             // (K * S,) entries per slab
  int* done;               // (K * S,) parts of a split slab finished, zeroed
  int* work;       // (K * S + 1,) first bin-kernel block of each slab; [K * S]: all blocks
  int* slot;       // (K * S,) accumulator slab of a split slab, else -1
  int* n_split;    // (1,) split slabs
  void* entries;   // (K * n,) uint32 (uint8 weights) or uint2 entries
  void* split;     // accumulator slabs, R * nbins Acc each
};

template <typename Idx>
constexpr int kLanes = 16 / static_cast<int>(sizeof(Idx));  // samples of a 16-byte vector

// element u of a 16-byte vector of int16 / int32 values
template <typename Idx>
__device__ __forceinline__ int elem(const uint4& v, int u);

template <>
__device__ __forceinline__ int elem<int16_t>(const uint4& v, int u) {
  const uint32_t word = u < 2 ? v.x : u < 4 ? v.y : u < 6 ? v.z : v.w;
  return static_cast<int>(static_cast<int16_t>(word >> (16 * (u & 1))));
}

template <>
__device__ __forceinline__ int elem<int32_t>(const uint4& v, int u) {
  return static_cast<int>(u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w);
}

template <typename Acc>
__device__ __forceinline__ Acc weight_as(float w) {
  return to_acc<Acc>(w);
}

template <typename Acc>
__device__ __forceinline__ Acc weight_as(int w) {
  return Acc(w);
}

// U weights of samples [i, i + U), i a multiple of U
template <typename W, int U>
struct WideWeights;

template <int U>
struct WideWeights<float, U> {
  float v[U];
  __device__ __forceinline__ void load(const void* w, long long i) {
#pragma unroll
    for (int j = 0; j < U / 4; ++j) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(w) + i) + j);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  }
  __device__ __forceinline__ float at(int u) const { return v[u]; }
  __device__ __forceinline__ static float scalar(const void* w, long long i) { return static_cast<const float*>(w)[i]; }
};

template <>
struct WideWeights<uint8_t, 8> {
  uint2 v;
  __device__ __forceinline__ void load(const void* w, long long i) {
    v = __ldg(reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(w) + i));
  }
  __device__ __forceinline__ int at(int u) const {
    return static_cast<int>(((u < 4 ? v.x : v.y) >> (8 * (u & 3))) & 0xffu);
  }
  __device__ __forceinline__ static int scalar(const void* w, long long i) { return static_cast<const uint8_t*>(w)[i]; }
};

template <>
struct WideWeights<uint8_t, 4> {
  unsigned v;
  __device__ __forceinline__ void load(const void* w, long long i) {
    v = __ldg(reinterpret_cast<const unsigned*>(static_cast<const uint8_t*>(w) + i));
  }
  __device__ __forceinline__ int at(int u) const { return static_cast<int>((v >> (8 * u)) & 0xffu); }
  __device__ __forceinline__ static int scalar(const void* w, long long i) { return static_cast<const uint8_t*>(w)[i]; }
};

// a pair's two columns, rows clamped into [0, P)
template <typename Idx>
struct PairCols {
  const Idx* a;
  const Idx* b;
  Column ca, cb;
  bool shifted;  // either column starts off a 16-byte boundary
};

template <typename Idx>
__device__ __forceinline__ PairCols<Idx> pair_cols(const WideArgs& args, int k) {
  const Idx* ix = static_cast<const Idx*>(args.ix);
  PairCols<Idx> c;
  c.a = ix + static_cast<long long>(min(max(args.pa[k], 0), args.p - 1)) * args.n;
  c.b = ix + static_cast<long long>(min(max(args.pb[k], 0), args.p - 1)) * args.n;
  c.ca = column_at(reinterpret_cast<const uint8_t*>(c.a));
  c.cb = column_at(reinterpret_cast<const uint8_t*>(c.b));
  c.shifted = (c.ca.word | c.ca.bits | c.cb.word | c.cb.bits) != 0;
  return c;
}

// U samples of one thread
template <typename Idx, typename Acc>
struct Lane {
  static constexpr int U = kLanes<Idx>;
  int a[U];
  int b[U];  // -1 past the block's samples
  Acc w[U];
};

template <bool kShifted>
__device__ __forceinline__ uint4 load_vec(const Column& c, long long byte) {
  return load16<kShifted>(c, byte);
}

// samples [i0, i0 + U) of a pair (i0 a multiple of U): 16-byte vectors where
// they lie inside [0, stop) and, for shifted columns, the second aligned
// load stays inside the column; else scalar loads.  kFull: a and w too
// (else b only).
template <bool kFull, typename Idx, typename W, typename Acc>
__device__ __forceinline__ void load_lane(const PairCols<Idx>& c, const void* w, long long i0, long long stop,
                                          long long n, Lane<Idx, Acc>& s) {
  constexpr int U = kLanes<Idx>;
  constexpr int E = static_cast<int>(sizeof(Idx));
  if (i0 + U <= stop && (!c.shifted || i0 + 2 * U <= n)) {
    const long long byte = i0 * E;
    const uint4 bv = c.shifted ? load_vec<true>(c.cb, byte) : load_vec<false>(c.cb, byte);
    uint4 av;
    WideWeights<W, U> wv;
    if constexpr (kFull) {
      av = c.shifted ? load_vec<true>(c.ca, byte) : load_vec<false>(c.ca, byte);
      wv.load(w, i0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s.b[u] = elem<Idx>(bv, u);
      if constexpr (kFull) {
        s.a[u] = elem<Idx>(av, u);
        s.w[u] = weight_as<Acc>(wv.at(u));
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = i0 + u;
      s.b[u] = i < stop ? static_cast<int>(c.b[i]) : -1;
      if constexpr (kFull) {
        s.a[u] = i < stop ? static_cast<int>(c.a[i]) : -1;
        s.w[u] = i < stop ? weight_as<Acc>(WideWeights<W, U>::scalar(w, i)) : Acc(0);
      }
    }
  }
}

// An entry of a slab's segment: the in-slab key and the weight.  add(tile,
// v) adds the entries of a 16-byte vector (4 or 2 of them) to a tile.
template <typename W, typename Acc>
struct Entry;

template <>
struct Entry<uint8_t, int> {  // key | weight << 16
  using T = uint32_t;
  __device__ __forceinline__ static T make(unsigned key, int w) { return key | (static_cast<unsigned>(w) << 16); }
  __device__ __forceinline__ static void add(int* tile, T e) {
    if ((e & 0xffffu) != kDropped) atomicAdd(&tile[e & 0xffffu], static_cast<int>(e >> 16));
  }
  __device__ __forceinline__ static void add(int* tile, const uint4& v) {
    add(tile, v.x);
    add(tile, v.y);
    add(tile, v.z);
    add(tile, v.w);
  }
};

template <typename Acc>
struct Entry<float, Acc> {  // {key, the weight's bits}
  using T = uint2;
  __device__ __forceinline__ static T make(unsigned key, Acc w) { return make_uint2(key, bits(w)); }
  __device__ __forceinline__ static void add(Acc* tile, T e) {
    if (e.x != kDropped) atomicAdd(&tile[e.x], from_bits(e.y));
  }
  __device__ __forceinline__ static void add(Acc* tile, const uint4& v) {
    add(tile, make_uint2(v.x, v.y));
    add(tile, make_uint2(v.z, v.w));
  }
  __device__ __forceinline__ static unsigned bits(int w) { return static_cast<unsigned>(w); }
  __device__ __forceinline__ static unsigned bits(float w) { return __float_as_uint(w); }
  __device__ __forceinline__ static Acc from_bits(unsigned u) {
    if constexpr (std::is_same<Acc, int>::value) {
      return static_cast<int>(u);
    } else {
      return __uint_as_float(u);
    }
  }
};

// the slab of row b (a multiply, not a division), or -1 for a row outside the grid
__device__ __forceinline__ int slab_of(int b, const WideArgs& args) {
  return static_cast<unsigned>(b) < static_cast<unsigned>(args.nbins)
             ? static_cast<int>((static_cast<unsigned long long>(b) * args.slab_magic) >> 32)
             : -1;
}

// Bucket pass 1: entries per (pair, slab).  Grid (chunks, K).
template <typename Idx>
__global__ void __launch_bounds__(kWideThreads) pair_hist_wide_count_kernel(const WideArgs args) {
  constexpr int U = kLanes<Idx>;
  __shared__ int local[kMaxSlabs];
  for (int j = threadIdx.x; j < args.slabs; j += kWideThreads) local[j] = 0;
  __syncthreads();
  const int k = blockIdx.y;
  const PairCols<Idx> c = pair_cols<Idx>(args, k);
  const long long start = static_cast<long long>(blockIdx.x) * args.chunk;
  const long long stop = min(start + args.chunk, args.n);
  for (long long i0 = start + static_cast<long long>(U) * threadIdx.x; i0 < stop;
       i0 += static_cast<long long>(U) * kWideThreads) {
    Lane<Idx, int> v;
    load_lane<false, Idx, float, int>(c, nullptr, i0, stop, args.n, v);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int slab = slab_of(v.b[u], args);
      if (slab >= 0) atomicAdd(&local[slab], 1);
    }
  }
  __syncthreads();
  long long* first = args.block_first + static_cast<long long>(k) * args.slabs * args.n_chunks + blockIdx.x;
  for (int j = threadIdx.x; j < args.slabs; j += kWideThreads) first[static_cast<long long>(j) * args.n_chunks] = local[j];
}

// exclusive scan of two values over the block; totals are the block's sums
__device__ __forceinline__ void block_scan2(int x0, int x1, int& e0, int& e1, int& t0, int& t1) {
  __shared__ int warp_sums[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = (blockDim.x + 31) >> 5;
  int i0 = x0, i1 = x1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y0 = __shfl_up_sync(0xffffffffu, i0, d), y1 = __shfl_up_sync(0xffffffffu, i1, d);
    if (lane >= d) {
      i0 += y0;
      i1 += y1;
    }
  }
  if (lane == 31) {
    warp_sums[0][warp] = i0;
    warp_sums[1][warp] = i1;
  }
  __syncthreads();
  int b0 = 0, b1 = 0;
  t0 = t1 = 0;
  for (int j = 0; j < warps; ++j) {
    if (j < warp) {
      b0 += warp_sums[0][j];
      b1 += warp_sums[1][j];
    }
    t0 += warp_sums[0][j];
    t1 += warp_sums[1][j];
  }
  __syncthreads();
  e0 = b0 + i0 - x0;
  e1 = b1 + i1 - x1;
}

// Bucket pass 2: one block.  Each slab's entries and the offset of each
// count block's first entry in its segment (pair k's entries start at k *
// n), its parts (one, or ceil(count / part) for a split slab), the first
// bin-kernel block of each slab, and the accumulator slab of each split one.
__global__ void __launch_bounds__(kPlanThreads) pair_hist_wide_plan_kernel(const WideArgs args) {
  const int S = args.slabs, C = args.n_chunks;
  const int lane = threadIdx.x & 31;
  // one warp per slab: the exclusive scan of its count blocks' entries
  for (int j = threadIdx.x >> 5; j < args.n_pairs * S; j += blockDim.x >> 5) {
    long long* row = args.block_first + static_cast<long long>(j) * C;
    long long carry = 0;
    for (int b0 = 0; b0 < C; b0 += 32) {
      const long long c = b0 + lane < C ? row[b0 + lane] : 0;
      long long incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      if (b0 + lane < C) row[b0 + lane] = carry + incl - c;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) args.counts[j] = static_cast<int>(carry);
  }
  __syncthreads();
  int carry_work = 0, carry_split = 0;
  for (int base = 0; base < args.n_pairs; base += blockDim.x) {
    const int k = base + threadIdx.x;
    int parts = 0, splits = 0;
    if (k < args.n_pairs) {
      for (int s = 0; s < S; ++s) {
        const long long c = args.counts[k * S + s];
        parts += c > args.part ? static_cast<int>((c + args.part - 1) / args.part) : 1;
        splits += c > args.part;
      }
    }
    int first_work, first_split, total_work, total_split;
    block_scan2(parts, splits, first_work, first_split, total_work, total_split);
    if (k < args.n_pairs) {
      long long entry = static_cast<long long>(k) * args.n;
      int w = carry_work + first_work, sl = carry_split + first_split;
      for (int s = 0; s < S; ++s) {
        const int j = k * S + s;
        const long long c = args.counts[j];
        args.seg[j] = entry;
        args.work[j] = w;
        args.slot[j] = c > args.part ? sl++ : -1;
        entry += c;
        w += c > args.part ? static_cast<int>((c + args.part - 1) / args.part) : 1;
      }
    }
    carry_work += total_work;
    carry_split += total_split;
  }
  if (threadIdx.x == 0) {
    args.work[args.n_pairs * S] = carry_work;
    *args.n_split = carry_split;
  }
}

// Bucket pass 3: each sample once into its slab's segment.  Grid (chunks,
// K), the count kernel's.  The block's range of each slab's segment comes
// from the plan; each sample's place in it from a shared-memory atomic (the
// samples of one slab in a warp take consecutive places, so the writes
// coalesce).  Also zeroes the accumulator slabs of the split slabs.
template <typename Idx, typename W, typename Acc>
__global__ void __launch_bounds__(kWideThreads) pair_hist_wide_scatter_kernel(const WideArgs args) {
  constexpr int U = kLanes<Idx>;
  using E = Entry<W, Acc>;
  __shared__ int local[kMaxSlabs];
  __shared__ long long slab_base[kMaxSlabs];
  const long long zero = static_cast<long long>(*args.n_split) * args.rows * args.nbins;
  const long long threads = static_cast<long long>(gridDim.x) * gridDim.y * kWideThreads;
  Acc* split = static_cast<Acc*>(args.split);
  for (long long j = (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kWideThreads + threadIdx.x;
       j < zero; j += threads)
    split[j] = Acc(0);
  const int k = blockIdx.y;
  const long long* first = args.block_first + static_cast<long long>(k) * args.slabs * args.n_chunks + blockIdx.x;
  for (int j = threadIdx.x; j < args.slabs; j += kWideThreads) {
    slab_base[j] = args.seg[k * args.slabs + j] + first[static_cast<long long>(j) * args.n_chunks];
    local[j] = 0;
  }
  __syncthreads();

  const PairCols<Idx> c = pair_cols<Idx>(args, k);
  const long long start = static_cast<long long>(blockIdx.x) * args.chunk;
  const long long stop = min(start + args.chunk, args.n);
  typename E::T* entries = static_cast<typename E::T*>(args.entries);
  for (long long i0 = start + static_cast<long long>(U) * threadIdx.x; i0 < stop;
       i0 += static_cast<long long>(U) * kWideThreads) {
    Lane<Idx, Acc> v;
    load_lane<true, Idx, W, Acc>(c, args.w, i0, stop, args.n, v);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int slab = slab_of(v.b[u], args);
      if (slab < 0) continue;
      const unsigned key = static_cast<unsigned>(v.a[u]) < static_cast<unsigned>(args.nbins)
                               ? static_cast<unsigned>((v.b[u] - slab * args.rows) * args.nbins + v.a[u])
                               : kDropped;
      entries[slab_base[slab] + atomicAdd(&local[slab], 1)] = E::make(key, v.w[u]);
    }
  }
}

// f32 rows of a tile to global memory, streaming past L2
template <typename Acc>
__device__ __forceinline__ void write_rows(const Acc* tile, float* dst, int count) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (count & 3) == 0) {
    using Vec4 = typename std::conditional<std::is_same<Acc, int>::value, int4, float4>::type;
    const Vec4* src = reinterpret_cast<const Vec4*>(tile);
    for (int j = threadIdx.x; j < count / 4; j += blockDim.x) {
      const Vec4 v = src[j];
      __stcs(reinterpret_cast<float4*>(dst) + j, make_float4(to_f32(v.x), to_f32(v.y), to_f32(v.z), to_f32(v.w)));
    }
  } else {
    for (int j = threadIdx.x; j < count; j += blockDim.x) __stcs(dst + j, to_f32(tile[j]));
  }
}

// Bucket pass 4: one block per part of a slab's segment (blocks past the
// plan's count return at once).  A slab of one part is owned: its block
// writes the slab's f32 rows.  The parts of a split slab flush into its
// accumulator slab; the last to finish writes the rows.
template <typename W, typename Acc>
__global__ void __launch_bounds__(kThreads, 1) pair_hist_wide_bin_kernel(const WideArgs args) {
  using E = Entry<W, Acc>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  Acc* tile = reinterpret_cast<Acc*>(smem_raw);
  const int ks = args.n_pairs * args.slabs;
  const int item = blockIdx.x;
  if (item >= args.work[ks]) return;
  int lo = 0, hi = ks - 1;  // the last slab whose first block is at or before this one
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (args.work[mid] <= item)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int j = lo, k = j / args.slabs, s = j - k * args.slabs;
  const int parts = args.work[j + 1] - args.work[j], part = item - args.work[j];
  const long long c = args.counts[j];
  const long long first = args.seg[j] + c * part / parts, end = args.seg[j] + c * (part + 1) / parts;
  const int row0 = s * args.rows;
  const int count = min(args.rows, args.nbins - row0) * args.nbins;
  for (int q = threadIdx.x; q < (count + 3) / 4; q += blockDim.x) reinterpret_cast<int4*>(tile)[q] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // the segment's 16-byte vectors (4 or 2 entries each), 4 in flight a
  // thread, and the entries before the first and after the last vector
  using T = typename E::T;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const T* entries = static_cast<const T*>(args.entries);
  const long long body = min(end, (first + V - 1) / V * V), body_end = max(body, end / V * V);
  if (threadIdx.x < body - first) E::add(tile, __ldcs(entries + first + threadIdx.x));
  if (threadIdx.x < end - body_end) E::add(tile, __ldcs(entries + body_end + threadIdx.x));
  const uint4* vec = reinterpret_cast<const uint4*>(entries + body);
  const long long n_vec = (body_end - body) / V;
  for (long long q = threadIdx.x; q < n_vec; q += 4LL * blockDim.x) {
    uint4 v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (q + static_cast<long long>(r) * blockDim.x < n_vec) v[r] = __ldcs(vec + q + r * blockDim.x);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (q + static_cast<long long>(r) * blockDim.x < n_vec) E::add(tile, v[r]);
  }
  __syncthreads();

  float* dst = static_cast<float*>(args.out) + static_cast<long long>(k) * args.nbins * args.nbins +
               static_cast<long long>(row0) * args.nbins;
  if (parts == 1) {
    write_rows(tile, dst, count);
    return;
  }
  // a split slab: flush the nonzero sums into its accumulator slab; the
  // last of its blocks to finish writes the rows
  Acc* acc = static_cast<Acc*>(args.split) + static_cast<long long>(args.slot[j]) * args.rows * args.nbins;
  for (int q = threadIdx.x; q < count; q += blockDim.x) {
    const Acc v = tile[q];
    if (v != Acc(0)) atomicAdd(&acc[q], v);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&args.done[j], 1) == parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the accumulator slab through the tile: 4 loads in flight a thread
  for (int q = threadIdx.x; q < count; q += 4 * blockDim.x) {
    Acc v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (q + r * static_cast<int>(blockDim.x) < count) v[r] = __ldcg(acc + q + r * blockDim.x);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (q + r * static_cast<int>(blockDim.x) < count) tile[q + r * blockDim.x] = v[r];
  }
  __syncthreads();
  write_rows(tile, dst, count);
}

// The direct route: one global atomic per sample into out, zeroed, as Acc.
// Grid (chunks, K).
template <typename Idx, typename W, typename Acc>
__global__ void __launch_bounds__(kWideThreads) pair_hist_wide_direct_kernel(const WideArgs args) {
  constexpr int U = kLanes<Idx>;
  const int k = blockIdx.y;
  const PairCols<Idx> c = pair_cols<Idx>(args, k);
  const long long start = static_cast<long long>(blockIdx.x) * args.chunk;
  const long long stop = min(start + args.chunk, args.n);
  Acc* acc = static_cast<Acc*>(args.out) + static_cast<long long>(k) * args.nbins * args.nbins;
  for (long long i0 = start + static_cast<long long>(U) * threadIdx.x; i0 < stop;
       i0 += static_cast<long long>(U) * kWideThreads) {
    Lane<Idx, Acc> v;
    load_lane<true, Idx, W, Acc>(c, args.w, i0, stop, args.n, v);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (static_cast<unsigned>(v.a[u]) < static_cast<unsigned>(args.nbins) &&
          static_cast<unsigned>(v.b[u]) < static_cast<unsigned>(args.nbins))
        atomicAdd(&acc[v.b[u] * args.nbins + v.a[u]], v.w[u]);
  }
}

__global__ void pair_hist_wide_convert_kernel(int* data, long long count) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long q = first; q < count / 4; q += stride) {
    const int4 v = reinterpret_cast<const int4*>(data)[q];
    reinterpret_cast<float4*>(data)[q] = make_float4(to_f32(v.x), to_f32(v.y), to_f32(v.z), to_f32(v.w));
  }
  for (long long q = count / 4 * 4 + first; q < count; q += stride)
    reinterpret_cast<float*>(data)[q] = to_f32(data[q]);
}

template <typename Idx, typename W, typename Acc>
cudaError_t launch_wide(const WideArgs& args, int route, int n_chunks, cudaStream_t stream) {
  const dim3 grid(n_chunks, args.n_pairs);
  const long long cells = static_cast<long long>(args.n_pairs) * args.nbins * args.nbins;
  cudaError_t err;
  if (route == 0) {  // direct
    err = cudaMemsetAsync(args.out, 0, cells * 4, stream);
    if (err != cudaSuccess) return err;
    pair_hist_wide_direct_kernel<Idx, W, Acc><<<grid, kWideThreads, 0, stream>>>(args);
    err = cudaGetLastError();
    if (err != cudaSuccess || !std::is_same<Acc, int>::value) return err;
    const int blocks = static_cast<int>(std::min((cells / 4 + 255) / 256 + 1, 4096LL));
    pair_hist_wide_convert_kernel<<<blocks, 256, 0, stream>>>(static_cast<int*>(args.out), cells);
    return cudaGetLastError();
  }
  const int ks = args.n_pairs * args.slabs;
  err = cudaMemsetAsync(args.done, 0, ks * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  pair_hist_wide_count_kernel<Idx><<<grid, kWideThreads, 0, stream>>>(args);
  pair_hist_wide_plan_kernel<<<1, kPlanThreads, 0, stream>>>(args);
  pair_hist_wide_scatter_kernel<Idx, W, Acc><<<grid, kWideThreads, 0, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* bin = pair_hist_wide_bin_kernel<W, Acc>;
  const int bytes = (args.rows * args.nbins + 3) / 4 * 16;
  err = cudaFuncSetAttribute(bin, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // a slab of c > part entries takes ceil(c / part) blocks: at most K * N / part more than one a slab
  const long long blocks = ks + static_cast<long long>(args.n_pairs) * args.n / args.part;
  bin<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t launch_wide_weights(const WideArgs& args, int weight_bytes, int integer_weights, int route, int n_chunks,
                                cudaStream_t stream) {
  if (weight_bytes == 1) return launch_wide<Idx, uint8_t, int>(args, route, n_chunks, stream);
  if (integer_weights) return launch_wide<Idx, float, int>(args, route, n_chunks, stream);
  return launch_wide<Idx, float, float>(args, route, n_chunks, stream);
}
}  // namespace

// ix (P, N) uint8, w (N,) 16-byte aligned: uint8 (integer weights) or f32
// (weight_bytes 1 / 4), pa/pb (K,) int32; or, with inv (K,) non-null, a
// K5 plan: pa (slots,) = grp_a, pb (slots / 8,) = grp_b, pair k the slot
// inv[k] (rows and slots clamped into range).  1 <= nbins <= 256.
// integer_weights (uint8 weights, or f32 ones rounded to int): int32 bins;
// else fixed point, wmax a device pointer to max |w| (f32).  n_split == 1:
// out (K, nbins, nbins) f32, every element written.  n_split > 1: each
// pair's samples split over n_split chunks, which add into an accumulator,
// zeroed: out itself (int32) with integer weights; else acc, (K, nbins,
// nbins) 8-byte words, which a second kernel then writes into out as f32.
extern "C" int pair_hist_uint8_launch(int device, const void* ix, int p, const void* w, int weight_bytes,
                                      const void* pa, const void* pb, const void* inv, int slots, long long n,
                                      int n_pairs, int nbins, int n_split, int integer_weights, const void* wmax,
                                      void* acc, void* out, void* stream) {
  if (p < 1 || (inv && slots < 1) || nbins < 1 || nbins > 256 || n_split < 1 || (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (weight_bytes == 1 && !integer_weights) || (weight_bytes != 1 && weight_bytes != 4) ||
      (!integer_weights && (!wmax || (n_split > 1 && !acc))))
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
  args.wmax = static_cast<const float*>(wmax);
  args.out = integer_weights || n_split == 1 ? out : acc;
  auto s = static_cast<cudaStream_t>(stream);
  if (weight_bytes == 1)
    return static_cast<int>(launch_uint8_bins<int, uint8_t>(args, n_pairs, n_split, s));
  if (integer_weights) return static_cast<int>(launch_uint8_bins<int, float>(args, n_pairs, n_split, s));
  err = launch_uint8_bins<Fixed, float>(args, n_pairs, n_split, s);
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(n_pairs) * nbins * nbins;
  const int blocks = static_cast<int>(std::min<long long>((count + 255) / 256, 4096));
  pair_hist_fixed_convert_kernel<<<blocks, 256, 0, s>>>(static_cast<const Fixed*>(acc), static_cast<float*>(out), count,
                                                        args.wmax, n);
  return static_cast<int>(cudaGetLastError());
}

// ix (P, N) int16 / int32 (index_bytes 2 / 4), w (N,) 16-byte aligned: uint8
// (integer weights) or f32 (weight_bytes 1 / 4), pa/pb (K,) int32 (rows
// clamped into [0, P)), 1 <= nbins <= 1024, rows * nbins <= 58000, at most
// 64 slabs.  out (K, nbins, nbins) f32, every element written.  route 0:
// direct; 1: bucket, with
// workspace (8 * K * S * (C + 1) + 4 * (4 * K * S + 2) bytes, C =
// n_chunks), entries (K * N entries of 4
// bytes with uint8 weights, else 8) and split (n_split_max accumulator
// slabs of rows * nbins 4-byte words; n_split_max >= min(K * S, K * N /
// part), the most slabs that can hold more than `part` entries).
// integer_weights: f32 weights rounded to int, int32 accumulation.
extern "C" int pair_hist_wide_launch(int device, const void* ix, int index_bytes, int p, const void* w,
                                     int weight_bytes, const void* pa, const void* pb, long long n, int n_pairs,
                                     int nbins, int route, int rows, int n_chunks, long long part,
                                     long long n_split_max, int integer_weights, void* out, void* workspace,
                                     void* entries, void* split, void* stream) {
  const int slabs = rows > 0 ? (nbins + rows - 1) / rows : 0;
  if (p < 1 || n < 1 || n_pairs < 1 || n_pairs > 65535 || nbins < 1 || nbins > 1024 || rows < 1 ||
      rows * nbins > kTileWords || slabs > kMaxSlabs || n_chunks < 1 || part < 1 || n_split_max < 0 ||
      route < 0 || route > 1 || (index_bytes != 2 && index_bytes != 4) ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 || (weight_bytes == 1 && !integer_weights) ||
      (weight_bytes != 1 && weight_bytes != 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  WideArgs args;
  args.ix = ix;
  args.w = w;
  args.pa = static_cast<const int*>(pa);
  args.pb = static_cast<const int*>(pb);
  args.p = p;
  args.n = n;
  args.chunk = ((n + n_chunks - 1) / n_chunks + 15) / 16 * 16;
  args.n_chunks = n_chunks;
  args.n_pairs = n_pairs;
  args.nbins = nbins;
  args.rows = rows;
  args.slabs = slabs;
  args.slab_magic = ((1ULL << 32) + rows - 1) / rows;
  args.part = part;
  args.out = out;
  const long long ks = static_cast<long long>(n_pairs) * slabs;
  args.seg = static_cast<long long*>(workspace);
  args.block_first = args.seg + ks;
  args.counts = reinterpret_cast<int*>(args.block_first + ks * n_chunks);
  args.done = args.counts + ks;
  args.work = args.done + ks;
  args.slot = args.work + ks + 1;
  args.n_split = args.slot + ks;
  args.entries = entries;
  args.split = split;
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 1 && (!workspace || !entries || (n_split_max > 0 && !split))) return cudaErrorInvalidValue;
  if (index_bytes == 2)
    err = launch_wide_weights<int16_t>(args, weight_bytes, integer_weights, route, n_chunks, s);
  else
    err = launch_wide_weights<int32_t>(args, weight_bytes, integer_weights, route, n_chunks, s);
  return static_cast<int>(err);
}

// Queues the copy of the pair indices pa, pb ((K,) int32 each) into host
// (pinned, 2 K int32) and records event after it, on the stream: a
// wrapper waits for the event after queueing its launch, so no readback
// sits in front of the launch.
extern "C" int pair_hist_readback(int device, const void* pa, const void* pb, int n_pairs, void* host, void* event,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(n_pairs) * sizeof(int);
  if ((err = cudaMemcpyAsync(host, pa, bytes, cudaMemcpyDeviceToHost, s)) != cudaSuccess ||
      (err = cudaMemcpyAsync(static_cast<int*>(host) + n_pairs, pb, bytes, cudaMemcpyDeviceToHost, s)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event), s));
}
