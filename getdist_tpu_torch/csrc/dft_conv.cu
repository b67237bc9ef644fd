// Batched 2D linear convolution as DFT matrix products, for Hopper (sm_90a).
//
// Replaces getdist_tpu/ops/dft_conv.py:155 dft_conv_spectrum (pallas_call at
// :164, _spec_kernel) and :190 dft_conv2d (pallas_call at :201,
// _conv_kernel).  F is the symmetric P x P DFT matrix and B = conj(F) / P is
// symmetric too.  For pair k, kernel W (m x m) and grid G (I x I), both real
// and at the origin of the P x P frame, with h = P / 2 + 1 and w = [offset,
// offset + out_size) the output window, the function is
//   U = F W F,  out = Re(B[w, :] ((F G F) o U) B[:, w]).
// Every stage contracts over the kernel's or grid's support, or over the
// frame only where the window needs it: nothing multiplies through the zero
// padding.  Real inputs make U and E = (F G F) o U Hermitian (X[P - r][P - c]
// = conj(X[r][c])), so rows 0..P/2 determine them; the rows of T2 = B[w, :] E
// are Hermitian too, so Re(T2 B[:, w]) needs only columns 0..P/2 of T2, the
// inner ones twice.
//
// What bounds it on this card.  The fastest f32-accurate product is three
// TF32 tensor-core passes (495 / 3 = 165 TFLOP/s); in f64 it is DMMA (67
// TFLOP/s).  Operations bound every f32 shape the paths run but the fused
// path's spectrum (435 x 61^2 at P = 384: 17.0 GFLOP against 0.51 GB of
// spectra written, bytes bound).  The bounded chain's rows: the clamped
// rescue's spectrum (110 x 253^2, P = 768) needs 76.7 GFLOP (0.465 ms), its
// 508-wide convolution 254 GFLOP (1.538 ms), the 316-wide ones at P = 384
// 203 GFLOP (1.232 ms).  The f64 shapes (parity's buckets, the meanlikes
// smoothing's): the spectrum bytes bound but at P = 768 (U written whole,
// 1.8 GB at parity's 435 x 69^2, P = 512), the convolution operations bound
// (parity's 435 x 256^2: 176 GFLOP, 2.630 ms).
//
// f32 (dft_wgmma_kernel): six stages, each a batched complex product
// D = A B whose A is the data and whose B is a block of F or B, run by one
// kernel template on wgmma (m64n64k8, tf32):
//   spectrum:  S1  T^T = W^T F[:m, :h], stored as T (h x m)   depth m
//              S2  U   = T F[:m, :], rows h.. mirrored       depth m
//   conv:      C1  T^T = G^T F[:I, :h], stored as T (h x I)   depth I
//              C2  E   = (T F[:I, :]) o U, stored as C3's operand:
//                      E[:, :h]^T with rows k and P - k paired  depth I
//              C3  T2^T = E[:, :h]^T B[:, w], columns 0 < c < P/2 doubled,
//                      stored as T2 (out_size x h)          depth 2 (P/2 + 1)
//              C4  out = Re(T2 B[:h, w])                      depth h
//  - wgmma takes tf32 operands K-major only.  The DFT blocks are K-major
//    by symmetry (B[k][n] = F[n][k]: row n of F), so they are the
//    shared-memory operand, loaded by TMA (128-byte swizzle) from tf32 hi
//    and lo planes split once per frame (ops/dft_conv.py:tf32_planes).  The
//    data is the register operand, read from shared memory in the layout
//    its stage left (row-major, or transposed for W^T and G^T) and split in
//    registers (hi = rna(x), lo = rna(x - hi)); products lo.hi + hi.lo +
//    hi.hi, lo.lo dropped (3xTF32, about f32 accuracy).
//  - S2 and C2 (kConj) multiply T by [Fr | Fi] of DFT columns c < P/2 only:
//    F[k][P - c] = conj(F[k][c]), so the four real products give columns c
//    and P - c, half the products of T F.  The real DFT columns 0 and P/2
//    share one slot (Fi's zero row 0 holds Fr's row P/2 in the planes), so
//    S1, C1, S2 and C2 tile P/2 columns, not P/2 + 1.  C3 (kSplit) pairs
//    E's rows k and P - k the same way (B[P - k][y] = conj(B[k][y])): C2
//    writes S = a + b and i D = i (a - b), and C3 multiplies [S | i D] by
//    the real [Br; Bi] over k <= P/2, half the products of E^T B.
//  - Data tiles arrive by cp.async (16-byte copies where base and leading
//    dimension allow, element copies otherwise: odd grid widths; the
//    wrapper pads the kernels' rows), zero-filled past the support, and
//    signal the same mbarrier as the stage's TMA loads.
//  - Warp specialised and persistent: one block per SM walks its output
//    tiles; a producer warpgroup (56 registers) keeps a ring of 3 or 4 stages full
//    while two consumer warpgroups (224 registers) each compute 64 rows of a
//    128-row tile.
//  - The tensor cores' f32 accumulation truncates (round toward zero).
//    Each two depth-8 steps sum into a partial started with scale-d = 0,
//    which an IEEE add brings into the tile's accumulator: 1.4-1.7e-6 of
//    the largest value from an f64 chain, a third of the plain f32 chain's
//    distance; partials of depth 8 reach 1.0-1.6e-6 and cost 5-8% more time,
//    of depth 32 2.3-2.7e-6, one truncating sum over the whole depth
//    1.5-2.4e-5, past the 1e-5 bar (tests/test_torch_dft_conv.py emulates
//    these; scripts/time_dft_conv_torch.py --depths measures them).
//  - The pairs' rows stack into one tall operand wherever B is shared (S2,
//    C2, C3, C4), so no tile is spent on a pair's ragged h rows; E keeps only
//    its h columns the next stage reads (h x P a pair, half of E).
//  - Epilogues through shared memory (32 KB, one output plane at a time),
//    so that every warp writes whole 128-byte lines, transposed stores
//    included; fused there: the Hermitian mirror (S2, C2), the product with
//    U (C2), the fold (C3), the real part (C4).
//  - Each output element is summed by one thread in one fixed order: no
//    split-K, no atomics, so two calls give bitwise-equal results.
// What bounds it now: not the tensor cores.  Built without its products
// (scripts/time_dft_conv_torch.py --no-products) K3 still takes 60% of its
// time at the bounded shapes, K2 at P = 768 64%: the operand copies, the
// register operand's split, the partials' drains and adds and the
// epilogues hold it (PERF.md section 6).

// f64 (dft_dmma_kernel): the same six stages and algebra (conjugate-pair columns in S2 and C2, the
// Nyquist column in column 0's Fi' slot, E kept only as C3's operand with its rows k and P - k paired),
// on DMMA (mma.sync.m16n8k8; wgmma has no f64), four stage kinds of one kernel template:
//   S1/C1  T^T = W^T [Fr | Fi'], stored as T (h x m)                 (kRealT, kStoreT)
//   S2     U = T [Fr | Fi'] -> columns c, P - c, rows h.. mirrored   (kConj, kHerm)
//   C2     E = (T [Fr | Fi']) o U, written as C3's operand [S | i D]: row c of E^T, S = E[k][c] +
//          E[P - k][c] at column k, i (E[k][c] - E[P - k][c]) at column h + k - 1 (0 < k < P/2),
//          h x P a pair                                              (kConj, kMulU)
//   C3     T2^T = [S | i D] Bsplit[w, :]^T, Bsplit's row r = [Br[r][0..P/2] | Bi[r][1..P/2 - 1]]
//          (B[P - k] = conj(B[k]); Bi's row 0 is zero, row P/2 too but for rounding), depth P,
//          folded and written as C4's real operand [Re T2 | -Im T2] (out_size x P a pair)
//                                                                    (kSplit, kFold)
//   C4     out = [Re T2 | -Im T2] Bsplit[w, :]^T, depth P            (kReal, kRe)
//  - The DFT blocks (Fr, Fi', Bsplit: ops/dft_conv.py:f64_planes) are K-major by symmetry and come by
//    TMA (128-byte swizzle, 16 values of depth a row); so do the row-major data tiles (T, C3's and C4's
//    operands, zero past their support).  The transposed ones (W^T, G^T) come by cp.async (element
//    copies for odd widths).  One producer warp keeps a ring of 3 stages of depth 16 full (mbarriers);
//    four consumer warps each compute 32 rows x 32 columns of B of a 64 x 64 tile.
//  - Persistent: min(tiles, blocks that fit) blocks (two an SM) walk the tiles of all pairs; 64-row
//    tiles give the 2- and 3-pair buckets at P = 768 156-228 tiles.
//  - Epilogues through a 32 x 33 block of shared memory a warp, so that each store instruction writes
//    runs of one output row (32 consecutive values, or 16 and their 16 partner columns), transposed
//    stores and the mirror rows included.
//  - Each output element is summed by one thread in one fixed order: two calls agree bitwise.
// What bounds it now (PERF.md section 6, NVIDIA H100 80GB HBM3): C3 and C4 run at 64-66% of the DMMA
// peak (parity's 435 x 256^2) and the K3 rows at 53-56% of their operations bound; what remains
// is the epilogues (C2 reads U and writes C3's operand, ~0.8 ms at parity's 435 x 256^2) and C1's row
// tiles (a 256- or 324-wide grid in 64-row tiles).  K2 is held by S2's stores: U is written whole
// (its mirror rows half of it) at ~2.3 TB/s, not overlapped with S2's short mainloop (depth m).

#include <cuda.h>  // CUtensorMap and its encoder's types; the encoder itself comes through cudaGetDriverEntryPoint
#include <cuda_runtime.h>

#include <cstdint>

#define RETURN_IF_ERROR(expr)             \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async ----

template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int src_bytes) {
  const unsigned s = smem_u32(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

// =====================================================================
// f32: wgmma, TMA and mbarriers
// =====================================================================

namespace f32 {

constexpr int kBM = 128;              // rows of a block tile: two consumer warpgroups of 64
constexpr int kBN = 64;               // columns of a block tile (each a complex pair of f32)
constexpr int kBK = 32;               // depth of a stage: one 128-byte swizzle row of f32
constexpr int kConsumers = 256;
constexpr int kProducers = 128;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kSAT = kBM + 8;         // transposed data tile: stride of a depth row (fragment reads free of bank conflicts)
constexpr int kTileB = kBN * kBK * 4;  // one plane of the DFT block: 64 rows of 128 bytes
constexpr int kBytesB = 4 * kTileB;   // re hi, re lo, im hi, im lo
constexpr int kBytesOut = kBM * kBN * 4;  // the epilogue's staging: one plane of the output tile
constexpr int kFullCount = kProducers + 1;  // the producer's cp.async arrivals and its TMA thread's expect_tx
constexpr int kAccSteps = 2;          // depth-8 steps summed into a partial between IEEE adds

// data operand: real and transposed (W^T, G^T), or complex and row-major;
// kConj: complex, against B = [Fr; Fi] of 32 DFT columns c, whose four real
// products give the columns c and P - c at once (F[k][P - c] = conj(F[k][c]));
// kSplit: complex A = [S | R] (two segments of depth `seg`) against the real
// B = [Br; Bi] of the window's 64 columns, Br's rows for S, Bi's for R
enum AMode { kRealT = 0, kCplx = 1, kConj = 2, kSplit = 3 };
enum Epi { kStoreT = 0, kHerm = 1, kMulU = 2, kFold = 3, kRe = 4 };

template <int kA>
__host__ __device__ constexpr int a_bytes() {
  return kA == kRealT ? kBK * kSAT * 4 : 2 * kBM * kBK * 4;
}
template <int kA>
__host__ __device__ constexpr int b_bytes() {
  return kA == kConj || kA == kSplit ? kBytesB / 2 : kBytesB;
}
// columns of a tile: output columns, or for kConj DFT columns (each two outputs)
template <int kA>
__host__ __device__ constexpr int tile_cols() {
  return kA == kConj ? kBN / 2 : kBN;
}
template <int kA>
__host__ __device__ constexpr int stage_bytes() {
  return (b_bytes<kA>() + a_bytes<kA>() + 1023) / 1024 * 1024;  // B tiles stay 1024-byte aligned (the swizzle's period)
}
// the ring's depth: as many stages as the 227 KB of shared memory hold beside the staging buffer
template <int kA>
__host__ __device__ constexpr int stages() {
  return kA == kConj || kA == kSplit ? 4 : 3;
}
template <int kA>
__host__ __device__ constexpr int smem_bytes() {
  return stages<kA>() * stage_bytes<kA>() + kBytesOut + 2 * stages<kA>() * 8 + 1024;  // ring, staging, barriers, alignment
}

// One stage D = A B and its epilogue.  A: data, element (i, k) at
// a_re/a_im[b * a_batch + i * lda + k] (kCplx, kConj, kSplit: the pairs
// stacked into the rows) or a_re[b * a_batch + k * lda + i] (kRealT), i < m,
// k < depth, zero outside.  B[k][n] = plane[b_plane + q][b_row0 + n][k], n <
// n_cols, the planes q as the producer loads them.  Output element (i, n) of
// batch b goes where the epilogue says (see store_tile).
struct Args {
  const float* a_re;
  const float* a_im;
  long long a_batch;
  int lda;
  int m;
  int depth;
  int a_vec;  // base, lda and a_batch allow 16-byte copies
  int n;
  int b_plane;
  int b_row0;
  int batch;
  int tiles_m;
  int tiles_n;
  float* o_re;
  float* o_im;
  long long o_batch;
  int o_ld;
  int rows_per_batch;  // stacked rows: row R is row R % rows_per_batch of pair R / rows_per_batch
  int pad;
  int seg;      // kSplit: the data's second segment starts at this column
  int seg_len;  // kSplit: the data columns of each segment (the rest of a segment is zero)
  int o_seg;    // kMulU: the output's second segment (i D) starts at this column
  const float* u_re;
  const float* u_im;
};

// ---- mbarriers and TMA ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// one arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma ----

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep a register that an asynchronous wgmma reads or writes where it is
// until this point (after the wait that ends the wgmma)
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// K-major operand in 128-byte-swizzled rows: start address, stride 1024
// bytes between groups of 8 rows, swizzle mode 1 (128 B)
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// d (64 x 64 f32, this thread's 32) (+)= s * a (64 x 8 tf32, registers) b (8 x 64 tf32, shared memory)
// scale_d = 0 starts a new sum; kNeg negates a
template <int kNeg>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kNeg ? -1 : 1));
}

// A fragment of a 64 x 8 tf32 register operand, split in two: a warp's 16
// rows, (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) with g = lane / 4,
// t = lane % 4
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void split4(Frag& f, float x0, float x1, float x2, float x3) {
  split_tf32(x0, f.hi[0], f.lo[0]);
  split_tf32(x1, f.hi[1], f.lo[1]);
  split_tf32(x2, f.hi[2], f.lo[2]);
  split_tf32(x3, f.hi[3], f.lo[3]);
}

__device__ __forceinline__ void keep(Frag& f) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    keep(f.hi[q]);
    keep(f.lo[q]);
  }
}

template <int N>
__device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q) keep(x[q]);
}

// element (r, c) of a row-major data tile of 32-float rows: its 16-byte chunk
// swizzled by the row, so that a fragment's 8 rows x 4 columns hit 32 banks
__device__ __forceinline__ int a_at(int r, int c) { return r * kBK + ((((c >> 2) ^ r) & 7) << 2) + (c & 3); }

// ---- the producer's data copies: rows [row0, row0 + 128) x depth [k0, k0 + 32) ----

template <int kA>
__device__ __forceinline__ void load_a(float* sa, const float* a_re, const float* a_im, const Args& p, int row0, int k0,
                                       int ptid) {
  if constexpr (kA != kRealT) {
    // sa[plane][row][32], the 16-byte chunk c of row r at c ^ (r % 8) (see a_at)
    if (p.a_vec) {
      constexpr int kChunks = kBK / 4;  // 16-byte chunks of a row
#pragma unroll 4
      for (int l = 0; l < 2 * kBM * kChunks / kProducers; ++l) {
        const int e = ptid + l * kProducers;
        const int plane = e / (kBM * kChunks);
        const int r = (e / kChunks) % kBM;
        const int c = (e % kChunks) * 4;
        const int gr = row0 + r;
        const int gc = k0 + c;
        const int kk = p.seg && gc >= p.seg ? gc - p.seg : gc;  // column within its segment
        const int lim = p.seg ? p.seg_len : p.depth;
        const bool in = gr < p.m && kk < lim;
        const float* src = plane ? a_im : a_re;
        cp_async_zfill<16>(sa + a_at(plane * kBM + r, c), in ? src + static_cast<long long>(gr) * p.lda + gc : src,
                           in ? min(4, lim - kk) * 4 : 0);
      }
    } else {
#pragma unroll 4
      for (int l = 0; l < 2 * kBM * kBK / kProducers; ++l) {
        const int e = ptid + l * kProducers;
        const int plane = e / (kBM * kBK);
        const int r = (e / kBK) % kBM;
        const int c = e % kBK;
        const int gr = row0 + r;
        const int gc = k0 + c;
        const bool in = gr < p.m && (p.seg && gc >= p.seg ? gc - p.seg : gc) < (p.seg ? p.seg_len : p.depth);
        const float* src = plane ? a_im : a_re;
        cp_async_zfill<4>(sa + a_at(plane * kBM + r, c), in ? src + static_cast<long long>(gr) * p.lda + gc : src,
                          in ? 4 : 0);
      }
    }
  } else {
    // sa[k][kSAT]: A[i][k] = a[k * lda + i], i contiguous
    if (p.a_vec) {
      constexpr int kChunks = kBM / 4;
#pragma unroll 4
      for (int l = 0; l < kBK * kChunks / kProducers; ++l) {
        const int e = ptid + l * kProducers;
        const int k = e / kChunks;
        const int i = (e % kChunks) * 4;
        const int gk = k0 + k;
        const int gi = row0 + i;
        const bool in = gk < p.depth && gi < p.m;
        cp_async_zfill<16>(sa + k * kSAT + i, in ? a_re + static_cast<long long>(gk) * p.lda + gi : a_re,
                           in ? min(4, p.m - gi) * 4 : 0);
      }
    } else {
#pragma unroll 4
      for (int l = 0; l < kBK * kBM / kProducers; ++l) {
        const int e = ptid + l * kProducers;
        const int k = e / kBM;
        const int i = e % kBM;
        const int gk = k0 + k;
        const int gi = row0 + i;
        const bool in = gk < p.depth && gi < p.m;
        cp_async_zfill<4>(sa + k * kSAT + i, in ? a_re + static_cast<long long>(gk) * p.lda + gi : a_re, in ? 4 : 0);
      }
    }
  }
}

// ---- the consumers' fragments: rows rb.. of the tile, depth 8 kk.. of the stage ----

template <int kA>
__device__ __forceinline__ void load_frags(Frag (&f)[2], const float* sa, int rb, int kk, int g, int t) {
  if constexpr (kA != kRealT) {
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const int r = plane * kBM + rb + g;
      const int c = 8 * kk + t;
      split4(f[plane], sa[a_at(r, c)], sa[a_at(r + 8, c)], sa[a_at(r, c + 4)], sa[a_at(r + 8, c + 4)]);
    }
  } else {
    const float* s = sa + (8 * kk + t) * kSAT + rb + g;
    split4(f[0], s[0], s[8], s[4 * kSAT], s[4 * kSAT + 8]);
  }
}

// ---- epilogue ----
// Each output plane (re, then im) of the 128 x 64 tile goes through shared
// memory, so that each warp writes whole 128-byte lines of the output:
// staged by rows where the output runs along the tile's columns (kHerm,
// kRe), by columns where it runs along its rows (the transposed stores).
// kStoreT: out[b][n][i] (T from T^T)
// kHerm (after kConj): U[pair][r][n] for n in {c, P - c} (c = 0: {0, P/2})
//          and, for 0 < r < P/2, U[pair][P - r][(P - n) % P] = conj
// kMulU (after kConj): E = D o U[pair][r][n], n as for kHerm; E^T[pair][n][r]
//          for n < h and, for 0 < r < P/2 and n in {0} u [P/2, P),
//          E^T[pair][(P - n) % P][P - r] = conj
// kFold:   T2[pair][n][c] = D (c = the stacked row's index in its pair),
//          doubled for 0 < c < P/2
// kRe:     out[row][n] = Re D

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// element (r, c) of a staged plane, swizzled so that the fragments' stores
// and the write-out's loads are free of bank conflicts
template <bool kCol>
__device__ __forceinline__ int out_at(int r, int c) {
  if constexpr (kCol) return c * kBM + (r ^ (((c >> 1) & 3) << 3));
  return r * kBN + (c ^ ((r & 7) << 3));
}

template <int kEpi>
__device__ __forceinline__ void store_tile(const Args& p, float (&dr)[32], float (&di)[32], int b, int row0, int col0,
                                           int rb, int g, int t, float* stage, int tid) {
  constexpr bool kImOut = kEpi != kRe;
  constexpr bool kCol = kEpi == kStoreT || kEpi == kMulU || kEpi == kFold;
  constexpr bool kPairs = kEpi == kHerm || kEpi == kMulU;  // after kConj: tile column q < 32 is DFT column c0 + q,
                                                           // q >= 32 is P - (c0 + q - 32)
  const int h = p.rows_per_batch;
  if constexpr (kPairs) {
    // dr = [Tr Fr | Tr Fi], di = [Ti Fr | Ti Fi] over the tile's DFT columns c:
    // D[c] = (TrFr - TiFi) + i (TrFi + TiFr), D[P - c] = (TrFr + TiFi) + i (TiFr - TrFi).
    // Column 0's Fi (zero) slot carries Fr of column P/2 (tf32_planes): D[0] = TrFr + i TiFr
    // there, D[P/2] = Tr Fr[P/2] + i Ti Fr[P/2] takes the place of D[P - 0]
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float a1 = dr[q], a3 = dr[16 + q], a4 = di[q], a2 = di[16 + q];
      const bool nyquist = col0 == 0 && t == 0 && (q == 0 || q == 2);  // DFT column 0 (j = 0, e = 0)
      dr[q] = nyquist ? a1 : a1 - a2;
      di[q] = nyquist ? a4 : a3 + a4;
      dr[16 + q] = nyquist ? a3 : a1 + a2;
      di[16 + q] = nyquist ? a2 : a4 - a3;
    }
  }
  if constexpr (kEpi == kStoreT) {
    // column 0's imaginary part is Tr Fr[P/2], the (real) DFT column P/2: written
    // straight to its row of T, and column 0's own imaginary part is zero
    if (col0 == 0 && t == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = row0 + rb + g + 8 * h2;
        if (row < p.m) {
          const long long at = b * p.o_batch + static_cast<long long>(p.pad / 2) * p.o_ld + row;
          p.o_re[at] = di[2 * h2];
          p.o_im[at] = 0.f;
        }
        di[2 * h2] = 0.f;
      }
    }
  }
  if constexpr (kEpi == kMulU) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row0 + rb + g + 8 * h2;
      if (row >= p.m) continue;
      const long long item = row / h;
      const long long u0 = item * p.pad * p.pad + static_cast<long long>(row - item * h) * p.pad;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + 8 * j + 2 * t;
        if (c >= p.n) continue;
        const float2 xr = *reinterpret_cast<const float2*>(p.u_re + u0 + c);  // c + 1 < P
        const float2 xi = *reinterpret_cast<const float2*>(p.u_im + u0 + c);
        const int mc = c ? p.pad - c : p.pad / 2;  // the column of D[16 + q]
        const float ur[4] = {xr.x, xr.y, p.u_re[u0 + mc], p.u_re[u0 + p.pad - c - 1]};
        const float ui[4] = {xi.x, xi.y, p.u_im[u0 + mc], p.u_im[u0 + p.pad - c - 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 4 * j + 2 * h2 + (e & 1) + (e >> 1) * 16;
          const float er = dr[q] * ur[e] - di[q] * ui[e];
          di[q] = dr[q] * ui[e] + di[q] * ur[e];
          dr[q] = er;
        }
      }
    }
  }
#pragma unroll
  for (int plane = 0; plane < (kImOut ? 2 : 1); ++plane) {
    const float(&d)[32] = plane ? di : dr;
    const float sign = plane ? -1.f : 1.f;  // of a conjugate mirror
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = rb + g + 8 * h2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        if constexpr (kCol) {
          stage[out_at<true>(r, c)] = d[4 * j + 2 * h2];
          stage[out_at<true>(r, c + 1)] = d[4 * j + 2 * h2 + 1];
        } else {
          *reinterpret_cast<float2*>(stage + out_at<false>(r, c)) = make_float2(d[4 * j + 2 * h2], d[4 * j + 2 * h2 + 1]);
        }
      }
    }
    consumer_sync();
    float* o = plane ? p.o_im : p.o_re;
    if constexpr (kCol) {
      // a thread's row is fixed, its columns step by 2; a warp writes 32 consecutive rows of one column
      const int r = tid & (kBM - 1);
      const int row = row0 + r;
      if (row < p.m) {
        long long item = b;
        int rr = row;
        if constexpr (kEpi != kStoreT) {
          item = row / h;
          rr = row - static_cast<int>(item) * h;
        }
        float* ob = o + item * p.o_batch;
        const bool mirror_row = rr > 0 && 2 * rr < p.pad;
        const float fold = kEpi == kFold && mirror_row ? 2.f : 1.f;  // exact
        if constexpr (kEpi != kMulU) {
#pragma unroll 4
          for (int l = 0; l < kBN / 2; ++l) {
            const int n = col0 + (tid >> 7) + 2 * l;
            if (n >= p.n) break;
            ob[static_cast<long long>(n) * p.o_ld + rr] = fold * stage[out_at<true>(r, n - col0)];
          }
        } else {
          // C3 needs sum_k E[k][c] B[k][y]; B[P - k][y] = conj(B[k][y]) pairs row k of E with row
          // P - k: S B_r + i D B_i, S = a + b, D = a - b (a = E[k][c], b = E[P - k][c] =
          // conj(E[k][P - c]), 0 < k < P/2; S = a, D = 0 at k = 0, P/2).  Written as [S | i D]
          // (row c, columns k and seg + k).  This plane's part: re: S_r = a_r + b_r and
          // (i D)_i = a_r - b_r; im: S_i = a_i + b_i and (i D)_r = -(a_i - b_i), with b = conj(E[k][P - c])
          float* out_s = plane ? p.o_im : p.o_re;
          float* out_r = plane ? p.o_re : p.o_im;
          const long long base = item * p.o_batch + rr;
          auto write_pair = [&](int c, float e1, float e2) {
            const long long at = base + static_cast<long long>(c) * p.o_ld;
            const float b = plane ? -e2 : e2;  // conj
            out_s[at] = mirror_row ? e1 + b : e1;
            out_r[at + p.o_seg] = mirror_row ? (plane ? b - e1 : e1 - b) : 0.f;
          };
#pragma unroll 4
          for (int l = 0; l < kBN / 4; ++l) {
            const int q = (tid >> 7) + 2 * l;  // DFT column col0 + q; its partner P - (col0 + q) in slot q + 32
            const int c = col0 + q;
            if (c >= p.n) break;
            const float e1 = stage[out_at<true>(r, q)];
            write_pair(c, e1, c ? stage[out_at<true>(r, q + 32)] : e1);
          }
          if (col0 == 0 && (tid >> 7) == 0) {
            const float e = stage[out_at<true>(r, 32)];  // DFT column P/2, in column 0's second slot
            write_pair(p.pad / 2, e, e);
          }
        }
      }
    } else {
      // a thread's column is fixed, its rows step by 4; a warp writes 32 consecutive columns of one row
      const int c = tid & (kBN - 1);
      int n = col0 + c;
      bool valid = n < p.n;
      if constexpr (kPairs) {
        const int cq = col0 + (c & 31);
        n = c < 32 ? cq : cq ? p.pad - cq : p.pad / 2;
        valid = cq < p.n;
      }
      int r = tid >> 6;
      int row = row0 + r;
      long long item = 0;
      int rr = row;
      if constexpr (kEpi == kHerm) {
        item = row / h;
        rr = row - static_cast<int>(item) * h;
      }
      if (valid) {
#pragma unroll 4
        for (int l = 0; l < kBM / 4; ++l, r += 4, row += 4) {
          if (row >= p.m) break;
          const float v = stage[out_at<false>(r, c)];
          if constexpr (kEpi == kHerm) {
            float* ob = o + item * p.o_batch;
            ob[static_cast<long long>(rr) * p.o_ld + n] = v;
            if (rr > 0 && 2 * rr < p.pad) ob[static_cast<long long>(p.pad - rr) * p.o_ld + (n ? p.pad - n : 0)] = sign * v;
            rr += 4;
            if (rr >= h) {
              rr -= h;
              ++item;
            }
          } else {
            o[static_cast<long long>(row) * p.o_ld + n] = v;
          }
        }
      }
    }
    consumer_sync();
  }
}

template <int kA, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    dft_wgmma_kernel(const __grid_constant__ CUtensorMap planes, const Args p) {
  constexpr bool kImOut = kEpi != kRe;
  constexpr int kStage = stage_bytes<kA>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kStages = stages<kA>();
  float* stage = reinterpret_cast<float*>(smem + kStages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage + kBytesOut);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kFullCount);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_per_batch = p.tiles_m * p.tiles_n;
  const int total = p.batch * tiles_per_batch;
  const int nk = (p.depth + kBK - 1) / kBK;
  const int nsteps = (p.depth + 7) / 8;

  if (tid >= kConsumers) {
    // producer warpgroup: the ring's data copies (every thread) and DFT-block TMA loads (one thread)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int ptid = tid - kConsumers;
    int it = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int b = tile / tiles_per_batch;
      const int rest = tile - b * tiles_per_batch;
      const int row0 = (rest / p.tiles_n) * kBM;
      const int col0 = (rest % p.tiles_n) * tile_cols<kA>();
      const float* a_re = p.a_re + b * p.a_batch;
      const float* a_im = kA != kRealT ? p.a_im + b * p.a_batch : nullptr;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int slot = it % kStages;
        mbar_wait(&empty[slot], ((it / kStages) & 1) ^ 1);
        unsigned char* st = smem + slot * kStage;
        if (ptid == 0 && kA == kSplit) {
          // [Br or Bi] hi then lo: Br's rows for S's columns, Bi's for R's
          const bool second = kt * kBK >= p.seg;
          mbar_expect_tx(&full[slot], b_bytes<kA>());
          for (int q = 0; q < 2; ++q)
            tma_load(st + q * kTileB, &planes, &full[slot], kt * kBK - (second ? p.seg : 0), p.b_row0 + col0,
                     p.b_plane + 2 * second + q);
        } else if (ptid == 0) {
          mbar_expect_tx(&full[slot], b_bytes<kA>());
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // kConj: [Fr hi; Fi' hi] then [Fr lo; Fi' lo], 32 rows each plane; kRealT: Fr hi, Fr lo,
            // Fi' hi, Fi' lo (Fi': Fi with Fr's row P/2 in its row 0, the Nyquist column's place)
            const int plane = kA == kConj ? (q >> 1) + 8 * (q & 1) : kA == kRealT && q >= 2 ? 6 + q : q;
            tma_load(st + q * (b_bytes<kA>() / 4), &planes, &full[slot], kt * kBK, p.b_row0 + col0, p.b_plane + plane);
          }
        }
        load_a<kA>(reinterpret_cast<float*>(st + b_bytes<kA>()), a_re, a_im, p, row0, kt * kBK, ptid);
        cp_async_arrive(&full[slot]);
      }
    }
  } else {
    // consumer warpgroups: 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int rb = wg * 64 + ((tid >> 5) & 3) * 16;
    float acc_r[32], acc_i[32], part_r[32], part_i[32];
    Frag fa[2][2];  // [buffer][re, im]: the register operand of two depth-8 steps in flight
    int it = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int b = tile / tiles_per_batch;
      const int rest = tile - b * tiles_per_batch;
      const int row0 = (rest / p.tiles_n) * kBM;
      const int col0 = (rest % p.tiles_n) * tile_cols<kA>();
#pragma unroll
      for (int q = 0; q < 32; ++q) acc_r[q] = acc_i[q] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int slot = it % kStages;
        mbar_wait(&full[slot], (it / kStages) & 1);
        const unsigned char* st = smem + slot * kStage;
        const uint64_t d_rh = desc_sw128(st);  // kConj, kSplit: the stage's real block, hi
        const uint64_t d_rl = desc_sw128(st + kTileB);  // and lo
        const uint64_t d_ih = desc_sw128(st + 2 * kTileB);
        const uint64_t d_il = desc_sw128(st + 3 * kTileB);
        const float* sa = reinterpret_cast<const float*>(st + b_bytes<kA>());
        const int steps = min(kBK / 8, (p.depth - kt * kBK + 7) / 8);
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          if (kk < steps) {
            Frag(&f)[2] = fa[kk & 1];
            if (kk >= 2) {
              wg_wait<1>();  // the group that read this buffer (step kk - 2) is done
              keep(f[0]);
              keep(f[1]);
            }
            load_frags<kA>(f, sa, rb, kk, g, t);
            const int step = kt * (kBK / 8) + kk;  // of the tile's depth
            const int z = step % kAccSteps != 0;   // a partial's first products start its sums
            const uint64_t o = 2 * kk;  // 32 bytes of depth a step, inside the swizzled row
            wg_fence();
            if constexpr (kA == kConj || kA == kSplit) {
              // kConj: part_r = [Tr Fr | Tr Fi], part_i = [Ti Fr | Ti Fi]; kSplit: part = [S | R] B
              wgmma_tf32<0>(part_r, f[0].lo, d_rh + o, z);
              wgmma_tf32<0>(part_i, f[1].lo, d_rh + o, z);
              wgmma_tf32<0>(part_r, f[0].hi, d_rl + o, 1);
              wgmma_tf32<0>(part_i, f[1].hi, d_rl + o, 1);
              wgmma_tf32<0>(part_r, f[0].hi, d_rh + o, 1);
              wgmma_tf32<0>(part_i, f[1].hi, d_rh + o, 1);
            } else if constexpr (kA == kRealT) {
              wgmma_tf32<0>(part_r, f[0].lo, d_rh + o, z);
              wgmma_tf32<0>(part_i, f[0].lo, d_ih + o, z);
              wgmma_tf32<0>(part_r, f[0].hi, d_rl + o, 1);
              wgmma_tf32<0>(part_i, f[0].hi, d_il + o, 1);
              wgmma_tf32<0>(part_r, f[0].hi, d_rh + o, 1);
              wgmma_tf32<0>(part_i, f[0].hi, d_ih + o, 1);
            } else {
              // re += ar br - ai bi, im += ar bi + ai br; the small terms first
              wgmma_tf32<0>(part_r, f[0].lo, d_rh + o, z);
              if constexpr (kImOut) wgmma_tf32<0>(part_i, f[0].lo, d_ih + o, z);
              wgmma_tf32<0>(part_r, f[0].hi, d_rl + o, 1);
              if constexpr (kImOut) wgmma_tf32<0>(part_i, f[0].hi, d_il + o, 1);
              wgmma_tf32<1>(part_r, f[1].lo, d_ih + o, 1);
              if constexpr (kImOut) wgmma_tf32<0>(part_i, f[1].lo, d_rh + o, 1);
              wgmma_tf32<1>(part_r, f[1].hi, d_il + o, 1);
              if constexpr (kImOut) wgmma_tf32<0>(part_i, f[1].hi, d_rl + o, 1);
              wgmma_tf32<0>(part_r, f[0].hi, d_rh + o, 1);
              if constexpr (kImOut) wgmma_tf32<0>(part_i, f[0].hi, d_ih + o, 1);
              wgmma_tf32<1>(part_r, f[1].hi, d_ih + o, 1);
              if constexpr (kImOut) wgmma_tf32<0>(part_i, f[1].hi, d_rh + o, 1);
            }
            wg_commit();
            if ((step + 1) % kAccSteps == 0 || step + 1 == nsteps) {
              // the partial sums (truncating tensor-core adds) into the tile's, rounded to nearest
              wg_wait<0>();
              keep(part_r);
              if constexpr (kImOut) keep(part_i);
#pragma unroll
              for (int q = 0; q < 32; ++q) {
                acc_r[q] += part_r[q];
                if constexpr (kImOut) acc_i[q] += part_i[q];
              }
            }
          }
        }
        wg_wait<0>();  // no product reads the slot any more
        keep(fa[0][0]);
        keep(fa[0][1]);
        keep(fa[1][0]);
        keep(fa[1][1]);
        mbar_arrive(&empty[slot]);
      }
      store_tile<kEpi>(p, acc_r, acc_i, b, row0, col0, rb, g, t, stage, tid);
    }
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// the tf32 planes (10, P, P): Fr hi, lo, Fi hi, lo, Br hi, lo, Bi hi, lo, Fi' hi, lo (Fi with
// row 0 replaced by Fr's row P/2); tiles of `rows` rows x 32 values
cudaError_t plane_map(CUtensorMap* map, const void* planes, int pad, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(pad), static_cast<cuuint64_t>(pad), 10};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pad) * 4, static_cast<cuuint64_t>(pad) * pad * 4};
  const cuuint32_t box[3] = {kBK, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(planes), dims, strides, box,
                            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// columns 0..P/2 of C3's operand segments, rounded up to whole stages
int split_seg(int pad) { return (pad / 2 + 1 + kBK - 1) / kBK * kBK; }

Args data(const float* re, const float* im, long long batch_stride, int ld, int m, int depth, int pad) {
  Args a{};
  a.pad = pad;
  a.a_re = re;
  a.a_im = im;
  a.a_batch = batch_stride;
  a.lda = ld;
  a.m = m;
  a.depth = depth;
  a.a_vec = aligned16(re) && (im == nullptr || aligned16(im)) && ld % 4 == 0 && batch_stride % 4 == 0;
  a.batch = 1;
  return a;
}

void dft_block(Args& a, int n, int plane, int row0) {
  a.n = n;
  a.b_plane = plane;
  a.b_row0 = row0;
}

void out_to(Args& a, float* re, float* im, long long batch_stride, int ld) {
  a.o_re = re;
  a.o_im = im;
  a.o_batch = batch_stride;
  a.o_ld = ld;
}

template <int kA, int kEpi>
cudaError_t run(const void* planes, Args a, int device, cudaStream_t s) {
  if (a.batch == 0 || a.m == 0 || a.n == 0) return cudaSuccess;
  a.tiles_m = (a.m + kBM - 1) / kBM;
  a.tiles_n = (a.n + tile_cols<kA>() - 1) / tile_cols<kA>();
  const long long tiles = static_cast<long long>(a.batch) * a.tiles_m * a.tiles_n;
  if (tiles > (1LL << 31) - 1) return cudaErrorInvalidValue;
  // per device, once: the SM count and the kernel's shared-memory attribute
  static int sms[64] = {};
  static unsigned long long attribute_set = 0;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sms[device] == 0) RETURN_IF_ERROR(cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device));
  CUtensorMap map;
  RETURN_IF_ERROR(plane_map(&map, planes, a.pad, tile_cols<kA>()));
  const auto kernel = dft_wgmma_kernel<kA, kEpi>;
  constexpr int bytes = smem_bytes<kA>();
  if (!(attribute_set >> device & 1)) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    attribute_set |= 1ULL << device;
  }
  const int grid = static_cast<int>(tiles < sms[device] ? tiles : sms[device]);
  kernel<<<grid, kThreads, bytes, s>>>(map, a);
  return cudaGetLastError();
}

cudaError_t spectrum(const float* kernels, int n_pairs, int m, int k_ld, const void* planes, float* tr, float* ti,
                     int t_ld, float* ur, float* ui, int pad, int device, cudaStream_t s) {
  const int half = pad / 2 + 1;  // U of a real kernel is Hermitian: rows 0..P/2 determine it
  // S1: T^T = W^T F[:m, :h], stored as T (h x m) a pair (columns 0..P/2 - 1, P/2 in column 0's
  // imaginary place); W's rows k_ld apart
  Args s1 = data(kernels, nullptr, static_cast<long long>(m) * k_ld, k_ld, m, m, pad);
  s1.batch = n_pairs;
  dft_block(s1, pad / 2, 0, 0);
  out_to(s1, tr, ti, static_cast<long long>(half) * t_ld, t_ld);
  RETURN_IF_ERROR((run<kRealT, kStoreT>(planes, s1, device, s)));
  // S2: U = T F[:m, :] over DFT columns 0..P/2 - 1 (each gives c and P - c; column 0 also P/2),
  // the pairs' T stacked into one (K h) x m operand; rows h.. as the mirror
  Args s2 = data(tr, ti, 0, t_ld, n_pairs * half, m, pad);
  dft_block(s2, pad / 2, 0, 0);
  out_to(s2, ur, ui, static_cast<long long>(pad) * pad, pad);
  s2.rows_per_batch = half;
  return run<kConj, kHerm>(planes, s2, device, s);
}

cudaError_t conv(const float* grids, int n_pairs, int in_size, const void* planes, const float* ur, const float* ui,
                 float* tr, float* ti, int t_ld, float* er, float* ei, float* t2r, float* t2i, int t2_ld, float* out,
                 int out_size, int offset, int pad, int device, cudaStream_t s) {
  const int half = pad / 2 + 1;
  // C1: T^T = G^T F[:I, :h], stored as T (h x I) a pair (as S1)
  Args c1 = data(grids, nullptr, static_cast<long long>(in_size) * in_size, in_size, in_size, in_size, pad);
  c1.batch = n_pairs;
  dft_block(c1, pad / 2, 0, 0);
  out_to(c1, tr, ti, static_cast<long long>(half) * t_ld, t_ld);
  RETURN_IF_ERROR((run<kRealT, kStoreT>(planes, c1, device, s)));
  const int seg = split_seg(pad);
  // C2: E = (T F[:I, :]) o U over the stacked T, DFT columns as S2's; written as
  // C3's operand [S | i D] (h x 2 seg a pair, rows c of E^T with rows k and P - k paired)
  Args c2 = data(tr, ti, 0, t_ld, n_pairs * half, in_size, pad);
  dft_block(c2, pad / 2, 0, 0);
  out_to(c2, er, ei, static_cast<long long>(half) * 2 * seg, 2 * seg);
  c2.rows_per_batch = half;
  c2.o_seg = seg;
  c2.u_re = ur;
  c2.u_im = ui;
  RETURN_IF_ERROR((run<kConj, kMulU>(planes, c2, device, s)));
  // C3: T2^T = E[:, :h]^T B[:, w] = S B_r[:h, w] + (i D) B_i[:h, w] (B[k][w0 + x] =
  // B[w0 + x][k]), depth 2 seg; E Hermitian makes each row of T2 Hermitian, so
  // Re(T2 B[:, w]) sums columns 0 and P/2 once and the columns between twice,
  // which the epilogue doubles; stored as T2
  Args c3 = data(er, ei, 0, 2 * seg, n_pairs * half, 2 * seg, pad);
  c3.seg = seg;
  c3.seg_len = half;
  dft_block(c3, out_size, 4, offset);
  out_to(c3, t2r, t2i, static_cast<long long>(out_size) * t2_ld, t2_ld);
  c3.rows_per_batch = half;
  RETURN_IF_ERROR((run<kSplit, kFold>(planes, c3, device, s)));
  // C4: out[x][y] = Re(sum_c T2[x][c] B[c][w0 + y]), c = 0..P/2, the pairs' T2 stacked
  Args c4 = data(t2r, t2i, 0, t2_ld, n_pairs * out_size, half, pad);
  dft_block(c4, out_size, 4, offset);
  out_to(c4, out, nullptr, 0, out_size);
  return run<kCplx, kRe>(planes, c4, device, s);
}

}  // namespace f32

// =====================================================================
// f64: DMMA (mma.sync), TMA and mbarriers
// =====================================================================

namespace f64 {

constexpr int kMmaK = 8;        // depth of one mma.sync.m16n8k8
constexpr int kBM = 64;         // rows of a block tile: two consumer warps of 32
constexpr int kBN = 64;         // columns of B a block tile: two consumer warps of 32
constexpr int kBK = 16;         // depth of a stage: one 128-byte swizzle row of f64
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // four consumer warps and one producer warp
constexpr int kStages = 3;
constexpr int kSAT = kBM + 4;   // transposed data tile: stride of a depth row
constexpr int kBoxRows = 32;    // rows of a TMA box of the DFT planes
constexpr int kTileB = kBN * kBK * 8;  // the stage's DFT block: 64 rows of 128 bytes
constexpr int kTileA = kBM * kBK * 8;  // a plane of a row-major data tile: 64 rows of 128 bytes
constexpr int kSO = 33;                // a warp's epilogue staging: 32 rows of 32 values, stride 33
constexpr int kStaging = 4 * 32 * kSO * 8;  // four warps' staging

// data operand: real and transposed (W^T, G^T); real and row-major (C4's [T2r | -T2i]); complex
// against [Fr | Fi'] of 32 DFT columns c, whose four real products give the columns c and P - c
// (kConj); complex against rows of the real Bsplit (kSplit)
enum AMode { kRealT = 0, kReal = 1, kConj = 2, kSplit = 3 };
enum Epi { kStoreT = 0, kHerm = 1, kMulU = 2, kFold = 3, kRe = 4 };

template <int kA>
__host__ __device__ constexpr int n_planes() {
  return kA == kConj || kA == kSplit ? 2 : 1;
}
template <int kA>
__host__ __device__ constexpr int a_bytes() {
  return kA == kRealT ? kBK * kSAT * 8 : n_planes<kA>() * kTileA;
}
// arrivals that fill a stage: the producer's expect_tx, and with cp.async data (kRealT) each lane's copies
template <int kA>
__host__ __device__ constexpr int full_count() {
  return kA == kRealT ? 32 + 1 : 1;
}
// columns of a tile: output columns, or for kConj and kRealT DFT columns (a Fr and an Fi' row of B each)
template <int kA>
__host__ __device__ constexpr int tile_cols() {
  return kA == kConj || kA == kRealT ? kBN / 2 : kBN;
}
template <int kA>
__host__ __device__ constexpr int stage_bytes() {
  return (kTileB + a_bytes<kA>() + 1023) / 1024 * 1024;  // DFT blocks stay 1024-byte aligned (the swizzle's period)
}
template <int kA>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<kA>() + kStaging + 2 * kStages * 8 + 1024;  // ring, staging, barriers, alignment
}

// One stage D = A B and its epilogue.  A: data, element (i, k) at a_re/a_im[b * a_batch + i * lda +
// k] (row-major; kConj, kSplit, kReal: the pairs stacked into the rows) or a_re[b * a_batch + k * lda
// + i] (kRealT), i < m, k < depth, zero outside.  B[k][n] = plane[q][b_row0 + n][k]: kConj and
// kRealT, planes 0 (Fr) and 1 (Fi') of 32 DFT columns each; kSplit and kReal, plane b_plane.
struct Args {
  const double* a_re;
  const double* a_im;
  long long a_batch;
  int lda;
  int m;
  int depth;
  int a_vec;  // base, lda and a_batch allow 16-byte copies
  int n;
  int b_plane;
  int b_row0;
  int batch;
  int tiles_m;
  int tiles_n;
  double* o_re;
  double* o_im;
  long long o_batch;
  int o_ld;
  int pad;  // the frame P; stacked rows (kConj, kSplit): row R is row R % (P / 2 + 1) of pair R / (P / 2 + 1)
  const double* u_re;
  const double* u_im;
};

// ---- the producer's copies of a transposed data tile (W^T, G^T): rows [row0, row0 + 64) x depth [k0, k0
// + 16), sa[k][kSAT] with A[i][k] = a[k * lda + i] (i contiguous; odd widths by element).  Row-major data
// tiles come by TMA, as the DFT blocks do ----

__device__ __forceinline__ void load_at(double* sa, const double* a, const Args& p, int row0, int k0, int lane) {
  if (p.a_vec) {
    constexpr int kChunks = kBM / 2;
#pragma unroll 4
    for (int l = 0; l < kBK * kChunks / 32; ++l) {
      const int e = lane + 32 * l;
      const int k = e / kChunks;
      const int i = (e % kChunks) * 2;
      const int gk = k0 + k;
      const int gi = row0 + i;
      const bool in = gk < p.depth && gi < p.m;
      cp_async_zfill<16>(sa + k * kSAT + i, in ? a + static_cast<long long>(gk) * p.lda + gi : a,
                         in ? min(2, p.m - gi) * 8 : 0);
    }
  } else {
#pragma unroll 4
    for (int l = 0; l < kBK * kBM / 32; ++l) {
      const int e = lane + 32 * l;
      const int k = e / kBM;
      const int i = e % kBM;
      const int gk = k0 + k;
      const int gi = row0 + i;
      const bool in = gk < p.depth && gi < p.m;
      cp_async_zfill<8>(sa + k * kSAT + i, in ? a + static_cast<long long>(gk) * p.lda + gi : a, in ? 8 : 0);
    }
  }
}

// ---- fragments and products (g = lane / 4, t = lane % 4) ----
// A 16 x 8: a[q] at (g + 8 (q % 2), t + 4 (q / 2)); B 8 x 8: b[q] at (t + 4 q, g);
// C 16 x 8: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// element (n, k) of a tile that TMA loaded (a DFT block, a row-major data plane): row n holds 16 depth
// values in 16-byte chunks, swizzled (chunk ^ n % 8 inside each 1024-byte period)
__device__ __forceinline__ int b_at(int n, int k) { return n * kBK + ((((k >> 1) ^ n) & 7) << 1) + (k & 1); }

// rows r.. (16 of them) of the data tile's plane at depth k..
template <int kA>
__device__ __forceinline__ void frag_a(double (&a)[4], const double* sa, int plane, int r, int k, int g,
                                       int t) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = r + g + 8 * (q & 1);
    const int kk = k + t + 4 * (q >> 1);
    a[q] = kA == kRealT ? sa[kk * kSAT + row] : sa[plane * (kTileA / 8) + b_at(row, kk)];
  }
}

__device__ __forceinline__ void frag_b(double (&b)[2], const double* sb, int n, int k, int t) {
#pragma unroll
  for (int q = 0; q < 2; ++q) b[q] = sb[b_at(n, k + t + 4 * q)];
}

// the DFT block's row of this warp's n8 tile j: kConj, kRealT: j = 0, 1 the Fr rows and j = 2, 3
// the Fi' rows of the warp's 16 DFT columns; else 32 consecutive rows
template <int kA>
__device__ __forceinline__ int b_row(int j, int wn, int g) {
  if constexpr (kA == kConj || kA == kRealT) return (j >> 1) * kBoxRows + 16 * wn + 8 * (j & 1) + g;
  return 32 * wn + 8 * j + g;
}

// ---- epilogues ----
// Thread (g, t) of warp (wm, wn) holds acc[plane][i][j][q]: row 32 wm + 16 i + g + 8 (q / 2), column
// 2t + q % 2 of n8 tile j.  kConj and kRealT: tiles j and j + 2 are Fr and Fi' of one DFT column c =
// cw + 8 j + 2t + q % 2 (j < 2, cw = col0 + 16 wn); the planes of kConj are A's real and imaginary
// parts.  Each warp stages its values through its own 32 x 33 block of shared memory, one output
// plane at a time, so that each store instruction writes 32 consecutive values of one output row
// (transposed stores and the Hermitian mirror included).
// kStoreT (after kRealT): T[b][c][i] (T from T^T); column 0's Fi' slot holds the DFT column P/2
// kHerm (after kConj):   U[pair][r][n] for n in {c, P - c} (c = 0: {0, P/2}) and, for 0 < r < P/2,
//                        U[pair][P - r][(P - n) % P] = conj
// kMulU (after kConj):   E = D o U[pair][k][n], n as for kHerm, written as C3's operand: row c of
//                        [S | i D], S[c][k] = a + b at column k, (i D)[c][k] = i (a - b) at column
//                        h + k - 1 (0 < k < P/2; S = a at k = 0, P/2), a = E[k][c], b = E[P - k][c] =
//                        conj(E[k][P - c])
// kFold (after kSplit):  T2^T[c][y] of the stacked row (pair, c), written as C4's operand: row y of
//                        [f Re T2 | -f Im T2], Re at column c, Im at h + c - 1 (0 < c < P/2), f = 2
//                        for 0 < c < P/2 (the Hermitian row's other half), else 1
// kRe (after kReal):     out[row][y]

// kConj's products of DFT column c into D[c] and D[P - c], in place: [Tr Fr, Tr Fi'] and [Ti Fr, Ti
// Fi'] become (Re, Im) D[c] at acc[0][i][j][q], acc[1][i][j][q] and (Re, Im) D[pc] at acc[0][i][j +
// 2][q], acc[1][i][j + 2][q], pc the partner column P - c (P/2 at c = 0): D[c] = (TrFr - TiFi) + i
// (TrFi + TiFr), D[P - c] = (TrFr + TiFi) + i (TiFr - TrFi); at c = 0 Fi' is Fr's column P/2 (Fi's is 0)
__device__ __forceinline__ void pairs(double (&acc)[2][2][4][4], int cw, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool c0 = cw + 8 * j + 2 * t + (q & 1) == 0;
        const double a1 = acc[0][i][j][q], a3 = acc[0][i][j + 2][q];
        const double a4 = acc[1][i][j][q], a2 = acc[1][i][j + 2][q];
        acc[0][i][j][q] = c0 ? a1 : a1 - a2;
        acc[1][i][j][q] = c0 ? a4 : a3 + a4;
        acc[0][i][j + 2][q] = c0 ? a3 : a1 + a2;
        acc[1][i][j + 2][q] = c0 ? a2 : a4 - a3;
      }
}

template <int kEpi, int kP>
__device__ __forceinline__ void store_tile(const Args& p, double (&acc)[kP][2][4][4], int b, int row0, int col0,
                                           int wm, int wn, int lane, double* sw) {
  const int g = lane >> 2;
  const int t = lane & 3;
  const int pad = p.pad;
  const int h = pad / 2 + 1;
  const int r0 = row0 + 32 * wm;  // the warp's first row
  if constexpr (kEpi == kRe) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = r0 + 16 * i + g + 8 * h2;
        if (row >= p.m) continue;
        double* o = p.o_re + static_cast<long long>(row) * p.o_ld;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int y = col0 + 32 * wn + 8 * j + 2 * t;
          const double v0 = acc[0][i][j][2 * h2], v1 = acc[0][i][j][2 * h2 + 1];
          if (y + 1 < p.n && ((reinterpret_cast<uintptr_t>(o + y) & 15) == 0)) {
            *reinterpret_cast<double2*>(o + y) = make_double2(v0, v1);
          } else {
            if (y < p.n) o[y] = v0;
            if (y + 1 < p.n) o[y + 1] = v1;
          }
        }
      }
    return;
  }
  // put(x, row, col): the fragment value x at (row, col) of the warp's staging block
  auto put = [&](double x, int row, int col) { sw[row * kSO + col] = x; };
  auto each = [&](auto&& fn) {  // fn(value index (pl, i, j, q), local row, local column of tile j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) fn(i, j, q, 16 * i + g + 8 * (q >> 1), 8 * j + 2 * t + (q & 1));
  };
  if constexpr (kEpi == kStoreT) {
    // staged transposed: row c' of the tile's 16 DFT columns (16: the column P/2), column i'
    const int cw = col0 + 16 * wn;
    const int i_ = r0 + lane;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      each([&](int i, int j, int q, int row, int col) {
        if (j >= 2) return;
        const double re = acc[0][i][j][q], im = acc[0][i][j + 2][q];
        const bool c0 = cw + col == 0;
        put(pl ? (c0 ? 0.0 : im) : re, col, row);
        if (c0) put(pl ? 0.0 : im, 16, row);
      });
      __syncwarp();
      if (i_ < p.m) {
        double* o = (pl ? p.o_im : p.o_re) + b * p.o_batch + i_;
#pragma unroll
        for (int c = 0; c < 16; ++c) o[static_cast<long long>(cw + c) * p.o_ld] = sw[c * kSO + lane];
        if (cw == 0) o[static_cast<long long>(pad / 2) * p.o_ld] = sw[16 * kSO + lane];
      }
      __syncwarp();
    }
  } else if constexpr (kEpi == kHerm) {
    // staged by rows: columns 0..15 D[cw + c'], 31 - c' the partner D[pc]; a store instruction writes a
    // row's 16 columns from cw and its 16 partner columns (the mirror row's the same, reversed)
    const int cw = col0 + 16 * wn;
    pairs(acc, cw, t);
    const int n = lane < 16 ? cw + lane : (cw == 0 && lane == 31 ? pad / 2 : pad - cw - (31 - lane));
    const int mn = n ? pad - n : 0;  // the mirror row's column
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      each([&](int i, int j, int q, int row, int col) {
        if (j >= 2) return;
        put(acc[pl][i][j][q], row, col);
        put(acc[pl][i][j + 2][q], row, 31 - col);
      });
      __syncwarp();
      const double sign = pl ? -1.0 : 1.0;  // of a conjugate
      double* o = pl ? p.o_im : p.o_re;
      const long long pair0 = r0 / h;
      const int rr0 = r0 - static_cast<int>(pair0) * h;
      // unrolled by 16 (8 and 32 measured slower), so that each lane has several rows' loads and stores
      // in flight; h > 32, so a warp's rows cross at most one pair boundary
#pragma unroll 16
      for (int row = 0; row < 32; ++row) {
        if (r0 + row >= p.m) continue;
        const int wrap = rr0 + row >= h;
        const int r = rr0 + row - (wrap ? h : 0);
        const double v = sw[row * kSO + lane];
        double* ob = o + (pair0 + wrap) * p.o_batch;
        ob[static_cast<long long>(r) * p.o_ld + n] = v;
        if (r > 0 && 2 * r < pad) ob[static_cast<long long>(pad - r) * p.o_ld + mn] = sign * v;
      }
      __syncwarp();
    }
  } else if constexpr (kEpi == kMulU) {
    // E = D o U in place, then [S | i D] staged transposed: row c' (16: the column P/2), column k'
    const int cw = col0 + 16 * wn;
    pairs(acc, cw, t);
    each([&](int i, int j, int q, int row, int col) {
      if (j >= 2 || r0 + row >= p.m) return;
      const int rr = r0 + row;
      const long long pair = rr / h;
      const int k = rr - static_cast<int>(pair) * h;
      const int c = cw + col;
      const int pc = c ? pad - c : pad / 2;
      const double* ur = p.u_re + pair * pad * pad + static_cast<long long>(k) * pad;
      const double* ui = p.u_im + pair * pad * pad + static_cast<long long>(k) * pad;
      const double dr = acc[0][i][j][q], di = acc[1][i][j][q], pr = acc[0][i][j + 2][q], pi = acc[1][i][j + 2][q];
      const double xr = ur[c], xi = ui[c], yr = ur[pc], yi = ui[pc];
      acc[0][i][j][q] = dr * xr - di * xi;  // E[k][c]
      acc[1][i][j][q] = dr * xi + di * xr;
      acc[0][i][j + 2][q] = pr * yr - pi * yi;  // E[k][pc]
      acc[1][i][j + 2][q] = pr * yi + pi * yr;
    });
    const int rr = r0 + lane;
    const long long pair = rr / h;
    const int k = rr - static_cast<int>(pair) * h;
    const bool mirror = k > 0 && 2 * k < pad;
    // passes: S re, S im, (i D) re, (i D) im, each from a = E[k][c] and b = conj(E[k][P - c])
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      each([&](int i, int j, int q, int row, int col) {
        if (j >= 2) return;
        const int kk = r0 + row - static_cast<int>((r0 + row) / h) * h;
        const bool mk = kk > 0 && 2 * kk < pad;
        const double ar = acc[0][i][j][q], ai = acc[1][i][j][q];
        const double er = acc[0][i][j + 2][q], ei = acc[1][i][j + 2][q];
        const bool c0 = cw + col == 0;
        // row c: b = conj(E[k][P - c]), at c = 0 conj(E[k][0]); row P/2 (c = 0 only): a = E[k][P/2], b = conj(a)
        const double br = c0 ? ar : er, bi = c0 ? -ai : -ei;
        auto value = [&](double xr, double xi, double yr, double yi) {
          if (pass == 0) return mk ? xr + yr : xr;
          if (pass == 1) return mk ? xi + yi : xi;
          if (pass == 2) return yi - xi;  // Re i (x - y)
          return xr - yr;                 // Im i (x - y)
        };
        put(value(ar, ai, br, bi), col, row);
        if (c0) put(value(er, ei, er, -ei), 16, row);
      });
      __syncwarp();
      if (rr < p.m && (pass < 2 || mirror)) {
        double* o = (pass == 0 || pass == 2 ? p.o_re : p.o_im) + pair * p.o_batch + (pass < 2 ? k : h + k - 1);
#pragma unroll 4
        for (int c = 0; c < 16; ++c) o[static_cast<long long>(cw + c) * p.o_ld] = sw[c * kSO + lane];
        if (cw == 0) o[static_cast<long long>(pad / 2) * p.o_ld] = sw[16 * kSO + lane];
      }
      __syncwarp();
    }
  } else {
    // kFold: staged transposed, row y', column c' (the warp's rows)
    const int rr = r0 + lane;
    const long long pair = rr / h;
    const int cc = rr - static_cast<int>(pair) * h;
    const bool inner = cc > 0 && 2 * cc < pad;
    const int yw = col0 + 32 * wn;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      each([&](int i, int j, int q, int row, int col) { put(acc[pl][i][j][q], col, row); });
      __syncwarp();
      if (rr < p.m && (pl == 0 || inner)) {
        const double f = inner ? (pl ? -2.0 : 2.0) : 1.0;  // exact
        double* o = p.o_re + pair * p.o_batch + (pl ? h + cc - 1 : cc);
        for (int y = 0; y < 32 && yw + y < p.n; ++y) o[static_cast<long long>(yw + y) * p.o_ld] = f * sw[y * kSO + lane];
      }
      __syncwarp();
    }
  }
}

template <int kA, int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
    dft_dmma_kernel(const __grid_constant__ CUtensorMap planes_map, const __grid_constant__ CUtensorMap a_map,
                    const Args p) {
  constexpr int kP = n_planes<kA>();
  constexpr int kStage = stage_bytes<kA>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  double* staging = reinterpret_cast<double*>(smem + kStages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage + kStaging);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      f32::mbar_init(&full[s], full_count<kA>());
      f32::mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_per_batch = p.tiles_m * p.tiles_n;
  const int total = p.batch * tiles_per_batch;
  const int nk = (p.depth + kBK - 1) / kBK;
  const int lane = tid & 31;

  if (tid >= kConsumers) {
    // producer warp: the ring's TMA loads (lane 0) and, for transposed data, its copies (every lane)
    if (kA != kRealT && lane != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int b = tile / tiles_per_batch;
      const int rest = tile - b * tiles_per_batch;
      const int row0 = (rest / p.tiles_n) * kBM;
      const int col0 = (rest % p.tiles_n) * tile_cols<kA>();
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int slot = it % kStages;
        f32::mbar_wait(&empty[slot], ((it / kStages) & 1) ^ 1);
        unsigned char* st = smem + slot * kStage;
        if (lane == 0) {
          f32::mbar_expect_tx(&full[slot], kTileB + (kA == kRealT ? 0 : kP * kTileA));
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            // kConj, kRealT: Fr then Fi' of the tile's 32 DFT columns; else 64 rows of one plane
            const bool dft = kA == kConj || kA == kRealT;
            f32::tma_load(st + q * (kTileB / 2), &planes_map, &full[slot], kt * kBK,
                          p.b_row0 + col0 + (dft ? 0 : q * kBoxRows), dft ? q : p.b_plane);
          }
          if constexpr (kA != kRealT) {
#pragma unroll
            for (int pl = 0; pl < kP; ++pl)
#pragma unroll
              for (int q = 0; q < 2; ++q)
                f32::tma_load(st + kTileB + pl * kTileA + q * (kTileA / 2), &a_map, &full[slot], kt * kBK,
                              row0 + q * kBoxRows, pl);
          }
        }
        if constexpr (kA == kRealT) {
          load_at(reinterpret_cast<double*>(st + kTileB), p.a_re + b * p.a_batch, p, row0, kt * kBK, lane);
          f32::cp_async_arrive(&full[slot]);
        }
      }
    }
  } else {
    // consumer warps: 2 x 2 of 32 rows x 32 columns of B
    const int warp = tid >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wm = warp & 1;
    const int wn = warp >> 1;
    double acc[kP][2][4][4];
    int it = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int b = tile / tiles_per_batch;
      const int rest = tile - b * tiles_per_batch;
      const int row0 = (rest / p.tiles_n) * kBM;
      const int col0 = (rest % p.tiles_n) * tile_cols<kA>();
#pragma unroll
      for (int pl = 0; pl < kP; ++pl)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[pl][i][j][q] = 0.0;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int slot = it % kStages;
        f32::mbar_wait(&full[slot], (it / kStages) & 1);
        const double* sb = reinterpret_cast<const double*>(smem + slot * kStage);
        const double* sa = sb + kTileB / 8;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += kMmaK) {
          if (kt * kBK + kk < p.depth) {
            double a[kP][2][4];
#pragma unroll
            for (int pl = 0; pl < kP; ++pl)
#pragma unroll
              for (int i = 0; i < 2; ++i) frag_a<kA>(a[pl][i], sa, pl, 32 * wm + 16 * i, kk, g, t);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              double bf[2];
              frag_b(bf, sb, b_row<kA>(j, wn, g), kk, t);
#pragma unroll
              for (int pl = 0; pl < kP; ++pl)
#pragma unroll
                for (int i = 0; i < 2; ++i) dmma(acc[pl][i][j], a[pl][i], bf);
            }
          }
        }
        f32::mbar_arrive(&empty[slot]);
      }
      store_tile<kEpi, kP>(p, acc, b, row0, col0, wm, wn, lane, staging + warp * 32 * kSO);
    }
  }
}

// ---- host side ----

// the f64 planes (3, P, P): Fr, Fi' (Fi with row 0 replaced by Fr's row P/2), Bsplit (row r: Br[r][0..P/2]
// then Bi[r][1..P/2 - 1]); boxes of 32 rows x 16 values
cudaError_t plane_map(CUtensorMap* map, const void* planes, int pad) {
  const f32::EncodeTiled encode = f32::encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(pad), static_cast<cuuint64_t>(pad), 3};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pad) * 8, static_cast<cuuint64_t>(pad) * pad * 8};
  const cuuint32_t box[3] = {kBK, kBoxRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3, const_cast<void*>(planes), dims, strides, box,
                            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row-major data operand's planes (re, im), the second plane_stride bytes after the first: depth x m x
// planes, boxes of 32 rows x 16 values, zero past the depth and the rows
cudaError_t data_map(CUtensorMap* map, const Args& a, int n_planes) {
  const f32::EncodeTiled encode = f32::encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  long long plane_stride = (static_cast<long long>(a.lda) * a.m * 8 + 15) / 16 * 16;
  if (n_planes == 2) plane_stride = reinterpret_cast<const char*>(a.a_im) - reinterpret_cast<const char*>(a.a_re);
  if (!f32::aligned16(a.a_re) || a.lda % 2 || plane_stride <= 0 || plane_stride % 16) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.depth), static_cast<cuuint64_t>(a.m),
                              static_cast<cuuint64_t>(n_planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(a.lda) * 8, static_cast<cuuint64_t>(plane_stride)};
  const cuuint32_t box[3] = {kBK, kBoxRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3, const_cast<double*>(a.a_re), dims, strides, box,
                            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

Args data(const double* re, const double* im, long long batch_stride, int ld, int m, int depth, int pad) {
  Args a{};
  a.pad = pad;
  a.a_re = re;
  a.a_im = im;
  a.a_batch = batch_stride;
  a.lda = ld;
  a.m = m;
  a.depth = depth;
  a.a_vec = f32::aligned16(re) && (im == nullptr || f32::aligned16(im)) && ld % 2 == 0 && batch_stride % 2 == 0;
  a.batch = 1;
  return a;
}

void dft_block(Args& a, int n, int plane, int row0) {
  a.n = n;
  a.b_plane = plane;
  a.b_row0 = row0;
}

void out_to(Args& a, double* re, double* im, long long batch_stride, int ld) {
  a.o_re = re;
  a.o_im = im;
  a.o_batch = batch_stride;
  a.o_ld = ld;
}

template <int kA, int kEpi>
cudaError_t run(const void* planes, Args a, int device, cudaStream_t s) {
  if (a.batch == 0 || a.m == 0 || a.n == 0) return cudaSuccess;
  a.tiles_m = (a.m + kBM - 1) / kBM;
  a.tiles_n = (a.n + tile_cols<kA>() - 1) / tile_cols<kA>();
  const long long tiles = static_cast<long long>(a.batch) * a.tiles_m * a.tiles_n;
  if (tiles > (1LL << 31) - 1) return cudaErrorInvalidValue;
  // per device, once: the SM count and the kernel's shared-memory attribute
  static int sms[64] = {};
  static unsigned long long attribute_set = 0;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sms[device] == 0) RETURN_IF_ERROR(cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device));
  CUtensorMap map, a_map{};
  RETURN_IF_ERROR(plane_map(&map, planes, a.pad));
  if (kA != kRealT) RETURN_IF_ERROR(data_map(&a_map, a, n_planes<kA>()));
  const auto kernel = dft_dmma_kernel<kA, kEpi>;
  constexpr int bytes = smem_bytes<kA>();
  static int resident[64] = {};  // blocks an SM holds
  if (!(attribute_set >> device & 1)) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    // all of the SM's shared memory for the kernel, so that two blocks fit (CUDA may pick a smaller carveout)
    RETURN_IF_ERROR(
        cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared));
    RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[device], kernel, kThreads, bytes));
    if (resident[device] < 1) return cudaErrorInvalidConfiguration;
    attribute_set |= 1ULL << device;
  }
  const long long slots = static_cast<long long>(resident[device]) * sms[device];  // persistent: one pass of blocks
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kernel<<<grid, kThreads, bytes, s>>>(map, a_map, a);
  return cudaGetLastError();
}

cudaError_t spectrum(const double* kernels, int n_pairs, int m, int k_ld, const void* planes, double* tr, double* ti,
                     int t_ld, double* ur, double* ui, int pad, int device, cudaStream_t s) {
  const int half = pad / 2 + 1;  // U of a real kernel is Hermitian: rows 0..P/2 determine it
  // S1: T^T = W^T [Fr | Fi'] over DFT columns 0..P/2 - 1 (P/2 in column 0's Fi' slot), stored as T
  // (h x m) a pair; W's rows k_ld apart
  Args s1 = data(kernels, nullptr, static_cast<long long>(m) * k_ld, k_ld, m, m, pad);
  s1.batch = n_pairs;
  dft_block(s1, pad / 2, 0, 0);
  out_to(s1, tr, ti, static_cast<long long>(half) * t_ld, t_ld);
  RETURN_IF_ERROR((run<kRealT, kStoreT>(planes, s1, device, s)));
  // S2: U = T F[:m, :] over DFT columns 0..P/2 - 1 (each gives c and P - c; column 0 also P/2), the
  // pairs' T stacked into one (K h) x m operand; rows h.. as the mirror
  Args s2 = data(tr, ti, 0, t_ld, n_pairs * half, m, pad);
  dft_block(s2, pad / 2, 0, 0);
  out_to(s2, ur, ui, static_cast<long long>(pad) * pad, pad);
  return run<kConj, kHerm>(planes, s2, device, s);
}

cudaError_t conv(const double* grids, int n_pairs, int in_size, const void* planes, const double* ur,
                 const double* ui, double* tr, double* ti, int t_ld, double* er, double* ei, double* t2, double* out,
                 int out_size, int offset, int pad, int device, cudaStream_t s) {
  const int half = pad / 2 + 1;
  // C1: T^T = G^T [Fr | Fi'], stored as T (h x I) a pair (as S1)
  Args c1 = data(grids, nullptr, static_cast<long long>(in_size) * in_size, in_size, in_size, in_size, pad);
  c1.batch = n_pairs;
  dft_block(c1, pad / 2, 0, 0);
  out_to(c1, tr, ti, static_cast<long long>(half) * t_ld, t_ld);
  RETURN_IF_ERROR((run<kRealT, kStoreT>(planes, c1, device, s)));
  // C2: E = (T F[:I, :]) o U over the stacked T, DFT columns as S2's, written as C3's operand
  // [S | i D] (h x P a pair: row c, E's rows k and P - k paired)
  Args c2 = data(tr, ti, 0, t_ld, n_pairs * half, in_size, pad);
  dft_block(c2, pad / 2, 0, 0);
  out_to(c2, er, ei, static_cast<long long>(half) * pad, pad);
  c2.u_re = ur;
  c2.u_im = ui;
  RETURN_IF_ERROR((run<kConj, kMulU>(planes, c2, device, s)));
  // C3: T2^T = E[:, :h]^T B[:, w] = [S | i D] Bsplit[w, :]^T (B[k][w0 + y] = B[w0 + y][k]; S against
  // Br, i D against Bi), depth P; E Hermitian makes each row of T2 Hermitian, so Re(T2 B[:, w]) sums
  // columns 0 and P/2 once and the columns between twice, which the epilogue doubles; stored as C4's
  // operand [Re T2 | -Im T2] (out_size x P a pair)
  Args c3 = data(er, ei, 0, pad, n_pairs * half, pad, pad);
  dft_block(c3, out_size, 2, offset);
  out_to(c3, t2, nullptr, static_cast<long long>(out_size) * pad, pad);
  RETURN_IF_ERROR((run<kSplit, kFold>(planes, c3, device, s)));
  // C4: out[x][y] = Re(sum_c T2[x][c] B[c][w0 + y]) = [Re T2 | -Im T2][x] Bsplit[w0 + y], the pairs'
  // rows stacked (Bi's columns 0 and P/2 are zero)
  Args c4 = data(t2, nullptr, 0, pad, n_pairs * out_size, pad, pad);
  dft_block(c4, out_size, 2, offset);
  out_to(c4, out, nullptr, 0, out_size);
  return run<kReal, kRe>(planes, c4, device, s);
}

}  // namespace f64

}  // namespace

// kernels (K, m, k_ld), the first m of each row used -> ur, ui (K, P, P); tr, ti are (K, P / 2
// + 1, t_ld) scratch, t_ld >= m.  Every array is f64 when is_double (planes: the f64 planes (3, P,
// P) of f64::plane_map), else f32 (planes: the tf32 planes (10, P, P)).
extern "C" int dft_spectrum_launch(int device, int is_double, const void* kernels, int n_pairs, int m, int k_ld,
                                   const void* planes, void* tr, void* ti, int t_ld, void* ur, void* ui, int pad,
                                   void* stream) {
  RETURN_IF_ERROR(cudaSetDevice(device));
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return static_cast<int>(f64::spectrum(static_cast<const double*>(kernels), n_pairs, m, k_ld, planes,
                                          static_cast<double*>(tr), static_cast<double*>(ti), t_ld,
                                          static_cast<double*>(ur), static_cast<double*>(ui), pad, device, s));
  return static_cast<int>(f32::spectrum(static_cast<const float*>(kernels), n_pairs, m, k_ld, planes,
                                        static_cast<float*>(tr), static_cast<float*>(ti), t_ld,
                                        static_cast<float*>(ur), static_cast<float*>(ui), pad, device, s));
}

// grids (K, I, I), spectra ur, ui (K, P, P) -> out (K, out_size, out_size), the slice [offset,
// offset + out_size)^2 of the full linear convolution.  Scratch: tr, ti (K, P / 2 + 1, t_ld >= I);
// in f64 er, ei (K, P / 2 + 1, P) and t2r (K, out_size, P) (t2i unused, t2_ld = P); in f32 er, ei
// (K, P / 2 + 1, 2 s), s = P / 2 + 1 rounded up to a multiple of 32, and t2r, t2i (K, out_size,
// t2_ld >= P / 2 + 1).  Every array is f64 when is_double (planes: the f64 planes), else f32 (the
// tf32 planes).
extern "C" int dft_conv_launch(int device, int is_double, const void* grids, int n_pairs, int in_size,
                               const void* planes, const void* ur, const void* ui, void* tr, void* ti, int t_ld,
                               void* er, void* ei, void* t2r, void* t2i, int t2_ld, void* out, int out_size,
                               int offset, int pad, void* stream) {
  RETURN_IF_ERROR(cudaSetDevice(device));
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return static_cast<int>(f64::conv(static_cast<const double*>(grids), n_pairs, in_size, planes,
                                      static_cast<const double*>(ur), static_cast<const double*>(ui),
                                      static_cast<double*>(tr), static_cast<double*>(ti), t_ld,
                                      static_cast<double*>(er), static_cast<double*>(ei),
                                      static_cast<double*>(t2r), static_cast<double*>(out), out_size, offset, pad,
                                      device, s));
  return static_cast<int>(f32::conv(static_cast<const float*>(grids), n_pairs, in_size, planes,
                                    static_cast<const float*>(ur), static_cast<const float*>(ui),
                                    static_cast<float*>(tr), static_cast<float*>(ti), t_ld, static_cast<float*>(er),
                                    static_cast<float*>(ei), static_cast<float*>(t2r), static_cast<float*>(t2i),
                                    t2_ld, static_cast<float*>(out), out_size, offset, pad, device, s));
}
