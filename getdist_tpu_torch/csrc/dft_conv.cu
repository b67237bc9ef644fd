// Batched 2D linear convolution as DFT matrix products, for Hopper (sm_90a).
//
// Replaces getdist_tpu/ops/dft_conv.py:155 dft_conv_spectrum (pallas_call at
// :164, _spec_kernel) and :190 dft_conv2d (pallas_call at :201,
// _conv_kernel).  F is the symmetric P x P DFT matrix and B = conj(F) / P is
// symmetric too.  For pair k, kernel W (m x m) and grid G (I x I), both real
// and at the origin of the P x P frame, with h = P / 2 + 1 and w = [offset,
// offset + out_size) the output window:
//   spectrum (2 launches):  T  = F[:h, :m] W                       depth m
//                           U  = T F[:m, :], rows h.. mirrored     depth m
//   conv (4 launches):      C1 T  = F[:h, :I] G                    depth I
//                           C2 E  = (T F[:I, :]) o U, mirrored     depth I
//                           C3 T2 = (B[w, :] E)[:, :h], stored transposed,
//                                   columns 0 < c < P / 2 doubled  depth P
//                           C4 out = Re(B[w, :h] T2^T)^T           depth h
// Every stage contracts over the kernel's or grid's support, or over the
// frame only where the window needs it: nothing multiplies through the zero
// padding.  Real inputs make U and E Hermitian (X[P - r][P - c] =
// conj(X[r][c])), so rows 0..P/2 determine them and the epilogue writes the
// other rows as the conjugate mirror; the rows of T2 are Hermitian too, so
// Re(T2 B[:, w]) needs only columns 0..P/2 of T2, the inner ones twice.
// That halves every stage but C2's depth and C3's depth.
//
// What bounds it on this card.  The fastest f32-accurate product is three
// TF32 tensor-core passes (495 / 3 = 165 TFLOP/s); in f64 it is DMMA (67
// TFLOP/s).  At the fused path's shapes (435 pairs, P = 384, m = 61, I =
// out = 256, f32) the spectrum needs 17.0 GFLOP with the Hermitian halves
// (33.8 without) and must write 0.51 GB of spectra: bytes bound it (0.16
// ms).  A convolution needs 176 GFLOP (350 without) against 0.74 GB:
// operations bound it (1.07 ms).  Parity's f64 shapes (P = 512, m = 69)
// are the same: the spectrum bytes bound, the convolution operations bound.
//
// What the design does about it: one batched complex GEMM kernel
// (cgemm_kernel) with four epilogue modes runs every stage.
//  - Tensor cores through mma.sync.m16n8k8: f32 as 3xTF32 (each operand
//    split into hi = rna(x) and lo = rna(x - hi); lo.hi + hi.lo + hi.hi,
//    about f32 accuracy, where one TF32 pass keeps three digits), f64 as
//    DMMA.
//  - Operands stream through a multi-stage ring of cp.async copies in
//    dynamic shared memory: 16-byte copies where the operand's base and
//    leading dimension allow, element copies otherwise (the kernels' m x m
//    rows, odd grid widths).  The ragged edges of the supports and of the
//    window are zero-filled by the copy (src-size below the copy size),
//    never tested in the inner loop.
//  - Where B is the shared DFT matrix (U, C2), the pairs' T stack into one
//    tall operand, so no row tile is spent on a pair's ragged h rows.
//  - Fused epilogues: C2 multiplies by the kernel spectrum U as it stores;
//    C3 stores T2 transposed so that C4 reads both operands row by row
//    (B[:, w] = B[w, :]^T by symmetry); C4 keeps only the real part and
//    writes the window straight to the output.
//  - Each output element is summed by one thread in one fixed order: no
//    split-K, no atomics, so two calls give bitwise-equal results.
// Block tile 64 x 64, four warps of 32 x 32; depth 16 a stage in f32 (3
// stages), 8 in f64 (4 stages).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 64;

template <typename T>
struct Cfg;

// MT: 16-row tiles of a warp (2 x 2 warps, each 16 MT x 32); strides SA, SB
// keep the fragment reads free of bank conflicts
template <>
struct Cfg<float> {
  static constexpr int MT = 2, BM = 32 * MT, BK = 16, STAGES = 3, SA = BK + 4, SB = kBN + 8;
};

template <>
struct Cfg<double> {
  static constexpr int MT = 2, BM = 32 * MT, BK = 8, STAGES = 4, SA = BK + 4, SB = kBN + 4;
};

enum Mode { kRealB = 0, kComplex = 1, kMulU = 2, kReOut = 3 };

// A batched operand: element (r, c) of batch b is re[b * batch_stride + r * ld + c]
// (and im[...]) for r < rows, c < cols, zero outside.  im is null for a real operand.
template <typename T>
struct Mat {
  const T* re;
  const T* im;
  long long batch_stride;
  int ld;
  int rows;
  int cols;
  int vec;  // base and ld allow 16-byte copies
};

// Where a stage's result goes: element (r, c) to re/im[b * batch_stride + r * ld + c],
// or [c * ld + r] when transpose.  kMulU multiplies by (ur + i ui)[b * u_batch_stride + r * u_ld + c] first.
template <typename T>
struct Out {
  T* re;
  T* im;
  long long batch_stride;
  int ld;
  int transpose;
  int hermitian;  // also write rows n - r, 0 < r < n / 2, as the conjugate mirror (real inputs)
  int fold;       // > 0: double the columns 0 < c < fold / 2 (a Hermitian row's other half, folded in)
  int rows_per_batch;  // > 0: the batch is folded into the rows, row R is row R % rows_per_batch of R / rows_per_batch
  const T* ur;
  const T* ui;
  long long u_batch_stride;
  int u_ld;
};

// ---- cp.async ----

template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x COLS tile of g at (row0, col0) into s (row stride LD); zeros past (rows, cols).
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* s, const T* g, int ld, int row0, int col0, int rows, int cols, bool vec,
                                          int tid) {
  if (vec) {
    constexpr int VE = 16 / static_cast<int>(sizeof(T));
    constexpr int CPR = COLS / VE;
    static_assert((ROWS * CPR) % kThreads == 0, "whole chunks per thread");
#pragma unroll
    for (int l = 0; l < ROWS * CPR / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / CPR;
      const int c = (e % CPR) * VE;
      const int gr = row0 + r;
      const int gc = col0 + c;
      const bool in = gr < rows && gc < cols;
      const int bytes = in ? min(VE, cols - gc) * static_cast<int>(sizeof(T)) : 0;
      cp_async_zfill<16>(s + r * LD + c, in ? g + static_cast<long long>(gr) * ld + gc : g, bytes);
    }
  } else {
    static_assert((ROWS * COLS) % kThreads == 0, "whole elements per thread");
#pragma unroll 4
    for (int l = 0; l < ROWS * COLS / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / COLS;
      const int c = e % COLS;
      const int gr = row0 + r;
      const int gc = col0 + c;
      const bool in = gr < rows && gc < cols;
      cp_async_zfill<static_cast<int>(sizeof(T))>(s + r * LD + c, in ? g + static_cast<long long>(gr) * ld + gc : g,
                                in ? static_cast<int>(sizeof(T)) : 0);
    }
  }
}

// ---- fragments and tensor-core products (m16n8k8; g = lane / 4, t = lane % 4) ----
// A 16 x 8: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
// B 8 x 8:  b0 (t, g), b1 (t + 4, g)
// C 16 x 8: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

struct FragA32 {
  uint32_t hi[4], lo[4];
};
struct FragB32 {
  uint32_t hi[2], lo[2];
};
struct FragA64 {
  double v[4];
};
struct FragB64 {
  double v[2];
};

template <typename T>
struct Frags;
template <>
struct Frags<float> {
  using A = FragA32;
  using B = FragB32;
};
template <>
struct Frags<double> {
  using A = FragA64;
  using B = FragB64;
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void frag_a(FragA32& f, const float* p, int ld) {
  const float x[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(x[q], f.hi[q], f.lo[q]);
}

__device__ __forceinline__ void frag_a(FragA64& f, const double* p, int ld) {
  f.v[0] = p[0];
  f.v[1] = p[8 * ld];
  f.v[2] = p[4];
  f.v[3] = p[8 * ld + 4];
}

__device__ __forceinline__ void frag_b(FragB32& f, const float* p, int ld) {
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4 * ld], f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void frag_b(FragB64& f, const double* p, int ld) {
  f.v[0] = p[0];
  f.v[1] = p[4 * ld];
}

// -b: a sign flip is exact for both halves
__device__ __forceinline__ FragB32 negated(const FragB32& f) {
  FragB32 n;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    n.hi[q] = f.hi[q] ^ 0x80000000u;
    n.lo[q] = f.lo[q] ^ 0x80000000u;
  }
  return n;
}

__device__ __forceinline__ FragB64 negated(const FragB64& f) { return {{-f.v[0], -f.v[1]}}; }

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: the small terms first, then hi . hi
__device__ __forceinline__ void mma(float (&d)[4], const FragA32& a, const FragB32& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

__device__ __forceinline__ void mma(double (&d)[4], const FragA64& a, const FragB64& b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a.v[0]), "d"(a.v[1]), "d"(a.v[2]), "d"(a.v[3]), "d"(b.v[0]), "d"(b.v[1]));
}

// acc += a1 b1 (+ a2 b2).  The tensor cores' f32 accumulation truncates
// (round toward zero), which biases a long sum by up to an ulp of the
// running total per product: summed over the chain's depths that was 2.5e-5
// of the largest value.  So one k-step's 3xTF32 passes (one or two
// products of depth 8) go into a zeroed partial, and an IEEE add (round to
// nearest) brings it into acc.  DMMA is IEEE f64: it accumulates directly.
__device__ __forceinline__ void mma_acc(float (&acc)[4], const FragA32& a1, const FragB32& b1) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma(p, a1, b1);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += p[q];
}

__device__ __forceinline__ void mma_acc(float (&acc)[4], const FragA32& a1, const FragB32& b1, const FragA32& a2,
                                        const FragB32& b2) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma(p, a1, b1);
  mma(p, a2, b2);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += p[q];
}

__device__ __forceinline__ void mma_acc(double (&acc)[4], const FragA64& a1, const FragB64& b1) { mma(acc, a1, b1); }

__device__ __forceinline__ void mma_acc(double (&acc)[4], const FragA64& a1, const FragB64& b1, const FragA64& a2,
                                        const FragB64& b2) {
  mma(acc, a1, b1);
  mma(acc, a2, b2);
}

// two adjacent values at an even element (8- or 16-byte aligned)
__device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void load2(const double* p, double (&v)[2]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void store2(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store2(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

template <typename T, int kMode>
__host__ __device__ constexpr int stage_elems() {
  return 2 * Cfg<T>::BM * Cfg<T>::SA + (kMode == kRealB ? 1 : 2) * Cfg<T>::BK * Cfg<T>::SB;
}

// C[b] = A[b] B[b] (complex A; B real in kRealB) over `depth`, C m x n, then
// the epilogue of kMode into o.  Grid (ceil(n / 64), ceil(m / BM), batch).
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    cgemm_kernel(Mat<T> a, Mat<T> b, int depth, int m, int n, Out<T> o) {
  using C = Cfg<T>;
  using FA = typename Frags<T>::A;
  using FB = typename Frags<T>::B;
  constexpr int kMT = C::MT, kNT = 4;  // 16 x 8 tiles of a warp's 16 MT x 32
  constexpr int kStageA = C::BM * C::SA;
  constexpr int kStageB = C::BK * C::SB;
  constexpr int kStage = stage_elems<T, kMode>();
  constexpr bool kImOut = kMode != kReOut;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const long long batch = blockIdx.z;
  const int row0 = blockIdx.y * C::BM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 16 * kMT;
  const int wn = (warp & 1) * 32;
  const T* a_re = a.re + batch * a.batch_stride;
  const T* a_im = a.im + batch * a.batch_stride;
  const T* b_re = b.re + batch * b.batch_stride;
  const T* b_im = kMode == kRealB ? nullptr : b.im + batch * b.batch_stride;

  auto load = [&](int slot, int kt) {
    T* s = smem + slot * kStage;
    const int k0 = kt * C::BK;
    load_tile<T, C::BM, C::BK, C::SA>(s, a_re, a.ld, row0, k0, a.rows, a.cols, a.vec, tid);
    load_tile<T, C::BM, C::BK, C::SA>(s + kStageA, a_im, a.ld, row0, k0, a.rows, a.cols, a.vec, tid);
    load_tile<T, C::BK, kBN, C::SB>(s + 2 * kStageA, b_re, b.ld, k0, col0, b.rows, b.cols, b.vec, tid);
    if constexpr (kMode != kRealB)
      load_tile<T, C::BK, kBN, C::SB>(s + 2 * kStageA + kStageB, b_im, b.ld, k0, col0, b.rows, b.cols, b.vec, tid);
  };
  T acc[2][kMT][kNT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][i][j][q] = T(0);

  const int nk = (depth + C::BK - 1) / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile kt is in; every warp is done with the slot refilled below
    if (kt + C::STAGES - 1 < nk) load((kt + C::STAGES - 1) % C::STAGES, kt + C::STAGES - 1);
    cp_async_commit();
    const T* s = smem + (kt % C::STAGES) * kStage;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 8) {
      FA ar[kMT], ai[kMT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int off = (wm + 16 * i + g) * C::SA + kk + t;
        frag_a(ar[i], s + off, C::SA);
        frag_a(ai[i], s + kStageA + off, C::SA);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int off = (kk + t) * C::SB + wn + 8 * j + g;
        FB br;
        frag_b(br, s + 2 * kStageA + off, C::SB);
        if constexpr (kMode == kRealB) {
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            mma_acc(acc[0][i][j], ar[i], br);
            mma_acc(acc[1][i][j], ai[i], br);
          }
        } else {
          FB bi;
          frag_b(bi, s + 2 * kStageA + kStageB + off, C::SB);
          const FB nbi = negated(bi);
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            mma_acc(acc[0][i][j], ar[i], br, ai[i], nbi);
            if constexpr (kImOut) mma_acc(acc[1][i][j], ar[i], bi, ai[i], br);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // each thread holds, per 16 x 8 tile, rows g and g + 8, columns 2t and 2t + 1
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm + 16 * i + g + 8 * h;
      if (row >= m) continue;
      const long long item = o.rows_per_batch ? row / o.rows_per_batch : batch;
      const int r = o.rows_per_batch ? row - static_cast<int>(item) * o.rows_per_batch : row;
      T* o_re = o.re + item * o.batch_stride;
      T* o_im = kImOut ? o.im + item * o.batch_stride : nullptr;
      // rows n - r (n = P) of a Hermitian spectrum: the conjugate of row r, columns reversed
      const bool mirror = kImOut && o.hermitian && r > 0 && 2 * r < n;
      const long long mirror_row = static_cast<long long>(n - r) * o.ld;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = col0 + wn + 8 * j + 2 * t;
        if (c >= n) continue;
        const bool pair = c + 1 < n;
        T vr[2], vi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          vr[e] = acc[0][i][j][2 * h + e];
          vi[e] = acc[1][i][j][2 * h + e];
        }
        if constexpr (kMode == kMulU) {
          const long long u = item * o.u_batch_stride + static_cast<long long>(r) * o.u_ld + c;
          T ur[2], ui[2];
          if (pair) {
            load2(o.ur + u, ur);
            load2(o.ui + u, ui);
          } else {
            ur[0] = o.ur[u];
            ui[0] = o.ui[u];
            ur[1] = ui[1] = T(0);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const T er = vr[e] * ur[e] - vi[e] * ui[e];
            vi[e] = vr[e] * ui[e] + vi[e] * ur[e];
            vr[e] = er;
          }
        }
        if (o.fold) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (c + e > 0 && 2 * (c + e) < o.fold) {
              vr[e] *= T(2);  // exact
              vi[e] *= T(2);
            }
          }
        }
        if (o.transpose) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (e == 0 || pair) {
              const long long at = static_cast<long long>(c + e) * o.ld + r;
              o_re[at] = vr[e];
              if constexpr (kImOut) o_im[at] = vi[e];
            }
          }
        } else {
          const long long at = static_cast<long long>(r) * o.ld + c;
          if (pair) {
            store2(o_re + at, vr);
            if constexpr (kImOut) store2(o_im + at, vi);
          } else {
            o_re[at] = vr[0];
            if constexpr (kImOut) o_im[at] = vi[0];
          }
        }
        if (mirror) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (e == 0 || pair) {
              const long long at = mirror_row + (c + e ? n - c - e : 0);
              o_re[at] = vr[e];
              o_im[at] = -vi[e];
            }
          }
        }
      }
    }
  }
}

#define RETURN_IF_ERROR(expr)             \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

template <typename T>
Mat<T> mat(const void* re, const void* im, long long batch_stride, int ld, int rows, int cols) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  const bool aligned = reinterpret_cast<uintptr_t>(re) % 16 == 0 && reinterpret_cast<uintptr_t>(im) % 16 == 0;
  return {static_cast<const T*>(re), static_cast<const T*>(im), batch_stride, ld, rows, cols,
          aligned && ld % VE == 0 && batch_stride % VE == 0};
}

template <typename T>
Out<T> out_to(void* re, void* im, long long batch_stride, int ld, int transpose) {
  return {static_cast<T*>(re), static_cast<T*>(im), batch_stride, ld, transpose, 0, 0, 0, nullptr, nullptr, 0, 0};
}

template <typename T, int kMode>
cudaError_t cgemm(const Mat<T>& a, const Mat<T>& b, int depth, int m, int n, const Out<T>& o, int batch,
                  cudaStream_t s) {
  constexpr int bytes = Cfg<T>::STAGES * stage_elems<T, kMode>() * static_cast<int>(sizeof(T));
  if (batch > 65535 || (m + Cfg<T>::BM - 1) / Cfg<T>::BM > 65535) return cudaErrorInvalidValue;
  if (batch == 0 || m == 0 || n == 0) return cudaSuccess;
  const auto kernel = cgemm_kernel<T, kMode>;
  RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  const dim3 grid((n + kBN - 1) / kBN, (m + Cfg<T>::BM - 1) / Cfg<T>::BM, batch);
  kernel<<<grid, kThreads, bytes, s>>>(a, b, depth, m, n, o);
  return cudaGetLastError();
}

template <typename T>
cudaError_t spectrum(const void* kernels, int n_pairs, int m, const void* fr, const void* fi, void* tr, void* ti,
                     int t_ld, void* ur, void* ui, int pad, cudaStream_t s) {
  const long long frame = static_cast<long long>(pad) * pad;
  const int half = pad / 2 + 1;  // U of a real kernel is Hermitian: rows 0..P/2 determine it
  const long long t_stride = static_cast<long long>(half) * t_ld;
  // T = F[:, :m] W, the rows U needs
  RETURN_IF_ERROR((cgemm<T, kRealB>(mat<T>(fr, fi, 0, pad, half, m),
                                    mat<T>(kernels, kernels, static_cast<long long>(m) * m, m, m, m), m, half, m,
                                    out_to<T>(tr, ti, t_stride, t_ld, 0), n_pairs, s)));
  // U = T F[:m, :]: rows 0..P/2, the rest as their Hermitian mirror
  Out<T> u = out_to<T>(ur, ui, frame, pad, 0);
  u.hermitian = 1;
  u.rows_per_batch = half;  // F is shared: the pairs' T stack into one (K (P/2 + 1)) x m operand
  return cgemm<T, kComplex>(mat<T>(tr, ti, 0, t_ld, n_pairs * half, m), mat<T>(fr, fi, 0, pad, m, pad), m,
                            n_pairs * half, pad, u, 1, s);
}

template <typename T>
cudaError_t conv(const void* grids, int n_pairs, int in_size, const void* fr, const void* fi, const void* br,
                 const void* bi, const void* ur, const void* ui, void* tr, void* ti, int t_ld, void* er, void* ei,
                 void* t2r, void* t2i, int t2_ld, void* out, int out_size, int offset, int pad, cudaStream_t s) {
  const long long frame = static_cast<long long>(pad) * pad;
  const int half = pad / 2 + 1;  // E of real grids and kernels is Hermitian: rows 0..P/2 determine it
  const long long t_stride = static_cast<long long>(half) * t_ld;
  const long long t2_stride = static_cast<long long>(half) * t2_ld;
  const long long window_row = static_cast<long long>(offset) * pad;
  const T* wr = static_cast<const T*>(br) + window_row;  // B[w, :] = B[:, w]^T
  const T* wi = static_cast<const T*>(bi) + window_row;
  // C1: T = F[:, :I] G, the rows E needs
  RETURN_IF_ERROR((cgemm<T, kRealB>(mat<T>(fr, fi, 0, pad, half, in_size),
                                    mat<T>(grids, grids, static_cast<long long>(in_size) * in_size, in_size, in_size,
                                           in_size),
                                    in_size, half, in_size, out_to<T>(tr, ti, t_stride, t_ld, 0), n_pairs, s)));
  // C2: E = (T F[:I, :]) o U, rows 0..P/2 and their Hermitian mirror
  Out<T> e = out_to<T>(er, ei, frame, pad, 0);
  e.hermitian = 1;
  e.ur = static_cast<const T*>(ur);
  e.ui = static_cast<const T*>(ui);
  e.u_batch_stride = frame;
  e.u_ld = pad;
  e.rows_per_batch = half;  // F is shared: the pairs' T stack into one (K (P/2 + 1)) x I operand
  RETURN_IF_ERROR((cgemm<T, kMulU>(mat<T>(tr, ti, 0, t_ld, n_pairs * half, in_size),
                                   mat<T>(fr, fi, 0, pad, in_size, pad), in_size, n_pairs * half, pad, e, 1, s)));
  // C3: T2 = B[w, :] E, columns 0..P/2 only, stored transposed.  E Hermitian
  // makes each row of T2 Hermitian too, T2[x][P - c] = conj(T2[x][c]), and
  // B[P - c][y] = conj(B[c][y]): so Re(T2 B[:, w]) sums columns 0 and P/2
  // once and the columns between twice, which the epilogue doubles.
  Out<T> t2 = out_to<T>(t2r, t2i, t2_stride, t2_ld, 1);
  t2.fold = pad;
  RETURN_IF_ERROR((cgemm<T, kComplex>(mat<T>(wr, wi, 0, pad, out_size, pad), mat<T>(er, ei, frame, pad, pad, pad),
                                      pad, out_size, half, t2, n_pairs, s)));
  // C4: out[r][c] = Re(sum_k T2[r][k] B[k][offset + c]) = Re((B[w, :] T2^T)[c][r]), k = 0..P/2
  return cgemm<T, kReOut>(mat<T>(wr, wi, 0, pad, out_size, half), mat<T>(t2r, t2i, t2_stride, t2_ld, half, out_size),
                          half, out_size, out_size,
                          out_to<T>(out, nullptr, static_cast<long long>(out_size) * out_size, out_size, 1), n_pairs,
                          s);
}

}  // namespace

// kernels (K, m, m) -> ur, ui (K, P, P); tr, ti are (K, P / 2 + 1, t_ld)
// scratch, t_ld >= m.  Every array is f64 when is_double, else f32.
extern "C" int dft_spectrum_launch(int device, int is_double, const void* kernels, int n_pairs, int m,
                                   const void* fr, const void* fi, void* tr, void* ti, int t_ld, void* ur, void* ui,
                                   int pad, void* stream) {
  RETURN_IF_ERROR(cudaSetDevice(device));
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) return static_cast<int>(spectrum<double>(kernels, n_pairs, m, fr, fi, tr, ti, t_ld, ur, ui, pad, s));
  return static_cast<int>(spectrum<float>(kernels, n_pairs, m, fr, fi, tr, ti, t_ld, ur, ui, pad, s));
}

// grids (K, I, I), spectra ur, ui (K, P, P) -> out (K, out_size, out_size),
// the slice [offset, offset + out_size)^2 of the full linear convolution.
// Scratch: tr, ti (K, P / 2 + 1, t_ld >= I); er, ei (K, P, P); t2r, t2i
// (K, P / 2 + 1, t2_ld >= out_size).  Every array is f64 when is_double, else f32.
extern "C" int dft_conv_launch(int device, int is_double, const void* grids, int n_pairs, int in_size,
                               const void* fr, const void* fi, const void* br, const void* bi, const void* ur,
                               const void* ui, void* tr, void* ti, int t_ld, void* er, void* ei, void* t2r, void* t2i,
                               int t2_ld, void* out, int out_size, int offset, int pad, void* stream) {
  RETURN_IF_ERROR(cudaSetDevice(device));
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return static_cast<int>(conv<double>(grids, n_pairs, in_size, fr, fi, br, bi, ur, ui, tr, ti, t_ld, er, ei, t2r,
                                         t2i, t2_ld, out, out_size, offset, pad, s));
  return static_cast<int>(conv<float>(grids, n_pairs, in_size, fr, fi, br, bi, ur, ui, tr, ti, t_ld, er, ei, t2r, t2i,
                                      t2_ld, out, out_size, offset, pad, s));
}
