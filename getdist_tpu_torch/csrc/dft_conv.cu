// Batched 2D linear convolution as DFT matrix products, for Hopper (sm_90a).
//
// Replaces getdist_tpu/ops/dft_conv.py:dft_conv_spectrum (_spec_kernel)
// and dft_conv2d (_conv_kernel).  With F the symmetric P x P DFT matrix
// (F = Fr + i Fi) and B = conj(F) / P (B = Br + i Bi):
//   spectrum:  U = F K F                       (6 real GEMMs per pair)
//   conv:      full = Re(B ((F G F) o U) B),   out = full[off:off+n, off:off+n]
//              (12 real GEMMs, one elementwise complex product)
//
// What bounds it: FMA throughput.  One conv is 12 * 2 * P^3 flops per pair
// (~590 GFLOP for 435 pairs at P = 384) against ~2 GB of intermediate
// traffic in f32, so it sits far above the ridge point in either type.
// The design is the plain one: every stage is a shared-memory tiled GEMM
// that may sum two products with a sign, intermediates live in device
// memory, the zero padding of the input frame is done by the operand loads
// (no padded copy), and the output slice is the last GEMM's epilogue.
// Two instantiations: f32 (FFMA, 128 x 128 block tile, 8 x 8 accumulators
// per thread) for the fused path, and f64 (DFMA, 64 x 64 block tile, 4 x 4
// accumulators, which keeps the double accumulators in registers) for the
// parity path, at any frame P that is a multiple of 128.  No tensor cores:
// TF32 / DMMA / wgmma variants are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBK = 8;

template <typename T>
struct Tile;

template <>
struct Tile<float> {
  static constexpr int BM = 128, BN = 128, TM = 8, TN = 8;
};

template <>
struct Tile<double> {
  static constexpr int BM = 64, BN = 64, TM = 4, TN = 4;
};

__device__ __forceinline__ float fmadd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return fma(a, b, c); }

// A square operand of a batched product: element (r, c) of batch b is
// p[b * batch_stride + r * ld + c] inside the valid x valid corner, 0 outside.
template <typename T>
struct Operand {
  const T* p;
  long long batch_stride;
  int ld;
  int valid;
};

template <typename T>
__device__ __forceinline__ T load(const Operand<T>& m, long long b, int r, int c) {
  return (r < m.valid && c < m.valid) ? m.p[b * m.batch_stride + static_cast<long long>(r) * m.ld + c] : T(0);
}

// TM (or TN) consecutive values of a shared-memory row: 16-byte loads for
// f32, scalar loads for f64.
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  const float4* v4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = v4[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_row(double (&dst)[N], const double* src) {
#pragma unroll
  for (int q = 0; q < N; ++q) dst[q] = src[q];
}

// C[b] = A1[b] B1[b] + sign2 * A2[b] B2[b] (second product when n_products == 2),
// all P x P; only the window [off, off + out_size)^2 of C is written, to a
// (batch, out_size, out_size) array.
template <typename T>
__global__ void __launch_bounds__((Tile<T>::BM / Tile<T>::TM) * (Tile<T>::BN / Tile<T>::TN))
    gemm_kernel(Operand<T> a1, Operand<T> b1, Operand<T> a2, Operand<T> b2, T sign2, int n_products, int pad, T* c,
                int out_off, int out_size) {
  constexpr int BM = Tile<T>::BM, BN = Tile<T>::BN, TM = Tile<T>::TM, TN = Tile<T>::TN;
  constexpr int kThreads = (BM / TM) * (BN / TN);
  __shared__ __align__(16) T as[kBK][BM];
  __shared__ __align__(16) T bs[kBK][BN];
  const long long batch = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  for (int prod = 0; prod < n_products; ++prod) {
    const Operand<T>& a = prod ? a2 : a1;
    const Operand<T>& b = prod ? b2 : b1;
    const T s = prod ? sign2 : T(1);
    for (int k0 = 0; k0 < pad; k0 += kBK) {
#pragma unroll
      for (int l = 0; l < (BM * kBK) / kThreads; ++l) {
        const int e = tid + l * kThreads;
        const int r = e / kBK;
        const int kk = e % kBK;
        as[kk][r] = s * load(a, batch, row0 + r, k0 + kk);
      }
#pragma unroll
      for (int l = 0; l < (kBK * BN) / kThreads; ++l) {
        const int e = tid + l * kThreads;
        const int kk = e / BN;
        const int cc = e % BN;
        bs[kk][cc] = load(b, batch, k0 + kk, col0 + cc);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        T ar[TM];
        T br[TN];
        load_row(ar, &as[kk][ty * TM]);
        load_row(br, &bs[kk][tx * TN]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmadd(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  T* out = c + batch * out_size * out_size;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i - out_off;
    if (r < 0 || r >= out_size) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = col0 + tx * TN + j - out_off;
      if (cc >= 0 && cc < out_size) out[static_cast<long long>(r) * out_size + cc] = acc[i][j];
    }
  }
}

// In place: (re, im) <- (re, im) * (ur, ui), elementwise complex product.
template <typename T>
__global__ void spectral_product_kernel(T* __restrict__ re, T* __restrict__ im, const T* __restrict__ ur,
                                        const T* __restrict__ ui, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const T a = re[i];
    const T b = im[i];
    const T c = ur[i];
    const T d = ui[i];
    re[i] = a * c - b * d;
    im[i] = a * d + b * c;
  }
}

template <typename T>
Operand<T> shared_matrix(const void* p, int pad) {
  return {static_cast<const T*>(p), 0, pad, pad};
}

template <typename T>
Operand<T> batched(const void* p, int size, int ld_valid) {
  return {static_cast<const T*>(p), static_cast<long long>(size) * size, ld_valid, ld_valid};
}

// Product of one or two terms over the full P x P frame.
template <typename T>
cudaError_t gemm(Operand<T> a1, Operand<T> b1, const Operand<T>* a2, const Operand<T>* b2, T sign2, int pad,
                 int batch, void* c, int out_off, int out_size, cudaStream_t stream) {
  constexpr int kThreads = (Tile<T>::BM / Tile<T>::TM) * (Tile<T>::BN / Tile<T>::TN);
  if (pad % Tile<T>::BM || pad % Tile<T>::BN) return cudaErrorInvalidValue;
  const dim3 grid(pad / Tile<T>::BN, pad / Tile<T>::BM, batch);
  gemm_kernel<T><<<grid, kThreads, 0, stream>>>(a1, b1, a2 ? *a2 : a1, b2 ? *b2 : b1, sign2, a2 ? 2 : 1, pad,
                                                static_cast<T*>(c), out_off, out_size);
  return cudaGetLastError();
}

#define RETURN_IF_ERROR(expr)                 \
  do {                                        \
    const cudaError_t err_ = (expr);          \
    if (err_ != cudaSuccess) return err_;     \
  } while (0)

// (tr, ti) = F X for a real batched X (I x I, zero padded to P).
template <typename T>
cudaError_t forward_left(const void* x, int in_size, const void* fr, const void* fi, void* tr, void* ti, int pad,
                         int batch, cudaStream_t s) {
  const Operand<T> xo{static_cast<const T*>(x), static_cast<long long>(in_size) * in_size, in_size, in_size};
  RETURN_IF_ERROR(gemm<T>(shared_matrix<T>(fr, pad), xo, nullptr, nullptr, T(0), pad, batch, tr, 0, pad, s));
  return gemm<T>(shared_matrix<T>(fi, pad), xo, nullptr, nullptr, T(0), pad, batch, ti, 0, pad, s);
}

// (ur, ui) = (tr + i ti) F
template <typename T>
cudaError_t forward_right(const void* tr, const void* ti, const void* fr, const void* fi, void* ur, void* ui, int pad,
                          int batch, cudaStream_t s) {
  const Operand<T> tro = batched<T>(tr, pad, pad);
  const Operand<T> tio = batched<T>(ti, pad, pad);
  const Operand<T> fro = shared_matrix<T>(fr, pad);
  const Operand<T> fio = shared_matrix<T>(fi, pad);
  RETURN_IF_ERROR(gemm<T>(tro, fro, &tio, &fio, T(-1), pad, batch, ur, 0, pad, s));
  return gemm<T>(tro, fio, &tio, &fro, T(1), pad, batch, ui, 0, pad, s);
}

template <typename T>
cudaError_t spectrum(const void* kernels, int n_pairs, int m, const void* fr, const void* fi, void* tr, void* ti,
                     void* ur, void* ui, int pad, cudaStream_t s) {
  RETURN_IF_ERROR(forward_left<T>(kernels, m, fr, fi, tr, ti, pad, n_pairs, s));
  return forward_right<T>(tr, ti, fr, fi, ur, ui, pad, n_pairs, s);
}

template <typename T>
cudaError_t conv(const void* grids, int n_pairs, int in_size, const void* fr, const void* fi, const void* br,
                 const void* bi, const void* ur, const void* ui, void* s0, void* s1, void* s2, void* s3, void* out,
                 int out_size, int offset, int pad, cudaStream_t s) {
  // U_h = F G F, then E = U_h o U (in place in s2, s3)
  RETURN_IF_ERROR(forward_left<T>(grids, in_size, fr, fi, s0, s1, pad, n_pairs, s));
  RETURN_IF_ERROR(forward_right<T>(s0, s1, fr, fi, s2, s3, pad, n_pairs, s));
  spectral_product_kernel<T><<<1024, 256, 0, s>>>(static_cast<T*>(s2), static_cast<T*>(s3),
                                                  static_cast<const T*>(ur), static_cast<const T*>(ui),
                                                  static_cast<long long>(n_pairs) * pad * pad);
  RETURN_IF_ERROR(cudaGetLastError());
  // T = B E (complex), out = Re(T B) restricted to the window
  const Operand<T> er = batched<T>(s2, pad, pad);
  const Operand<T> ei = batched<T>(s3, pad, pad);
  const Operand<T> bro = shared_matrix<T>(br, pad);
  const Operand<T> bio = shared_matrix<T>(bi, pad);
  RETURN_IF_ERROR(gemm<T>(bro, er, &bio, &ei, T(-1), pad, n_pairs, s0, 0, pad, s));
  RETURN_IF_ERROR(gemm<T>(bro, ei, &bio, &er, T(1), pad, n_pairs, s1, 0, pad, s));
  const Operand<T> t2r = batched<T>(s0, pad, pad);
  const Operand<T> t2i = batched<T>(s1, pad, pad);
  return gemm<T>(t2r, bro, &t2i, &bio, T(-1), pad, n_pairs, out, offset, out_size, s);
}

}  // namespace

// kernels (K, m, m) -> ur, ui (K, P, P); tr, ti are (K, P, P) scratch.
// Every array is f64 when is_double, else f32.
extern "C" int dft_spectrum_launch(int device, int is_double, const void* kernels, int n_pairs, int m,
                                   const void* fr, const void* fi, void* tr, void* ti, void* ur, void* ui, int pad,
                                   void* stream) {
  RETURN_IF_ERROR(cudaSetDevice(device));
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double) return static_cast<int>(spectrum<double>(kernels, n_pairs, m, fr, fi, tr, ti, ur, ui, pad, s));
  return static_cast<int>(spectrum<float>(kernels, n_pairs, m, fr, fi, tr, ti, ur, ui, pad, s));
}

// grids (K, I, I), spectra ur, ui (K, P, P) -> out (K, out_size, out_size),
// the slice [offset, offset + out_size)^2 of the full linear convolution.
// s0..s3 are (K, P, P) scratch.  Every array is f64 when is_double, else f32.
extern "C" int dft_conv_launch(int device, int is_double, const void* grids, int n_pairs, int in_size,
                               const void* fr, const void* fi, const void* br, const void* bi, const void* ur,
                               const void* ui, void* s0, void* s1, void* s2, void* s3, void* out, int out_size,
                               int offset, int pad, void* stream) {
  RETURN_IF_ERROR(cudaSetDevice(device));
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return static_cast<int>(conv<double>(grids, n_pairs, in_size, fr, fi, br, bi, ur, ui, s0, s1, s2, s3, out,
                                         out_size, offset, pad, s));
  return static_cast<int>(
      conv<float>(grids, n_pairs, in_size, fr, fi, br, bi, ur, ui, s0, s1, s2, s3, out, out_size, offset, pad, s));
}
