// Batched 2D linear convolution as DFT matrix products, for Hopper (sm_90a).
//
// Replaces getdist_tpu/ops/dft_conv.py:dft_conv_spectrum (_spec_kernel)
// and dft_conv2d (_conv_kernel).  With F the symmetric P x P DFT matrix
// (F = Fr + i Fi) and B = conj(F) / P (B = Br + i Bi):
//   spectrum:  U = F K F                       (4 real GEMMs per pair)
//   conv:      full = Re(B ((F G F) o U) B),   out = full[off:off+n, off:off+n]
//              (8 real GEMMs, one elementwise complex product)
//
// What bounds it: FP32 FFMA throughput.  One conv is 12 * 2 * P^3 flops
// per pair (~590 GFLOP for 435 pairs at P = 384) against ~2 GB of
// intermediate traffic, so it sits far above the FP32 ridge point.  The
// design is the plain one: every stage is a shared-memory tiled SGEMM
// (128 x 128 block tile, 8 x 8 accumulators per thread) that may sum two
// products with a sign, intermediates live in device memory, the zero
// padding of the input frame is done by the operand loads (no padded
// copy), and the output slice is the last GEMM's epilogue.  No tensor
// cores: TF32 / 3xTF32 / wgmma variants are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kTM = 8;
constexpr int kTN = 8;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

// A square operand of a batched product: element (r, c) of batch b is
// p[b * batch_stride + r * ld + c] inside the valid x valid corner, 0 outside.
struct Operand {
  const float* p;
  long long batch_stride;
  int ld;
  int valid;
};

__device__ __forceinline__ float load(const Operand& m, long long b, int r, int c) {
  return (r < m.valid && c < m.valid) ? m.p[b * m.batch_stride + static_cast<long long>(r) * m.ld + c] : 0.f;
}

// C[b] = A1[b] B1[b] + sign2 * A2[b] B2[b] (second product when n_products == 2),
// all P x P; only the window [off, off + out_size)^2 of C is written, to a
// (batch, out_size, out_size) array.
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(Operand a1, Operand b1, Operand a2, Operand b2, float sign2, int n_products, int pad, float* c,
                int out_off, int out_size) {
  __shared__ __align__(16) float as[kBK][kBM];
  __shared__ __align__(16) float bs[kBK][kBN];
  const long long batch = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int prod = 0; prod < n_products; ++prod) {
    const Operand& a = prod ? a2 : a1;
    const Operand& b = prod ? b2 : b1;
    const float s = prod ? sign2 : 1.f;
    for (int k0 = 0; k0 < pad; k0 += kBK) {
#pragma unroll
      for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
        const int e = tid + l * kThreads;
        const int r = e / kBK;
        const int kk = e % kBK;
        as[kk][r] = s * load(a, batch, row0 + r, k0 + kk);
      }
#pragma unroll
      for (int l = 0; l < (kBK * kBN) / kThreads; ++l) {
        const int e = tid + l * kThreads;
        const int kk = e / kBN;
        const int cc = e % kBN;
        bs[kk][cc] = load(b, batch, k0 + kk, col0 + cc);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float ar[kTM];
        float br[kTN];
        const float4* arow = reinterpret_cast<const float4*>(&as[kk][ty * kTM]);
        const float4* brow = reinterpret_cast<const float4*>(&bs[kk][tx * kTN]);
#pragma unroll
        for (int q = 0; q < kTM / 4; ++q) {
          const float4 v = arow[q];
          ar[4 * q] = v.x;
          ar[4 * q + 1] = v.y;
          ar[4 * q + 2] = v.z;
          ar[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < kTN / 4; ++q) {
          const float4 v = brow[q];
          br[4 * q] = v.x;
          br[4 * q + 1] = v.y;
          br[4 * q + 2] = v.z;
          br[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* out = c + batch * out_size * out_size;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i - out_off;
    if (r < 0 || r >= out_size) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int cc = col0 + tx * kTN + j - out_off;
      if (cc >= 0 && cc < out_size) out[static_cast<long long>(r) * out_size + cc] = acc[i][j];
    }
  }
}

// In place: (re, im) <- (re, im) * (ur, ui), elementwise complex product.
__global__ void spectral_product_kernel(float* __restrict__ re, float* __restrict__ im, const float* __restrict__ ur,
                                        const float* __restrict__ ui, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float a = re[i];
    const float b = im[i];
    const float c = ur[i];
    const float d = ui[i];
    re[i] = a * c - b * d;
    im[i] = a * d + b * c;
  }
}

Operand shared_matrix(const void* p, int pad) { return {static_cast<const float*>(p), 0, pad, pad}; }

Operand batched(const void* p, int size, int ld_valid) {
  return {static_cast<const float*>(p), static_cast<long long>(size) * size, ld_valid, ld_valid};
}

// Product of one or two terms over the full P x P frame.
cudaError_t gemm(Operand a1, Operand b1, const Operand* a2, const Operand* b2, float sign2, int pad, int batch,
                 void* c, int out_off, int out_size, cudaStream_t stream) {
  const dim3 grid(pad / kBN, pad / kBM, batch);
  gemm_kernel<<<grid, kThreads, 0, stream>>>(a1, b1, a2 ? *a2 : a1, b2 ? *b2 : b1, sign2, a2 ? 2 : 1, pad,
                                             static_cast<float*>(c), out_off, out_size);
  return cudaGetLastError();
}

#define RETURN_IF_ERROR(expr)                 \
  do {                                        \
    const cudaError_t err_ = (expr);          \
    if (err_ != cudaSuccess) return err_;     \
  } while (0)

// (tr, ti) = F X for a real batched X (I x I, zero padded to P).
cudaError_t forward_left(const void* x, int in_size, const void* fr, const void* fi, void* tr, void* ti, int pad,
                         int batch, cudaStream_t s) {
  const Operand xo{static_cast<const float*>(x), static_cast<long long>(in_size) * in_size, in_size, in_size};
  RETURN_IF_ERROR(gemm(shared_matrix(fr, pad), xo, nullptr, nullptr, 0.f, pad, batch, tr, 0, pad, s));
  return gemm(shared_matrix(fi, pad), xo, nullptr, nullptr, 0.f, pad, batch, ti, 0, pad, s);
}

// (ur, ui) = (tr + i ti) F
cudaError_t forward_right(const void* tr, const void* ti, const void* fr, const void* fi, void* ur, void* ui, int pad,
                          int batch, cudaStream_t s) {
  const Operand tro = batched(tr, pad, pad);
  const Operand tio = batched(ti, pad, pad);
  const Operand fro = shared_matrix(fr, pad);
  const Operand fio = shared_matrix(fi, pad);
  RETURN_IF_ERROR(gemm(tro, fro, &tio, &fio, -1.f, pad, batch, ur, 0, pad, s));
  return gemm(tro, fio, &tio, &fro, 1.f, pad, batch, ui, 0, pad, s);
}

cudaError_t spectral_product(void* re, void* im, const void* ur, const void* ui, long long n, cudaStream_t s) {
  spectral_product_kernel<<<1024, 256, 0, s>>>(static_cast<float*>(re), static_cast<float*>(im),
                                               static_cast<const float*>(ur), static_cast<const float*>(ui), n);
  return cudaGetLastError();
}

}  // namespace

// kernels (K, m, m) f32 -> ur, ui (K, P, P); tr, ti are (K, P, P) scratch.
extern "C" int dft_spectrum_launch(int device, const void* kernels, int n_pairs, int m, const void* fr,
                                   const void* fi, void* tr, void* ti, void* ur, void* ui, int pad, void* stream) {
  RETURN_IF_ERROR(cudaSetDevice(device));
  auto s = static_cast<cudaStream_t>(stream);
  RETURN_IF_ERROR(forward_left(kernels, m, fr, fi, tr, ti, pad, n_pairs, s));
  return static_cast<int>(forward_right(tr, ti, fr, fi, ur, ui, pad, n_pairs, s));
}

// grids (K, I, I) f32, spectra ur, ui (K, P, P) -> out (K, out_size, out_size),
// the slice [offset, offset + out_size)^2 of the full linear convolution.
// s0..s3 are (K, P, P) scratch.
extern "C" int dft_conv_launch(int device, const void* grids, int n_pairs, int in_size, const void* fr,
                               const void* fi, const void* br, const void* bi, const void* ur, const void* ui,
                               void* s0, void* s1, void* s2, void* s3, void* out, int out_size, int offset, int pad,
                               void* stream) {
  RETURN_IF_ERROR(cudaSetDevice(device));
  auto s = static_cast<cudaStream_t>(stream);
  // U_h = F G F, then E = U_h o U (in place in s2, s3)
  RETURN_IF_ERROR(forward_left(grids, in_size, fr, fi, s0, s1, pad, n_pairs, s));
  RETURN_IF_ERROR(forward_right(s0, s1, fr, fi, s2, s3, pad, n_pairs, s));
  RETURN_IF_ERROR(spectral_product(s2, s3, ur, ui, static_cast<long long>(n_pairs) * pad * pad, s));
  // T = B E (complex), out = Re(T B) restricted to the window
  const Operand er = batched(s2, pad, pad);
  const Operand ei = batched(s3, pad, pad);
  const Operand bro = shared_matrix(br, pad);
  const Operand bio = shared_matrix(bi, pad);
  RETURN_IF_ERROR(gemm(bro, er, &bio, &ei, -1.f, pad, n_pairs, s0, 0, pad, s));
  RETURN_IF_ERROR(gemm(bro, ei, &bio, &er, 1.f, pad, n_pairs, s1, 0, pad, s));
  const Operand t2r = batched(s0, pad, pad);
  const Operand t2i = batched(s1, pad, pad);
  return static_cast<int>(gemm(t2r, bro, &t2i, &bio, -1.f, pad, n_pairs, out, offset, out_size, s));
}
