// Banded (diagonal-offset) SpMV/SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ginkgo_tpu/ops/spmv_pallas.py::_dia_kernel
// (built by _build_dia_call, driven by dia_spmv_tpu).  It computes
//
//     y[i, c] = sum_d dvb[g, d, s, l] * x[i + off_d, c],
//     i = (g * S + s) * 128 + l,  0 <= i < n,  c < K <= 8,
//
// on the build-time blocked layout dvb (G, D, S, 128) of
// ginkgo_tpu_torch/ops/spmv_banded.py::block_diag_values.
//
// Bound: bytes.  Each diagonal value is used once per column, so the work is
// about one multiply-add per byte of dvb; the card's memory rate bounds it.
// The dvb stream (D * G * S * 128 values) dominates; x and y add one read
// and one write of n * K vectors.
//
// Design, the simple one that is right first:
//   * one thread per row i; for a fixed (g, d) the dvb addresses are
//     contiguous along i, so a warp's loads coalesce into full sectors;
//   * each thread handles all K columns of its row, so one dvb pass serves
//     up to 8 right-hand sides (the SpMM amortisation of the TPU kernel);
//   * x is read in place with a bounds check (0 <= i + off < n) instead of
//     the TPU kernel's LO/HI padded copy; the planner stores the clipped
//     boundary entries as 0, so the masked read gives the same sum;
//   * padded rows (n <= i < G*S*128) are neither computed nor written;
//   * sums are taken in f32 for f32/bf16/f16 storage with f32 vectors and in
//     f64 for f64 (the acc_dtype rule of spmv_pallas.py:184).
//
// Complex values (the TPU's dia_spmv_complex, spmv_pallas.py:246, which runs
// _dia_kernel twice over [x_re | x_im] because Mosaic has no complex vregs):
// the same kernel instantiated for interleaved complex types, as Ginkgo's own
// CUDA SpMV is.  A complex64 value is one 8-byte load (float2), x is gathered
// as float2, and each entry is one complex multiply-add in float2
// (y_re += a_re x_re - a_im x_im, y_im += a_re x_im + a_im x_re), so each
// matrix byte and each x element is read once a launch, with no second pass
// and no combine.  A real matrix with a complex x scales both parts by the
// real value; complex128 runs the same template in double2.  The sums are
// the TPU's up to order (one fused multiply-add an entry, where the TPU
// forms sum a_re x - sum a_im x).
// Left to later work: staging an x window in shared memory, cp.async or TMA
// staging of the dvb tiles, and vectorised (16-byte) bf16/f16 loads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };
enum ComplexTypeCode { kC64 = 4, kC128 = 5 };

__device__ __forceinline__ float load_acc(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load_acc(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_acc(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ float2 load_acc(const float2* p) { return __ldg(p); }
__device__ __forceinline__ double2 load_acc(const double2* p) {
  return __ldg(p);
}

// acc += w * x for a real or complex value w and a vector element x of the
// accumulator's type
__device__ __forceinline__ void madd(float& acc, float w, float x) {
  acc += w * x;
}
__device__ __forceinline__ void madd(double& acc, double w, double x) {
  acc += w * x;
}
__device__ __forceinline__ void madd(float2& acc, float w, float2 x) {
  acc.x += w * x.x;
  acc.y += w * x.y;
}
__device__ __forceinline__ void madd(float2& acc, float2 w, float2 x) {
  acc.x += w.x * x.x - w.y * x.y;
  acc.y += w.x * x.y + w.y * x.x;
}
__device__ __forceinline__ void madd(double2& acc, double2 w, double2 x) {
  acc.x += w.x * x.x - w.y * x.y;
  acc.y += w.x * x.y + w.y * x.x;
}

template <typename V, typename X, typename Acc, int K>
__global__ void __launch_bounds__(256)
dia_spmv_kernel(const V* __restrict__ dvb, const int* __restrict__ offsets,
                int D, int S, long long n, const X* __restrict__ x,
                long long ldx, X* __restrict__ y, long long ldy) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long sg = i >> 7;                 // 128-row sublane group
  const long long g = sg / S;
  const long long s = sg - g * S;
  const long long dstride = (long long)S * 128;
  const V* dv = dvb + g * D * dstride + s * 128 + (i & 127);
  Acc acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = Acc{};
  for (int d = 0; d < D; ++d) {
    const auto w = load_acc(dv + d * dstride);
    const long long j = i + __ldg(offsets + d);
    if (j >= 0 && j < n) {
      const X* xr = x + j * ldx;
#pragma unroll
      for (int c = 0; c < K; ++c) madd(acc[c], w, Acc(__ldg(xr + c)));
    }
  }
  X* yr = y + i * ldy;
#pragma unroll
  for (int c = 0; c < K; ++c) yr[c] = X(acc[c]);
}

template <typename V, typename X, typename Acc, int K>
cudaError_t launch_k(const void* dvb, const int* offsets, int D, int S,
                     long long n, const void* x, long long ldx, void* y,
                     long long ldy, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  dia_spmv_kernel<V, X, Acc, K><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(dvb), offsets, D, S, n,
      static_cast<const X*>(x), ldx, static_cast<X*>(y), ldy);
  return cudaGetLastError();
}

template <typename V, typename X, typename Acc>
cudaError_t launch_typed(int k, const void* dvb, const int* offsets, int D,
                         int S, long long n, const void* x, long long ldx,
                         void* y, long long ldy, cudaStream_t stream) {
  switch (k) {
#define GTS_CASE(K)                                                        \
  case K:                                                                  \
    return launch_k<V, X, Acc, K>(dvb, offsets, D, S, n, x, ldx, y, ldy,   \
                                  stream);
    GTS_CASE(1) GTS_CASE(2) GTS_CASE(3) GTS_CASE(4)
    GTS_CASE(5) GTS_CASE(6) GTS_CASE(7) GTS_CASE(8)
#undef GTS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dia_spmv_launch(int vcode, int xcode, const void* dvb,
                               const void* offsets, int D, int S,
                               long long n, const void* x, long long ldx,
                               void* y, long long ldy, int k, void* stream) {
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || D <= 0 || S <= 0) return cudaErrorInvalidValue;
  if (xcode == kF32 && vcode == kF32)
    return launch_typed<float, float, float>(k, dvb, offs, D, S, n, x, ldx,
                                             y, ldy, st);
  if (xcode == kF32 && vcode == kBF16)
    return launch_typed<__nv_bfloat16, float, float>(k, dvb, offs, D, S, n,
                                                     x, ldx, y, ldy, st);
  if (xcode == kF32 && vcode == kF16)
    return launch_typed<__half, float, float>(k, dvb, offs, D, S, n, x, ldx,
                                              y, ldy, st);
  if (xcode == kF64 && vcode == kF64)
    return launch_typed<double, double, double>(k, dvb, offs, D, S, n, x,
                                                ldx, y, ldy, st);
  if (xcode == kC64 && vcode == kC64)
    return launch_typed<float2, float2, float2>(k, dvb, offs, D, S, n, x,
                                                ldx, y, ldy, st);
  if (xcode == kC64 && vcode == kF32)
    return launch_typed<float, float2, float2>(k, dvb, offs, D, S, n, x, ldx,
                                               y, ldy, st);
  if (xcode == kC64 && vcode == kBF16)
    return launch_typed<__nv_bfloat16, float2, float2>(k, dvb, offs, D, S, n,
                                                       x, ldx, y, ldy, st);
  if (xcode == kC64 && vcode == kF16)
    return launch_typed<__half, float2, float2>(k, dvb, offs, D, S, n, x, ldx,
                                                y, ldy, st);
  if (xcode == kC128 && vcode == kC128)
    return launch_typed<double2, double2, double2>(k, dvb, offs, D, S, n, x,
                                                   ldx, y, ldy, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* dia_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
