// Compact sliced-ELL SpMV/SpMM for Hopper (sm_90a): kernels B, G and H.
//
// Replaces three Pallas TPU kernels that compute the same function on three
// slab layouts:
//   B  ginkgo_tpu/ops/spmv_packed.py::_pell_kernel (packed-slot windowed ELL,
//      built by _build_pell_call, driven by pell_spmv_tpu);
//   G  ginkgo_tpu/ops/attic/spmv_windowed.py::_well_kernel (windowed ELL,
//      built by _build_well_call, driven by well_spmv_pallas);
//   H  ginkgo_tpu/ops/attic/spmv_chunked.py::_cell_kernel (chunk ELL, built
//      by _build_cell_call, driven by cell_spmv_pallas).
// Each slab gives a 128-row block (H: a block and x chunk) as many slots as
// its densest row, rounded up to vregs of 8, for the TPU's sublane/lane
// gathers: the packed main-path slab holds 3.6x the kept entries, H's FEM
// slab 5.5x.
// Read as they are, they floor any kernel at the slab's bytes.  So
// ginkgo_tpu_torch/ops/spmv_sell.py repacks each slab once, at set-up,
// into the stream this kernel reads, padding lanes (value 0) dropped:
//
//   slice s = rows [32 s, 32 s + 32), a warp (32 slices a 1024-row
//   superblock); entry j of lane l at e = sp[s] + 32 j + l; value sv[e] (the
//   slab's value type), column 128 * xbase[s >> 5] + sc[e] (sc int16, in the
//   superblock's x window of at most 16384 columns);
//
//   y[r, c] = sum_j sv[e] * x[col(e), c], over the row's entries in the
//   slab's order, which is the order the slab kernels summed in.
//
// Bound: bytes.  The kept entries' values and int16 columns (6 B an entry
// at f32), x read once and y written once; the slice padding adds 2 % on
// the packed main-path matrix and 28 % on the FEM matrix.  One multiply-add
// an entry and column, far below the card's rate.
//
// Design:
//   * a thread a row, a warp a slice: each step j loads 32 consecutive
//     values (128 B at f32) and 32 int16 columns (64 B), coalesced;
//   * j unrolled by U = 8 for K <= 2 columns, by 4 above (the gathered x
//     values of a pass take U * K registers): each step's value and
//     column load and then its x gather, all U steps before the
//     multiply-adds, so loads stay in flight;
//   * a single column with unit strides (k = 1, the solvers' SpMV) gets
//     its own instance without the row-stride multiply of each gather;
//   * x gathered through the read-only path (__ldg): on the main-path
//     matrices x is at most 4 MB and stays in the 50 MB L2; the gather is
//     masked to col < m;
//   * all K <= 8 right-hand sides in one pass, so the stream is read once a
//     group of 8 columns; y written (n, K) row-major, rows < n only;
//   * sums in f32 for f32/bf16/f16 values with f32 vectors, in f64 for f64.
//
// Complex values (the TPU's pell_spmv_complex, spmv_packed.py:411, two real
// passes of _pell_kernel over [x_re | x_im] sharing the index stream): the
// same kernel instantiated for interleaved complex types.  The stream keeps
// a lane where the complex value is nonzero (one mask over both parts), a
// complex64 value is one 8-byte load (float2) and x is gathered as float2;
// each entry is one complex multiply-add in float2, so the values, the
// columns and x are read once a launch.  A real matrix with a complex x
// scales both parts by the real value; complex128 runs in double2.  Sums
// are the TPU's up to order.
// Not kept: staging the superblock's x window in shared memory, one block
// of 1024 threads a superblock (tools/torch_sell_probe.py, K = 1): faster
// on the FEM matrix (a 16 KB window), slower on the packed main-path
// matrix (64 KB windows, 64 MB copied from L2 in all, two blocks an SM);
// at K = 8 a 16384-column window is 512 KB.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

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

template <typename V, typename X, typename Acc, int K, bool kUnit>
__global__ void __launch_bounds__(256)
sell_spmv_kernel(const V* __restrict__ sv, const int16_t* __restrict__ sc,
                 const long long* __restrict__ sp,
                 const int* __restrict__ xbase, long long n_slices,
                 long long n, long long m, const X* __restrict__ x,
                 long long ldx, X* __restrict__ y, long long ldy) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long s = r >> 5;
  if (s >= n_slices) return;
  const long long start = __ldg(sp + s);
  const long long width = (__ldg(sp + s + 1) - start) >> 5;
  const long long base = 128LL * __ldg(xbase + (s >> 5));
  const long long sx = kUnit ? 1 : ldx;     // x's row stride
  const V* v = sv + start + (r & 31);
  const int16_t* c16 = sc + start + (r & 31);
  constexpr int kUnroll = K <= 2 ? 8 : 4;     // steps of j a pass
  using W = decltype(load_acc(v));            // a value as it is summed
  Acc acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = Acc{};
  long long j = 0;
  for (; j + kUnroll <= width; j += kUnroll) {
    W w[kUnroll];
    Acc xv[kUnroll][K];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = load_acc(v + (j + u) * 32);
      const long long col = base + __ldg(c16 + (j + u) * 32);
      const bool ok = (unsigned long long)col < (unsigned long long)m;
      const X* xr = x + (ok ? col : 0) * sx;
#pragma unroll
      for (int c = 0; c < K; ++c) xv[u][c] = ok ? Acc(__ldg(xr + c)) : Acc{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < K; ++c) madd(acc[c], w[u], xv[u][c]);
    }
  }
  for (; j < width; ++j) {
    const W w = load_acc(v + j * 32);
    const long long col = base + __ldg(c16 + j * 32);
    if ((unsigned long long)col < (unsigned long long)m) {
      const X* xr = x + col * sx;
#pragma unroll
      for (int c = 0; c < K; ++c) madd(acc[c], w, Acc(__ldg(xr + c)));
    }
  }
  if (r >= n) return;
  X* yr = y + r * (kUnit ? 1 : ldy);
#pragma unroll
  for (int c = 0; c < K; ++c) yr[c] = X(acc[c]);
}

template <typename V, typename X, typename Acc, int K, bool kUnit = false>
cudaError_t launch_k(const void* sv, const int16_t* sc, const long long* sp,
                     const int* xbase, long long n_slices, long long n,
                     long long m, const void* x, long long ldx, void* y,
                     long long ldy, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n_slices * 32 + threads - 1) / threads;
  sell_spmv_kernel<V, X, Acc, K, kUnit><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(sv), sc, sp, xbase, n_slices, n, m,
      static_cast<const X*>(x), ldx, static_cast<X*>(y), ldy);
  return cudaGetLastError();
}

template <typename V, typename X, typename Acc>
cudaError_t launch_typed(int k, const void* sv, const int16_t* sc,
                         const long long* sp, const int* xbase,
                         long long n_slices, long long n, long long m,
                         const void* x, long long ldx, void* y, long long ldy,
                         cudaStream_t stream) {
  if (k == 1 && ldx == 1 && ldy == 1)
    return launch_k<V, X, Acc, 1, true>(sv, sc, sp, xbase, n_slices, n, m,
                                        x, ldx, y, ldy, stream);
  switch (k) {
#define GTS_CASE(K)                                                        \
  case K:                                                                  \
    return launch_k<V, X, Acc, K>(sv, sc, sp, xbase, n_slices, n, m, x,    \
                                  ldx, y, ldy, stream);
    GTS_CASE(1) GTS_CASE(2) GTS_CASE(3) GTS_CASE(4)
    GTS_CASE(5) GTS_CASE(6) GTS_CASE(7) GTS_CASE(8)
#undef GTS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int sell_spmv_launch(int vcode, int xcode, const void* sv,
                                const void* sc, const void* sp,
                                const void* xbase, long long n_slices,
                                long long n, long long m, const void* x,
                                long long ldx, void* y, long long ldy, int k,
                                void* stream) {
  const int16_t* c = static_cast<const int16_t*>(sc);
  const long long* p = static_cast<const long long*>(sp);
  const int* xb = static_cast<const int*>(xbase);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_slices <= 0 || n > n_slices * 32)
    return cudaErrorInvalidValue;
  if (xcode == kF32 && vcode == kF32)
    return launch_typed<float, float, float>(k, sv, c, p, xb, n_slices, n, m,
                                             x, ldx, y, ldy, st);
  if (xcode == kF32 && vcode == kBF16)
    return launch_typed<__nv_bfloat16, float, float>(k, sv, c, p, xb,
                                                     n_slices, n, m, x, ldx,
                                                     y, ldy, st);
  if (xcode == kF32 && vcode == kF16)
    return launch_typed<__half, float, float>(k, sv, c, p, xb, n_slices, n, m,
                                              x, ldx, y, ldy, st);
  if (xcode == kF64 && vcode == kF64)
    return launch_typed<double, double, double>(k, sv, c, p, xb, n_slices, n,
                                                m, x, ldx, y, ldy, st);
  if (xcode == kC64 && vcode == kC64)
    return launch_typed<float2, float2, float2>(k, sv, c, p, xb, n_slices, n,
                                                m, x, ldx, y, ldy, st);
  if (xcode == kC64 && vcode == kF32)
    return launch_typed<float, float2, float2>(k, sv, c, p, xb, n_slices, n,
                                               m, x, ldx, y, ldy, st);
  if (xcode == kC64 && vcode == kBF16)
    return launch_typed<__nv_bfloat16, float2, float2>(
        k, sv, c, p, xb, n_slices, n, m, x, ldx, y, ldy, st);
  if (xcode == kC64 && vcode == kF16)
    return launch_typed<__half, float2, float2>(k, sv, c, p, xb, n_slices, n,
                                                m, x, ldx, y, ldy, st);
  if (xcode == kC128 && vcode == kC128)
    return launch_typed<double2, double2, double2>(k, sv, c, p, xb, n_slices,
                                                   n, m, x, ldx, y, ldy, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* sell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
