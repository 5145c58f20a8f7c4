// Packed-slot windowed-ELL SpMV/SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ginkgo_tpu/ops/spmv_packed.py::_pell_kernel
// (built by _build_pell_call, driven by pell_spmv_tpu).  For row
// r = t * 1024 + b * 128 + lane (superblock t, block b < 8) it computes
//
//     y[r, c] = sum_{v < Wv, s < 8} vals[t, b*Wv + v, s, lane] * x[col, c],
//     col = (xbase_row[t] + 8 * qw[(t*8 + b)*Wv + v] + (idx >> 7)) * 128
//           + (idx & 127),    idx = idx[t, b*Wv + v, s, lane]  (int16),
//
// on the layout of ginkgo_tpu_torch/ops/spmv_packed.py::plan_packed_layout
// (the formula of pell_spmv_reference).
//
// Bound: bytes.  The vals + idx stream (Gs * 8 * Wv * 8 * 128 slots, padding
// included) dominates; x and y add one read and one write of the vectors.
// Each slot is one multiply-add per column, far below the card's rate.
//
// Design, the simple one that is right first:
//   * one thread per row; the 128 lanes of a slot are 128 consecutive rows,
//     so a warp's vals and idx loads coalesce; qw is the same for the whole
//     128-row block and is a broadcast load;
//   * each thread handles all K <= 8 columns of its row, so vals + idx stream
//     once per group of 8 right-hand sides;
//   * x is gathered straight from device memory (the window of a superblock
//     is at most 16384 columns, so the gathers mostly hit L1/L2).  Padded
//     lanes of a live slot carry the slot's chunk in their index and may
//     point past the last column: the gather is masked to col < m instead of
//     padding x to xpad_rows * 128 as the TPU kernel does;
//   * y is written (n, K) row-major directly, rows < n only: no superblock
//     pipeline padding and no output transpose;
//   * sums are taken in f32 for f32/bf16/f16 values with f32 vectors and in
//     f64 for f64.
// Left to later work: staging the x window (<= 64 KB at f32) in shared
// memory, cp.async or TMA staging of the vals/idx tiles, and vectorised
// (16-byte) loads of bf16/f16 values and int16 indices.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

__device__ __forceinline__ float load_acc(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load_acc(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_acc(const __half* p) {
  return __half2float(*p);
}

template <typename V, typename X, typename Acc, int K>
__global__ void __launch_bounds__(256)
pell_spmv_kernel(const V* __restrict__ vals, const int16_t* __restrict__ idx,
                 const int* __restrict__ qw,
                 const int* __restrict__ xbase_row, int Wv, long long n,
                 long long m, const X* __restrict__ x, long long ldx,
                 X* __restrict__ y, long long ldy) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long t = r >> 10;
  const long long blk = (r >> 7) & 7;
  const long long vreg0 = (t * 8 + blk) * Wv;  // first vreg of this block
  const long long slot0 = vreg0 * 1024 + (r & 127);
  const long long xbase = __ldg(xbase_row + t);
  Acc acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = Acc(0);
  for (int v = 0; v < Wv; ++v) {
    const long long rowbase = xbase + 8LL * __ldg(qw + vreg0 + v);
    const long long e0 = slot0 + (long long)v * 1024;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const Acc w = load_acc(vals + e0 + s * 128);
      const int id = __ldg(idx + e0 + s * 128);
      const long long col = (rowbase + (id >> 7)) * 128 + (id & 127);
      if ((unsigned long long)col < (unsigned long long)m) {
        const X* xr = x + col * ldx;
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] += w * Acc(__ldg(xr + c));
      }
    }
  }
  X* yr = y + r * ldy;
#pragma unroll
  for (int c = 0; c < K; ++c) yr[c] = X(acc[c]);
}

template <typename V, typename X, typename Acc, int K>
cudaError_t launch_k(const void* vals, const int16_t* idx, const int* qw,
                     const int* xbase_row, int Wv, long long n, long long m,
                     const void* x, long long ldx, void* y, long long ldy,
                     cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  pell_spmv_kernel<V, X, Acc, K><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(vals), idx, qw, xbase_row, Wv, n, m,
      static_cast<const X*>(x), ldx, static_cast<X*>(y), ldy);
  return cudaGetLastError();
}

template <typename V, typename X, typename Acc>
cudaError_t launch_typed(int k, const void* vals, const int16_t* idx,
                         const int* qw, const int* xbase_row, int Wv,
                         long long n, long long m, const void* x,
                         long long ldx, void* y, long long ldy,
                         cudaStream_t stream) {
  switch (k) {
#define GTS_CASE(K)                                                          \
  case K:                                                                    \
    return launch_k<V, X, Acc, K>(vals, idx, qw, xbase_row, Wv, n, m, x,     \
                                  ldx, y, ldy, stream);
    GTS_CASE(1) GTS_CASE(2) GTS_CASE(3) GTS_CASE(4)
    GTS_CASE(5) GTS_CASE(6) GTS_CASE(7) GTS_CASE(8)
#undef GTS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pell_spmv_launch(int vcode, int xcode, const void* vals,
                                const void* idx, const void* qw,
                                const void* xbase_row, int Wv, long long n,
                                long long m, const void* x, long long ldx,
                                void* y, long long ldy, int k, void* stream) {
  const int16_t* id = static_cast<const int16_t*>(idx);
  const int* q = static_cast<const int*>(qw);
  const int* xb = static_cast<const int*>(xbase_row);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || Wv <= 0) return cudaErrorInvalidValue;
  if (xcode == kF32 && vcode == kF32)
    return launch_typed<float, float, float>(k, vals, id, q, xb, Wv, n, m, x,
                                             ldx, y, ldy, st);
  if (xcode == kF32 && vcode == kBF16)
    return launch_typed<__nv_bfloat16, float, float>(k, vals, id, q, xb, Wv,
                                                     n, m, x, ldx, y, ldy,
                                                     st);
  if (xcode == kF32 && vcode == kF16)
    return launch_typed<__half, float, float>(k, vals, id, q, xb, Wv, n, m, x,
                                              ldx, y, ldy, st);
  if (xcode == kF64 && vcode == kF64)
    return launch_typed<double, double, double>(k, vals, id, q, xb, Wv, n, m,
                                                x, ldx, y, ldy, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* pell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
