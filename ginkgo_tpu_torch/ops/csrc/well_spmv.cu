// Windowed-ELL SpMV/SpMM (the attic generation) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ginkgo_tpu/ops/attic/spmv_windowed.py::_well_kernel (built by
// _build_well_call, driven by well_spmv_pallas).  For row
// r = t * 1024 + b * 128 + lane (superblock t, block b < 8) it computes
//
//     y[r, c] = sum_{j < w8, s < 8} vals[t, b*w8 + j, s, lane] * x[col, c],
//     col = xbase_row[t] * 128 + c16[t, b*w8 + j, s, lane]   (int16),
//
// on the layout of ginkgo_tpu_torch/ops/attic/spmv_windowed.py::
// plan_windowed_layout (the formula of well_spmv_reference; w = 8 * w8).
// The TPU kernel reaches the same columns through a per-vreg chunk base q0,
// a sublane gather and an H-way select; that is a TPU register trick, and
// the function needs neither q0 nor H, so this kernel reads neither.
//
// Bound: bytes.  vals (f32) + c16 (int16) stream once per group of up to 8
// right-hand sides; x is gathered and y written once.  One multiply-add a
// slot and column, far below the card's rate.
//
// Design, the simple one that is right first:
//   * one thread per row; the 128 lanes of a slot are 128 consecutive rows,
//     so a warp's vals and c16 loads coalesce;
//   * each thread handles all K <= 8 columns of its row;
//   * x is gathered straight from device memory (a superblock's window is
//     at most 16384 columns, so the gathers mostly hit L1/L2).  Empty slots
//     carry value 0 and the column smin * 128, which may lie past the last
//     column: the gather is masked to col < m instead of padding x to
//     xpad_rows * 128 as the TPU kernel does, so 0 * garbage never occurs;
//   * sums in f32 (the TPU kernel is f32 only, and so is this one).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

template <int K>
__global__ void __launch_bounds__(256)
well_spmv_kernel(const float* __restrict__ vals,
                 const int16_t* __restrict__ c16,
                 const int* __restrict__ xbase_row, int w, long long n,
                 long long m, const float* __restrict__ x, long long ldx,
                 float* __restrict__ y, long long ldy) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long t = r >> 10;
  const long long blk = (r >> 7) & 7;
  const int w8 = w >> 3;
  // slot (j, s) of this row: ((t * w + blk * w8 + j) * 8 + s) * 128 + lane
  const long long e0 = ((t * w + blk * w8) * 8) * 128 + (r & 127);
  const long long xbase = 128LL * __ldg(xbase_row + t);
  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.f;
  for (int q = 0; q < w; ++q) {          // q = 8 * j + s
    const long long e = e0 + (long long)q * 128;
    const float v = __ldg(vals + e);
    const long long col = xbase + __ldg(c16 + e);
    if ((unsigned long long)col < (unsigned long long)m) {
      const float* xr = x + col * ldx;
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] += v * __ldg(xr + c);
    }
  }
  float* yr = y + r * ldy;
#pragma unroll
  for (int c = 0; c < K; ++c) yr[c] = acc[c];
}

template <int K>
cudaError_t launch_k(const float* vals, const int16_t* c16,
                     const int* xbase_row, int w, long long n, long long m,
                     const float* x, long long ldx, float* y, long long ldy,
                     cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  well_spmv_kernel<K><<<(unsigned)blocks, threads, 0, stream>>>(
      vals, c16, xbase_row, w, n, m, x, ldx, y, ldy);
  return cudaGetLastError();
}

}  // namespace

extern "C" int well_spmv_launch(int vcode, int xcode, const void* vals,
                                const void* c16, const void* xbase_row, int w,
                                long long n, long long m, const void* x,
                                long long ldx, void* y, long long ldy, int k,
                                void* stream) {
  if (vcode != kF32 || xcode != kF32 || n <= 0 || w <= 0 || (w & 7) != 0)
    return cudaErrorInvalidValue;
  const float* v = static_cast<const float*>(vals);
  const int16_t* c = static_cast<const int16_t*>(c16);
  const int* xb = static_cast<const int*>(xbase_row);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define GTS_CASE(K) \
  case K:           \
    return launch_k<K>(v, c, xb, w, n, m, xx, ldx, yy, ldy, st);
    GTS_CASE(1) GTS_CASE(2) GTS_CASE(3) GTS_CASE(4)
    GTS_CASE(5) GTS_CASE(6) GTS_CASE(7) GTS_CASE(8)
#undef GTS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* well_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
