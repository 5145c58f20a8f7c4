// Chunk-ELL SpMV/SpMM (the attic generation) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ginkgo_tpu/ops/attic/spmv_chunked.py::_cell_kernel (built by
// _build_cell_call, driven by cell_spmv_pallas).  For row
// r = t * 1024 + b * 128 + lane (superblock t, block b < 8) it computes
//
//     y[r, c] = sum_{v < Wv, s < 8} vals[t, b*Wv + v, s, lane] * x[col, c],
//     col = (xbase_row[t] + qid[(t*8 + b)*Wv + v]) * 128
//           + lanes[t, b*Wv + v, s, lane]   (int16),
//
// on the layout of ginkgo_tpu_torch/ops/attic/spmv_chunked.py::
// plan_chunked_layout (the formula of cell_spmv_reference).  The TPU kernel
// walks each vreg's one x chunk as a sublane read and a lane gather; here
// the column is computed per slot.
//
// Bound: bytes.  vals (f32) + lanes (int16) stream once per group of up to
// 8 right-hand sides, plus one qid a vreg; x is gathered and y written
// once.  One multiply-add a slot and column, far below the card's rate.
//
// Design, the simple one that is right first (as pell_spmv.cu):
//   * one thread per row; the 128 lanes of a slot are 128 consecutive rows,
//     so a warp's vals and lanes loads coalesce; qid is the same for the
//     whole 128-row block and is a broadcast load;
//   * each thread handles all K <= 8 columns of its row;
//   * x is gathered straight from device memory (window <= 16384 columns).
//     Padding vregs carry qid 0, lanes 0 and value 0; padding slots of a
//     live vreg carry its chunk.  Either may point past the last column, so
//     the gather is masked to col < m instead of padding x to
//     xpad_rows * 128: 0 * garbage never occurs;
//   * sums in f32 (the TPU kernel is f32 only, and so is this one).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

template <int K>
__global__ void __launch_bounds__(256)
cell_spmv_kernel(const float* __restrict__ vals,
                 const int16_t* __restrict__ lanes,
                 const int* __restrict__ qid,
                 const int* __restrict__ xbase_row, int Wv, long long n,
                 long long m, const float* __restrict__ x, long long ldx,
                 float* __restrict__ y, long long ldy) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long t = r >> 10;
  const long long blk = (r >> 7) & 7;
  const long long vreg0 = (t * 8 + blk) * Wv;  // first vreg of this block
  const long long slot0 = vreg0 * 1024 + (r & 127);
  const long long xbase = __ldg(xbase_row + t);
  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.f;
  for (int v = 0; v < Wv; ++v) {
    const long long colbase = (xbase + __ldg(qid + vreg0 + v)) * 128;
    const long long e0 = slot0 + (long long)v * 1024;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float w = __ldg(vals + e0 + s * 128);
      const long long col = colbase + __ldg(lanes + e0 + s * 128);
      if ((unsigned long long)col < (unsigned long long)m) {
        const float* xr = x + col * ldx;
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] += w * __ldg(xr + c);
      }
    }
  }
  float* yr = y + r * ldy;
#pragma unroll
  for (int c = 0; c < K; ++c) yr[c] = acc[c];
}

template <int K>
cudaError_t launch_k(const float* vals, const int16_t* lanes, const int* qid,
                     const int* xbase_row, int Wv, long long n, long long m,
                     const float* x, long long ldx, float* y, long long ldy,
                     cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  cell_spmv_kernel<K><<<(unsigned)blocks, threads, 0, stream>>>(
      vals, lanes, qid, xbase_row, Wv, n, m, x, ldx, y, ldy);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cell_spmv_launch(int vcode, int xcode, const void* vals,
                                const void* lanes, const void* qid,
                                const void* xbase_row, int Wv, long long n,
                                long long m, const void* x, long long ldx,
                                void* y, long long ldy, int k, void* stream) {
  if (vcode != kF32 || xcode != kF32 || n <= 0 || Wv <= 0)
    return cudaErrorInvalidValue;
  const float* v = static_cast<const float*>(vals);
  const int16_t* l = static_cast<const int16_t*>(lanes);
  const int* q = static_cast<const int*>(qid);
  const int* xb = static_cast<const int*>(xbase_row);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define GTS_CASE(K) \
  case K:           \
    return launch_k<K>(v, l, q, xb, Wv, n, m, xx, ldx, yy, ldy, st);
    GTS_CASE(1) GTS_CASE(2) GTS_CASE(3) GTS_CASE(4)
    GTS_CASE(5) GTS_CASE(6) GTS_CASE(7) GTS_CASE(8)
#undef GTS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* cell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
