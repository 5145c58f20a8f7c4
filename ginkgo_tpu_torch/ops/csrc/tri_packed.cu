// Packed exact lower-triangular solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ginkgo_tpu/ops/tri_packed.py::_tri_kernel
// (built by _build_tri_call, driven by packed_trisolve_tpu).  On the plan of
// ginkgo_tpu_torch/ops/tri_packed.py::plan_packed_trisolve it scans the
// 256-row blocks t = 0 .. nb-1 in order and computes
//
//     x_t = inv_t @ (b_t - cross_t),
//     cross_t[s] = sum_{w < 4 nwv[t]} crossv[e] * x[(t - P) * 256 + crossi[e]],
//     e = ((t * Wv + w / 4) * 8 + (w % 4) * 2 + s / 128) * 128 + s % 128,
//
// the recurrence of packed_trisolve_reference.  Upper factors arrive
// flipped (flip = 1): row r of the solve is row n-1-r of b and x.
//
// Bound: bytes.  The lower triangles of the (nb, 256, 256) f32 inverses
// dominate (about n * 128 * 4 bytes); the nonzero int16 + f32 cross slots,
// b and x add little, and the
// arithmetic (one multiply-add per inverse entry and column) is far below
// the card's rate.  The blocks depend on each other in sequence.
//
// Design, the simple one that is right first:
//   * one CTA of 1024 threads scans all blocks for a group of up to 8
//     right-hand sides (a grid of ceil(k/8) CTAs, one launch per solve);
//   * cross term: thread (g, s) takes row s and the planes w = g, g+4, ...
//     of its block; it loads a chunk of (index, value) slots first, then
//     the x entries they name, so the loads of a chunk are in flight
//     together.  Slots whose column (t-P)*256 + idx is negative (padding in
//     the first P blocks) are skipped.  x of earlier blocks is read back
//     from the output, written by this CTA before a __syncthreads();
//   * the four partial sums meet in shared memory as rhs = b_t - cross_t;
//   * block solve: warp w takes rows w, w+32, ..., four at a time; each lane
//     loads two float4 of each row (coalesced 512-byte row segments) and
//     the warp reduces with shuffles.  The inverse of a lower triangle is
//     lower triangular (tri_inv.py builds it with exact zeros above the
//     diagonal), so the float4s wholly above the diagonal are not read:
//     about half of the inverse stream;
//   * rows >= n of the last block (identity inverse, zero b) are computed
//     and never written.
// Left to later work: one SM streams every block, so the solve runs at a
// single SM's memory rate.  Prefetching the inverses into L2 (or shared
// memory through TMA / cp.async) ahead of the chain, and a syncfree chain
// of blocks over many CTAs, are the next steps.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

constexpr int kS = 256;                 // rows per block
constexpr int kThreads = 1024;
constexpr int kGroups = kThreads / kS;  // plane groups of the cross term
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;               // cross slots in flight per thread
constexpr int kRowsPerStep = 4;         // inverse rows in flight per warp
constexpr int kMaxRhs = 8;

template <int K>
__global__ void __launch_bounds__(kThreads)
tri_packed_kernel(const float* __restrict__ inv,
                  const int16_t* __restrict__ crossi,
                  const float* __restrict__ crossv,
                  const int* __restrict__ nwv, int nb, int P, int Wv,
                  long long n, int flip, const float* __restrict__ b,
                  long long ldb, float* x, long long ldx, int k) {
  // cross partial sums of each plane group; part[0] then holds the rhs
  __shared__ __align__(16) float part[kGroups][K][kS];
  const int tid = threadIdx.x;
  const int s = tid % kS;
  const int g = tid / kS;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int c0 = blockIdx.x * K;
  const int kc = min(K, k - c0);

  for (int t = 0; t < nb; ++t) {
    // -- cross term of row s over planes g, g + 4, ...
    float acc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = 0.f;
    const int planes = 4 * __ldg(nwv + t);
    const long long col0 = (long long)(t - P) * kS;
    const long long tile0 = (long long)t * Wv;
    for (int w0 = g; w0 < planes; w0 += kGroups * kChunk) {
      int id[kChunk];
      float val[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int w = w0 + u * kGroups;
        id[u] = -1;
        val[u] = 0.f;
        if (w < planes) {
          const long long e =
              ((tile0 + (w >> 2)) * 8 + (w & 3) * 2 + (s >> 7)) * 128 +
              (s & 127);
          id[u] = __ldg(crossi + e);
          val[u] = __ldg(crossv + e);
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const long long col = col0 + id[u];
        if (id[u] >= 0 && col >= 0) {
          const float* xr = x + (flip ? n - 1 - col : col) * ldx + c0;
#pragma unroll
          for (int c = 0; c < K; ++c)
            if (c < kc) acc[c] += val[u] * xr[c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < K; ++c) part[g][c][s] = acc[c];
    __syncthreads();

    // -- rhs = b_t - cross_t
    if (g == 0) {
      const long long row = (long long)t * kS + s;
      const long long orow = flip ? n - 1 - row : row;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        float cross = 0.f;
#pragma unroll
        for (int h = 0; h < kGroups; ++h) cross += part[h][c][s];
        const float bv =
            (c < kc && row < n) ? __ldg(b + orow * ldb + c0 + c) : 0.f;
        part[0][c][s] = bv - cross;
      }
    }
    __syncthreads();

    // -- x_t = inv_t @ rhs, rows w, w + 32, ... of warp w
    const float* blk = inv + (long long)t * kS * kS;
    for (int i0 = warp; i0 < kS; i0 += kRowsPerStep * kWarps) {
      float4 a[kRowsPerStep][2];
#pragma unroll
      for (int h = 0; h < kRowsPerStep; ++h) {
        const int i = i0 + h * kWarps;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = q * 128 + 4 * lane;
          a[h][q] = j <= i ? __ldg(reinterpret_cast<const float4*>(
                                 blk + (long long)i * kS + j))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int h = 0; h < kRowsPerStep; ++h) {
        const int i = i0 + h * kWarps;
        float sum[K];
#pragma unroll
        for (int c = 0; c < K; ++c) {
          sum[c] = 0.f;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = q * 128 + 4 * lane;
            if (j <= i) {
              const float4 r =
                  *reinterpret_cast<const float4*>(&part[0][c][j]);
              sum[c] += a[h][q].x * r.x + a[h][q].y * r.y +
                        a[h][q].z * r.z + a[h][q].w * r.w;
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], off);
        }
        const long long row = (long long)t * kS + i;
        if (lane < kc && row < n) {
          float v = sum[0];
#pragma unroll
          for (int c = 1; c < K; ++c)
            if (lane == c) v = sum[c];
          x[(flip ? n - 1 - row : row) * ldx + c0 + lane] = v;
        }
      }
    }
    __syncthreads();
  }
}

template <int K>
cudaError_t launch_k(const float* inv, const int16_t* crossi,
                     const float* crossv, const int* nwv, int nb, int P,
                     int Wv, long long n, int flip, const float* b,
                     long long ldb, float* x, long long ldx, int k,
                     cudaStream_t stream) {
  const unsigned grid = (unsigned)((k + K - 1) / K);
  tri_packed_kernel<K><<<grid, kThreads, 0, stream>>>(
      inv, crossi, crossv, nwv, nb, P, Wv, n, flip, b, ldb, x, ldx, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tri_packed_launch(int xcode, const void* inv,
                                 const void* crossi, const void* crossv,
                                 const void* nwv, int nb, int P, int Wv,
                                 long long n, int flip, const void* b,
                                 long long ldb, void* x, long long ldx, int k,
                                 void* stream) {
  if (xcode != kF32 || n <= 0 || nb <= 0 || P <= 0 || Wv <= 0 || k <= 0 ||
      n > (long long)nb * kS)
    return cudaErrorInvalidValue;
  const float* iv = static_cast<const float*>(inv);
  const int16_t* ci = static_cast<const int16_t*>(crossi);
  const float* cv = static_cast<const float*>(crossv);
  const int* nw = static_cast<const int*>(nwv);
  const float* bb = static_cast<const float*>(b);
  float* xx = static_cast<float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k < kMaxRhs ? k : kMaxRhs) {
#define GTS_CASE(K)                                                          \
  case K:                                                                    \
    return launch_k<K>(iv, ci, cv, nw, nb, P, Wv, n, flip, bb, ldb, xx, ldx, \
                       k, st);
    GTS_CASE(1) GTS_CASE(2) GTS_CASE(3) GTS_CASE(4)
    GTS_CASE(5) GTS_CASE(6) GTS_CASE(7) GTS_CASE(8)
#undef GTS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* tri_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
