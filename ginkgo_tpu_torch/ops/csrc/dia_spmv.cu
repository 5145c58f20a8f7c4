// Banded (diagonal-offset) SpMV/SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ginkgo_tpu/ops/spmv_pallas.py::_dia_kernel
// (built by _build_dia_call, driven by dia_spmv_tpu).  It computes
//
//     y[i, c] = sum_d dvb[g, d, s, l] * x[i + off_d, c],
//     i = (g * S + s) * 128 + l,  0 <= i < n,  c < K (a launch's columns),
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
//   * real values take this kernel at K = 1 only (two or more real columns
//     take the wide instance below); complex ones at K <= 8, each thread
//     handling all K columns of its row, so one dvb pass serves up to 8
//     right-hand sides (the SpMM amortisation of the TPU kernel);
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
//
// The wide instance (dia_spmv_wide_kernel, dia_spmv_wide_launch) takes the
// real pairs at k >= 2, up to kWideCols = 16 columns a launch.  The narrow
// kernel above, run at k = 16, streamed dvb twice (two 8-column launches)
// and, worse, one thread a row read x[j, c] as scalars 4 * ldx bytes apart
// on neighbouring lanes: each load of a warp touched 16 cache lines for 128
// useful bytes, so it was bound by L1 wavefronts: 3.67 ms an apply at the
// HPCG 27-point system (n = 4,096,000, k = 16, f32), 7.8 % of its roofline.
// Bound of the wide instance: bytes.  There, 437 MB of band values (446 MB
// of dvb with the padding), 262 MB of x and 262 MB of y: 0.287 ms at
// 3.35 TB/s.  Its design:
//   * one launch reads dvb once for all its columns;
//   * lanes on columns: x and y are row-major (n, k), so a row's columns are
//     contiguous; P neighbouring lanes take neighbouring 16-byte pieces of
//     one row (a float4 or a double2).  A k that is no multiple of the
//     piece leaves a partial piece, read and written by scalars; a base or a
//     row stride that is not 16-byte aligned takes the scalar instantiation
//     (VEC = false) of the same kernel.  Nothing is copied or allocated;
//   * each thread walks a run of kWideRun consecutive rows and keeps their x
//     pieces in registers: at an offset one above the last (the stencil's
//     +-1 neighbours), the window slides by one row and one piece is read;
//   * the run's band values of one diagonal are contiguous: one vector load
//     (evict-first, as nothing reads them again), which all P lanes of the
//     row share in one request;
//   * the time is set by how many loads are in flight, so registers are
//     what it trades: 32-bit indices where every index fits (else 64-bit)
//     and at most 32 registers a thread keep 2048 threads on an SM.  CUDA
//     events at the shape above (tools/torch_dia_wide_probe.py): runs of 2
//     rows 0.552-0.558 ms, of 4 rows 0.570 (58 registers); 64-bit indices
//     0.60-0.73; reading band values two or three diagonals ahead, or
//     serving a whole offset triple from one window, cost registers and
//     ran slower (0.67-0.76);
//   * at 32 registers ptxas spills in the 32-bit instantiations: 4 B of
//     stores and 4 B of loads for f32, bf16 and f16 storage at P = 2 and 4,
//     8 / 24 B for f64 at P = 1 and 16 / 52 B at P = 2, 4 and 8.  The spill
//     stays in L1 and costs less than the threads it buys: at k = 16 the
//     spill-free 12 and 8 blocks an SM (40 and 64 registers) ran slower in
//     every pair, f32 0.599 / 0.599 against 0.553 ms, bf16 and f16 0.705 /
//     0.706 against 0.611, f64 1.477 / 1.645 against 1.338 (bounds 0.287,
//     0.222, 0.574 ms; the narrow kernel's two 8-column launches 3.67,
//     3.68, 7.23);
//   * blocks stay in ascending row order, so the x rows that the next plane
//     (offset +- nx ny) reads again are still in the 50 MB L2;
//   * the same arithmetic: per (row, column) one accumulator, one
//     multiply-add a diagonal in the plan's offset order, j outside [0, n)
//     skipped, so y is bit for bit the narrow kernel's, column by column.
// Left to later work: staging the x window in shared memory (cp.async or
// TMA) so that a warp's reads of x are whole cache lines (today each slot
// reads half a line), and vectorised bf16/f16 loads at k = 1.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

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

// the complex instantiations, K = 1 .. 8
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

// the real pairs, K = 1 (two or more columns take the wide instance)
template <typename V, typename X>
cudaError_t launch_real(int k, const void* dvb, const int* offsets, int D,
                        int S, long long n, const void* x, long long ldx,
                        void* y, long long ldy, cudaStream_t stream) {
  if (k != 1) return cudaErrorInvalidValue;
  return launch_k<V, X, X, 1>(dvb, offsets, D, S, n, x, ldx, y, ldy, stream);
}

// -- the wide instance --------------------------------------------------------

constexpr int kWideCols = 16;      // columns a launch
constexpr int kWideRun = 2;        // consecutive rows a thread walks
constexpr int kWideThreads = 128;
// blocks an SM holds, which caps the registers: 16 (2048 threads, 32
// registers) with 32-bit indices; 64-bit ones need more registers
template <typename I>
constexpr int kWideMinBlocks = sizeof(I) == 4 ? 16 : 8;

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }

// The band values of rows i0 .. i0 + R - 1 at one diagonal (contiguous, and
// aligned to R values when VEC), widened to the accumulator's type.
template <bool VEC, typename V, typename Acc, int R>
__device__ __forceinline__ void load_run(const V* __restrict__ p,
                                         Acc (&w)[R]) {
  constexpr int kBytes = R * (int)sizeof(V);
  V v[R];
  if constexpr (VEC && kBytes % 16 == 0) {
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p) + q);
      memcpy(reinterpret_cast<char*>(v) + 16 * q, &u, 16);
    }
  } else if constexpr (VEC && kBytes % 8 == 0) {
#pragma unroll
    for (int q = 0; q < kBytes / 8; ++q) {
      const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p) + q);
      memcpy(reinterpret_cast<char*>(v) + 8 * q, &u, 8);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = p[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) w[r] = to_acc(v[r]);
}

// The piece of a row at p: cols <= VW columns, one 16-byte load when whole
// and VEC, else scalars.
template <bool VEC, typename X, int VW>
__device__ __forceinline__ void load_piece(const X* __restrict__ p, int cols,
                                           X (&v)[VW]) {
  if (VEC && cols == VW) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(v, &u, 16);
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) v[e] = e < cols ? __ldg(p + e) : X(0);
  }
}

template <bool VEC, typename X, int VW>
__device__ __forceinline__ void store_piece(X* __restrict__ p, int cols,
                                            const X (&v)[VW]) {
  if (VEC && cols == VW) {
    uint4 u;
    memcpy(&u, v, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e)
      if (e < cols) p[e] = v[e];
  }
}

// y[i, c] = sum_d dvb[.., d, .., i] * x[i + off_d, c] for kc <= kWideCols
// columns: P lanes a row, lane p holding columns [p VW, p VW + VW) of a run
// of R rows.  X is also the accumulator's type (f32, or f64 for f64).  I
// indexes rows and elements: int where every index fits, else long long.
template <typename V, typename X, typename I, int P, bool VEC>
__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks<I>)
dia_spmv_wide_kernel(const V* __restrict__ dvb,
                     const int* __restrict__ offsets, int D, int S, I n,
                     const X* __restrict__ x, I ldx, X* __restrict__ y,
                     I ldy, int kc) {
  constexpr int VW = 16 / (int)sizeof(X);
  constexpr int R = kWideRun;
  const I t = blockIdx.x * (I)blockDim.x + threadIdx.x;
  const I i0 = t / P * R;
  const int c = (int)(t % P) * VW;
  const int cols = min(VW, kc - c);
  if (i0 >= n || cols <= 0) return;
  const I sg = i0 >> 7;  // the run lies in one 128-row group
  const I g = sg / S;
  const I dstride = (I)S * 128;
  const V* dv = dvb + (g * D * dstride + (sg - g * S) * 128 + (i0 & 127));
  const X* xc = x + c;
  X acc[R][VW];
  X win[R][VW];  // win[r] holds x[i0 + r + off, c ..] where in range
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[r][e] = X(0);
  int prev = 0;
  for (int d = 0; d < D; ++d) {
    const int off = __ldg(offsets + d);
    X w[R];
    load_run<VEC>(dv + d * dstride, w);
    if (d > 0 && off == prev + 1) {
#pragma unroll
      for (int r = 0; r + 1 < R; ++r)
#pragma unroll
        for (int e = 0; e < VW; ++e) win[r][e] = win[r + 1][e];
      const I j = i0 + (R - 1) + off;
      if (j >= 0 && j < n) load_piece<VEC>(xc + j * ldx, cols, win[R - 1]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const I j = i0 + r + off;
        if (j >= 0 && j < n) load_piece<VEC>(xc + j * ldx, cols, win[r]);
      }
    }
    prev = off;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const I j = i0 + r + off;
      if (j >= 0 && j < n) {
#pragma unroll
        for (int e = 0; e < VW; ++e) madd(acc[r][e], w[r], win[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (i0 + r < n) store_piece<VEC>(y + (i0 + r) * ldy + c, cols, acc[r]);
}

template <typename V, typename X, typename I, int P, bool VEC>
void launch_wide_k(long long blocks, const void* dvb, const int* offsets,
                   int D, int S, long long n, const void* x, long long ldx,
                   void* y, long long ldy, int kc, cudaStream_t stream) {
  dia_spmv_wide_kernel<V, X, I, P, VEC>
      <<<(unsigned)blocks, kWideThreads, 0, stream>>>(
          static_cast<const V*>(dvb), offsets, D, S, (I)n,
          static_cast<const X*>(x), (I)ldx, static_cast<X*>(y), (I)ldy, kc);
}

template <typename V, typename X, int P>
cudaError_t launch_wide_p(bool vec, const void* dvb, const int* offsets,
                          int D, int S, long long n, const void* x,
                          long long ldx, void* y, long long ldy, int kc,
                          cudaStream_t stream) {
  const long long threads = (n + kWideRun - 1) / kWideRun * P;
  const long long blocks = (threads + kWideThreads - 1) / kWideThreads;
  // the largest index the kernel forms: a thread, a row (i0 + r + off lies
  // in (-n, 2 n)), an element of x or y, an element of dvb (the band values
  // of the last row's group)
  const long long groups = ((n - 1) / 128) / S + 1;
  const long long most =
      std::max({blocks * kWideThreads, 2 * n, n * std::max(ldx, ldy),
                groups * D * S * 128LL});
  const bool i32 = most <= 0x7fffffffLL;
#define GTS_WIDE_K(I, VEC)                                                 \
  launch_wide_k<V, X, I, P, VEC>(blocks, dvb, offsets, D, S, n, x, ldx, y, \
                                 ldy, kc, stream);
  // the scalar path (unaligned operands) is for correctness, not speed:
  // one instantiation, 64-bit
  if (vec && i32) GTS_WIDE_K(int, true)
  else if (vec) GTS_WIDE_K(long long, true)
  else GTS_WIDE_K(long long, false)
#undef GTS_WIDE_K
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// P: the least power of two of lanes whose 16-byte pieces cover kc columns.
// The vector loads need 16-byte aligned bases and row strides.
template <typename V, typename X>
cudaError_t launch_wide(const void* dvb, const int* offsets, int D, int S,
                        long long n, const void* x, long long ldx, void* y,
                        long long ldy, int kc, cudaStream_t stream) {
  constexpr int VW = 16 / (int)sizeof(X);
  if (kc < 1 || kc > kWideCols) return cudaErrorInvalidValue;
  const bool vec = aligned16(dvb) && aligned16(x) && aligned16(y) &&
                   (ldx * (long long)sizeof(X)) % 16 == 0 &&
                   (ldy * (long long)sizeof(X)) % 16 == 0;
  const int pieces = (kc + VW - 1) / VW;
#define GTS_WIDE(P)                                                        \
  return launch_wide_p<V, X, P>(vec, dvb, offsets, D, S, n, x, ldx, y,     \
                                ldy, kc, stream);
  if (pieces <= 1) GTS_WIDE(1)
  if (pieces <= 2) GTS_WIDE(2)
  if (pieces <= 4) GTS_WIDE(4)
  if constexpr (kWideCols > 4 * VW) {
    if (pieces <= 8) GTS_WIDE(8)
  }
#undef GTS_WIDE
  return cudaErrorInvalidValue;
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
    return launch_real<float, float>(k, dvb, offs, D, S, n, x, ldx, y, ldy, st);
  if (xcode == kF32 && vcode == kBF16)
    return launch_real<__nv_bfloat16, float>(k, dvb, offs, D, S, n, x, ldx, y,
                                             ldy, st);
  if (xcode == kF32 && vcode == kF16)
    return launch_real<__half, float>(k, dvb, offs, D, S, n, x, ldx, y, ldy,
                                      st);
  if (xcode == kF64 && vcode == kF64)
    return launch_real<double, double>(k, dvb, offs, D, S, n, x, ldx, y, ldy,
                                       st);
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

// The wide instance: kc = 1 .. 16 columns of x (n, ldx) into y (n, ldy), real
// pairs only; the same arguments as dia_spmv_launch.
extern "C" int dia_spmv_wide_launch(int vcode, int xcode, const void* dvb,
                                    const void* offsets, int D, int S,
                                    long long n, const void* x, long long ldx,
                                    void* y, long long ldy, int kc,
                                    void* stream) {
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || D <= 0 || S <= 0) return cudaErrorInvalidValue;
  if (xcode == kF32 && vcode == kF32)
    return launch_wide<float, float>(dvb, offs, D, S, n, x, ldx, y, ldy, kc,
                                     st);
  if (xcode == kF32 && vcode == kBF16)
    return launch_wide<__nv_bfloat16, float>(dvb, offs, D, S, n, x, ldx, y,
                                             ldy, kc, st);
  if (xcode == kF32 && vcode == kF16)
    return launch_wide<__half, float>(dvb, offs, D, S, n, x, ldx, y, ldy, kc,
                                      st);
  if (xcode == kF64 && vcode == kF64)
    return launch_wide<double, double>(dvb, offs, D, S, n, x, ldx, y, ldy,
                                       kc, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* dia_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
