// Pair contraction y[po] += a[pl] * b[pu] for Hopper (sm_90a): kernels D
// and E.
//
// Kernel D (mode 0, the cumsum-difference scatter) replaces the Pallas TPU
// kernel ginkgo_tpu/ops/pair_contract.py::_pair_kernel_batched; kernel E
// (mode 1, the direct slot scatter) replaces ::_pair_kernel (the one-hot MXU
// scatter).  Both are built by _build_pair_call and driven by
// pair_contract_pallas there.  On the plan of
// ginkgo_tpu_torch/ops/pair_contract.py::plan_pair_contract, for output tile
// t (1024 slots) and each of its nv[t] live vregs v (1024 pair slots i):
//
//     prod[i] = a[(lbase[t] + lq[t,v]) * 128 + pls[t,v,i]]
//             * b[(ubase[t] + uq[t,v]) * 128 + pus[t,v,i]],
//
// with a and b read as zero beyond their lengths (the plan's zero padding to
// pad_rows * 128).  Padding slots of a live vreg carry pls = pus = 0, so
// their products are not zero: only the streams below keep them out of y.
//   D: cs = inclusive prefix of prod in flat (sublane, lane) order, and
//      y[o] += cs[pes[o] - 1] - cs[pesp[o] - 1] (cs[-1] = 0).  Pairs are
//      po-ascending in a vreg, so the pairs of slot o sit in
//      [pesp[o], pes[o]) and padding (after every pair) is never read.
//   E: y[pos[i]] += prod[i] for pos[i] < 1024 (padding carries 1024).
// The COO tail is added by the wrapper.  The plain version is
// ops/pair_contract.py::_planned_plain.
//
// Bound: bytes.  The contraction needs each planned pair's three int16
// indices (6 B), a, b and y read or written once, the per-vreg window
// starts and the per-tile tables; one multiply and one add a pair are far
// below the card's rate.  The kernels stream more: every slot of a live
// vreg, padding included (8 B a slot for D: pls, pus, pes, pesp; 6 B for
// E: pls, pus, pos), at a fill of about 0.25-0.3 on the FEM plans.
//
// Design, the simple one that is right first:
//   * one CTA of 1024 threads per output tile; thread i takes pair slot i
//     of each vreg (coalesced int16 loads) and, for D, output slot i;
//   * the gathers read a and b from device memory with __ldg.  The TPU
//     kernel DMAs the tile's whole window into VMEM, but a tile window here
//     reaches WUr = 512 rows x 128 x 4 B = 256 KB per operand, over the
//     227 KB of shared memory a block can use; the per-vreg windows are
//     local, and a and b (about 49 MB each on the 262,144-row FEM system's
//     level-3 universe) mostly stay in the 50 MB L2;
//   * D: a block-wide inclusive scan of the 1024 products, written by hand
//     (warp shuffles, then the per-warp totals scanned by warp 0 in shared
//     memory), into a shared cs; each thread then adds
//     cs[pes-1] - cs[pesp-1] of its output slot to a register accumulator.
//     f32 loses digits to the difference of two prefixes, as the TPU
//     kernel's does.  The order of the sums is fixed: deterministic;
//   * E: atomicAdd of each product into a 1024-entry shared accumulator at
//     its slot pos; the order of the sums changes from run to run;
//   * one coalesced write of the tile's y, rows >= n_out not written;
//   * the value type is the accumulation type: f32 and f64 instantiations
//     (the TPU kernel is f32 only).
// Left to later work: staging each vreg's windows in shared memory with
// cp.async or TMA ahead of its use, and more than one tile per CTA.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

constexpr int kOW = 1024;       // output slots per tile = pair slots a vreg
constexpr int kLanes = 128;
constexpr int kWarps = kOW / 32;

template <typename T>
__device__ __forceinline__ T gather(const T* __restrict__ x, long long len,
                                    long long i) {
  return (unsigned long long)i < (unsigned long long)len ? __ldg(x + i)
                                                         : T(0);
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

// Kernel D: cumsum-difference scatter.
template <typename T>
__global__ void __launch_bounds__(kOW)
pair_cumsum_kernel(const T* __restrict__ a, long long na,
                   const T* __restrict__ b, long long nb,
                   const int16_t* __restrict__ pls,
                   const int16_t* __restrict__ pus,
                   const int16_t* __restrict__ pes,
                   const int16_t* __restrict__ pesp,
                   const int* __restrict__ lq, const int* __restrict__ uq,
                   const int* __restrict__ nv, const int* __restrict__ lbase,
                   const int* __restrict__ ubase, int NV, long long n_out,
                   T* __restrict__ y) {
  __shared__ T cs[kOW];
  __shared__ T wsum[kWarps];
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int nvt = __ldg(nv + t);
  const long long abase = __ldg(lbase + t);
  const long long bbase = __ldg(ubase + t);
  T acc = T(0);
  for (int v = 0; v < nvt; ++v) {
    const long long vo = (long long)t * NV + v;
    const long long e = vo * kOW + i;
    const long long ia = (abase + __ldg(lq + vo)) * kLanes + __ldg(pls + e);
    const long long ib = (bbase + __ldg(uq + vo)) * kLanes + __ldg(pus + e);
    const int qe = __ldg(pes + e);
    const int qp = __ldg(pesp + e);
    T p = gather(a, na, ia) * gather(b, nb, ib);
    // block-wide inclusive scan; the last reads of wsum (vreg v) come
    // before the third barrier and those of cs before the first barrier of
    // vreg v+1, so one buffer of each is enough
    p = warp_inclusive_scan(p, lane);
    if (lane == 31) wsum[warp] = p;
    __syncthreads();
    if (warp == 0) wsum[lane] = warp_inclusive_scan(wsum[lane], lane);
    __syncthreads();
    cs[i] = warp > 0 ? p + wsum[warp - 1] : p;
    __syncthreads();
    const T ce = qe > 0 ? cs[qe - 1] : T(0);
    const T cp = qp > 0 ? cs[qp - 1] : T(0);
    acc += ce - cp;
  }
  const long long o = (long long)t * kOW + i;
  if (o < n_out) y[o] = acc;
}

// Kernel E: direct slot scatter into a shared tile accumulator.
template <typename T>
__global__ void __launch_bounds__(kOW)
pair_onehot_kernel(const T* __restrict__ a, long long na,
                   const T* __restrict__ b, long long nb,
                   const int16_t* __restrict__ pls,
                   const int16_t* __restrict__ pus,
                   const int16_t* __restrict__ pos,
                   const int* __restrict__ lq, const int* __restrict__ uq,
                   const int* __restrict__ nv, const int* __restrict__ lbase,
                   const int* __restrict__ ubase, int NV, long long n_out,
                   T* __restrict__ y) {
  __shared__ T acc[kOW];
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  acc[i] = T(0);
  __syncthreads();
  const int nvt = __ldg(nv + t);
  const long long abase = __ldg(lbase + t);
  const long long bbase = __ldg(ubase + t);
  for (int v = 0; v < nvt; ++v) {
    const long long vo = (long long)t * NV + v;
    const long long e = vo * kOW + i;
    const int q = __ldg(pos + e);
    if (q < 0 || q >= kOW) continue;       // padding slot
    const long long ia = (abase + __ldg(lq + vo)) * kLanes + __ldg(pls + e);
    const long long ib = (bbase + __ldg(uq + vo)) * kLanes + __ldg(pus + e);
    atomicAdd(&acc[q], gather(a, na, ia) * gather(b, nb, ib));
  }
  __syncthreads();
  const long long o = (long long)t * kOW + i;
  if (o < n_out) y[o] = acc[i];
}

template <typename T>
cudaError_t launch(int mode, const void* a, long long na, const void* b,
                   long long nb, const void* pls, const void* pus,
                   const void* s3, const void* s4, const void* lq,
                   const void* uq, const void* nv, const void* lbase,
                   const void* ubase, int T_tiles, int NV, long long n_out,
                   void* y, cudaStream_t st) {
  const T* av = static_cast<const T*>(a);
  const T* bv = static_cast<const T*>(b);
  const int16_t* l16 = static_cast<const int16_t*>(pls);
  const int16_t* u16 = static_cast<const int16_t*>(pus);
  const int16_t* q3 = static_cast<const int16_t*>(s3);
  const int* lqi = static_cast<const int*>(lq);
  const int* uqi = static_cast<const int*>(uq);
  const int* nvi = static_cast<const int*>(nv);
  const int* lbi = static_cast<const int*>(lbase);
  const int* ubi = static_cast<const int*>(ubase);
  T* yv = static_cast<T*>(y);
  if (mode == 0)
    pair_cumsum_kernel<T><<<T_tiles, kOW, 0, st>>>(
        av, na, bv, nb, l16, u16, q3, static_cast<const int16_t*>(s4), lqi,
        uqi, nvi, lbi, ubi, NV, n_out, yv);
  else
    pair_onehot_kernel<T><<<T_tiles, kOW, 0, st>>>(
        av, na, bv, nb, l16, u16, q3, lqi, uqi, nvi, lbi, ubi, NV, n_out, yv);
  return cudaGetLastError();
}

}  // namespace

// mode 0: kernel D (s3 = pes, s4 = pesp); mode 1: kernel E (s3 = pos, s4
// unused).  Streams are (T, NV, 1024) int16, lq/uq (T, NV) int32, nv, lbase,
// ubase (T,) int32; a and b hold na and nb values of the value type, y
// n_out <= T * 1024.
extern "C" int pair_contract_launch(int mode, int vcode, const void* a,
                                    long long na, const void* b, long long nb,
                                    const void* pls, const void* pus,
                                    const void* s3, const void* s4,
                                    const void* lq, const void* uq,
                                    const void* nv, const void* lbase,
                                    const void* ubase, int T_tiles, int NV,
                                    long long n_out, void* y, void* stream) {
  if ((mode != 0 && mode != 1) || (mode == 0 && s4 == nullptr) ||
      T_tiles <= 0 || NV <= 0 || n_out <= 0 ||
      n_out > (long long)T_tiles * kOW || na < 0 || nb < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vcode) {
    case kF32:
      return launch<float>(mode, a, na, b, nb, pls, pus, s3, s4, lq, uq, nv,
                           lbase, ubase, T_tiles, NV, n_out, y, st);
    case kF64:
      return launch<double>(mode, a, na, b, nb, pls, pus, s3, s4, lq, uq, nv,
                            lbase, ubase, T_tiles, NV, n_out, y, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pair_contract_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
