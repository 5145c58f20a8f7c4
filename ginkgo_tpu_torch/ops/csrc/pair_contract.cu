// Pair contraction y[po] += a[pl] * b[pu] for Hopper (sm_90a): kernels D
// and E.
//
// Kernel D (mode 0, a deterministic segmented sum) replaces the Pallas TPU
// kernel ginkgo_tpu/ops/pair_contract.py::_pair_kernel_batched; kernel E
// (mode 1, the slot scatter by shared atomics) replaces ::_pair_kernel (the
// one-hot MXU scatter).  Both are built by _build_pair_call and driven by
// pair_contract_pallas there.  Both read the pad-free pair stream of
// ginkgo_tpu_torch/ops/pair_contract.py::pair_stream, repacked once on the
// card from the plan of plan_pair_contract: the live vregs of each output
// tile t (1024 slots) in order, vreg v's pairs at [vstart[v], vstart[v+1])
// in slot order (so po-ascending), padded to a multiple of 8 with pairs of
// slot 1024, each pair three int16 indices (cl, cu, co), and
//
//     y[t * 1024 + co] += a[va[v] * 128 + cl] * b[vb[v] * 128 + cu],
//
// with a and b read as zero beyond their lengths (the plan's zero padding);
// tile t's vregs are [tstart[t], tstart[t+1]).  The plan's COO tail (pairs
// outside the windows) follows in a second kernel of the same launch.  The
// plain version is ops/pair_contract.py::_planned_plain.
//
// Bound: bytes.  The contraction needs each planned pair's three int16
// indices (6 B), a, b and y read or written once, the per-vreg window
// starts and the per-tile tables; one multiply and one add a pair are far
// below the card's rate.  The stream holds about that: the TPU slab's
// padding is gone (a live vreg of the FEM product plan holds 653 pairs of
// its 1024 slots, a fill of 0.638; of the denominator plan 382, 0.373), and
// so are the per-slot prefix counts pes/pesp (1,070 MB of index streams a
// launch on the product plan before, 513 MB now).  Above the bound are
// the gathers: a warp's b values touch about 0.74 distinct 32-byte sectors
// a pair on the product plan, served by L2 (PERF.md: the gather-free
// builds of tools/torch_pair_probe.py).
//
// Design:
//   * a warp owns a tile and a copy of its 1024 accumulators in shared
//     memory; a CTA holds kWarps (16) consecutive tiles, whose windows of
//     a and b overlap, so the CTA's gathers share L1 lines;
//   * the warp walks its tile's vregs in order, 256 pairs at a time: lane
//     l takes pairs 8 l .. 8 l + 7 by three 16-byte loads, marked to be
//     evicted first; the next group's loads are issued before this group
//     is summed;
//   * D: each lane sums its runs of one slot in order, a segmented shuffle
//     scan sums the lanes' trailing runs, and the run's last lane adds the
//     run's sum to its slot; the warp's last run is carried into the next
//     group.  A slot takes one add a vreg.  Products are rounded before any
//     add (no fused multiply-add) and every order of sums is fixed by the
//     plan: deterministic, no block barrier, no difference of prefixes
//     (tests/pair_walk.py emulates it bit for bit);
//   * E: each product added to its slot by a shared-memory atomicAdd, in
//     the hardware's order;
//   * y is written once a tile, coalesced, rows >= n_out not written;
//   * the tail: a warp a tail slot, its pairs summed in a fixed order and
//     added to y (so D, tail included, is deterministic);
//   * the value type is the accumulation type: f32 and f64 instantiations
//     (the TPU kernel is f32 only).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

constexpr int kOW = 1024;      // output slots a tile
constexpr int kLanes = 128;    // values a window row
constexpr int kChunk = 8;      // pairs a lane takes at once (16-byte loads)
constexpr int kGroup = 32 * kChunk;  // pairs a warp takes at once
constexpr int kWarps = 16;     // warps (tiles) a CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

template <typename T>
__device__ __forceinline__ T gather(const T* __restrict__ x, long long len,
                                    long long i) {
  return (unsigned long long)i < (unsigned long long)len ? __ldg(x + i)
                                                         : T(0);
}

// the product rounded on its own, so that no add fuses with it
__device__ __forceinline__ float mul(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul(double x, double y) {
  return __dmul_rn(x, y);
}

// A lane's 8 consecutive pairs: their cl, cu, co as 8 int16 each.
struct Chunk {
  uint4 l, u, o;
};

__device__ __forceinline__ int idx16(const uint4& v, int j) {
  const unsigned w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return static_cast<int16_t>(j & 1 ? w >> 16 : w & 0xffffu);
}

// The stream is read once: its loads are marked to be evicted first, so
// that L1 and L2 keep the gathered windows of a and b.
__device__ __forceinline__ uint4 stream_load(const int16_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ Chunk load_chunk(const int16_t* __restrict__ cl,
                                            const int16_t* __restrict__ cu,
                                            const int16_t* __restrict__ co,
                                            long long i) {
  return Chunk{stream_load(cl + i), stream_load(cu + i), stream_load(co + i)};
}

// The tile's live vregs, 32 at a time in the lanes' registers: lane j
// holds vreg 32 * batch + j's pair range [s, e) and window bases.
struct VregMeta {
  long long s, e;
  int wa, wb;
};

__device__ __forceinline__ VregMeta load_meta(
    const long long* __restrict__ vstart, const int* __restrict__ va,
    const int* __restrict__ vb, int v0, int nvt, int k) {
  VregMeta m{0, 0, 0, 0};
  if (k < nvt) {
    m.s = __ldg(vstart + v0 + k);
    m.e = __ldg(vstart + v0 + k + 1);
    m.wa = __ldg(va + v0 + k);
    m.wb = __ldg(vb + v0 + k);
  }
  return m;
}

// One group of kernel D: lane l's pairs are [g + 8 l, g + 8 l + 8) of a
// vreg ending at e (po-ascending; padding and lanes past e carry slot
// 1024).  Runs of one slot are summed lane-locally in order, then across
// lanes by a segmented shuffle scan of each lane's trailing run; the
// run's last lane adds its sum to the slot.  The warp's last run goes on
// in (carry, carry_q) and is added when a later group does not continue
// it, or at the vreg's end (last).
template <typename T>
__device__ __forceinline__ void group_segmented(
    const T* __restrict__ a, long long na, const T* __restrict__ b,
    long long nb, const Chunk& c, bool live, long long abase,
    long long bbase, bool last, T& carry, int& carry_q, T* acc, int lane) {
  int q[kChunk];
  T r[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    q[j] = live ? idx16(c.o, j) : kOW;
    r[j] = q[j] < kOW ? mul(gather(a, na, abase + idx16(c.l, j)),
                            gather(b, nb, bbase + idx16(c.u, j)))
                      : T(0);
  }
  // lane-local running sums of the runs; the first head inside the lane
  int first_head = kChunk;
#pragma unroll
  for (int j = 1; j < kChunk; ++j) {
    const bool same = q[j] == q[j - 1];
    if (same) r[j] = r[j - 1] + r[j];
    if (!same && first_head == kChunk) first_head = j;
  }
  const int q_before = __shfl_up_sync(kFull, q[kChunk - 1], 1);
  const bool cont = q[0] == (lane == 0 ? carry_q : q_before);
  const bool head = first_head < kChunk || !cont;
  T x = r[kChunk - 1];
  if (lane == 0 && !head) x = carry + x;
  const unsigned heads =
      __ballot_sync(kFull, head) & (kFull >> (31 - lane));
  const int start = 31 - __clz(heads);   // -1: the run began before
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T n = __shfl_up_sync(kFull, x, off);
    if (lane >= off && lane - off >= start) x = x + n;
  }
  const T x_before = __shfl_up_sync(kFull, x, 1);
  const T c_in = lane == 0 ? carry : x_before;
  const int q_after = __shfl_down_sync(kFull, q[0], 1);
  // the carried run ended at the last group's end
  if (lane == 0 && !cont && carry_q >= 0 && carry_q < kOW)
    acc[carry_q] += carry;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const bool tail = j + 1 < kChunk ? q[j] != q[j + 1 < kChunk ? j + 1 : j]
                                     : lane < 31 && q[j] != q_after;
    if (tail && q[j] < kOW)
      acc[q[j]] += j < first_head && cont ? c_in + r[j] : r[j];
  }
  carry = __shfl_sync(kFull, x, 31);
  carry_q = __shfl_sync(kFull, q[kChunk - 1], 31);
  if (last) {
    if (lane == 0 && carry_q >= 0 && carry_q < kOW) acc[carry_q] += carry;
    carry_q = -1;
  }
  __syncwarp();
}

// One group of kernel E: every pair added to its slot by a shared atomic.
template <typename T>
__device__ __forceinline__ void group_atomic(
    const T* __restrict__ a, long long na, const T* __restrict__ b,
    long long nb, const Chunk& c, bool live, long long abase,
    long long bbase, T* acc) {
  if (!live) return;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int q = idx16(c.o, j);
    if (q < kOW)
      atomicAdd(acc + q, mul(gather(a, na, abase + idx16(c.l, j)),
                             gather(b, nb, bbase + idx16(c.u, j))));
  }
}

// A warp a tile: it walks the tile's vregs in order, a group of 256 pairs
// at a time, the next group's indices loaded while this one is summed.
// 32 warps an SM in f32 (64 registers a thread), 24 in f64
template <typename T, int kMode>
__global__ void __launch_bounds__(
    kWarps * 32, kWarps >= (sizeof(T) == 4 ? 32 : 24)
                     ? 1
                     : (sizeof(T) == 4 ? 32 : 24) / kWarps)
pair_stream_kernel(const T* __restrict__ a, long long na,
                   const T* __restrict__ b, long long nb,
                   const int16_t* __restrict__ cl,
                   const int16_t* __restrict__ cu,
                   const int16_t* __restrict__ co,
                   const long long* __restrict__ vstart,
                   const int* __restrict__ va, const int* __restrict__ vb,
                   const int* __restrict__ tstart, int T_tiles,
                   long long n_out, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = (long long)blockIdx.x * kWarps + warp;
  T* const acc = reinterpret_cast<T*>(smem_raw) + warp * kOW;
  for (int o = lane; o < kOW; o += 32) acc[o] = T(0);
  __syncwarp();
  if (t >= T_tiles) return;
  const int v0 = __ldg(tstart + t);
  const int nvt = __ldg(tstart + t + 1) - v0;
  if (nvt > 0) {
    VregMeta m = load_meta(vstart, va, vb, v0, nvt, lane);
    // the group after the current one: vreg k, start s, end e
    int k = 0;
    long long s = __shfl_sync(kFull, m.s, 0), e = __shfl_sync(kFull, m.e, 0);
    int wa = __shfl_sync(kFull, m.wa, 0), wb = __shfl_sync(kFull, m.wb, 0);
    Chunk nxt{};
    if (s + kChunk * lane < e) nxt = load_chunk(cl, cu, co, s + kChunk * lane);
    T carry = T(0);
    int carry_q = -1;
    while (k < nvt) {
      const Chunk c = nxt;
      const bool live = s + kChunk * lane < e;
      const long long abase = (long long)wa * kLanes;
      const long long bbase = (long long)wb * kLanes;
      // advance to the next group and issue its loads
      s += kGroup;
      const bool last = s >= e;
      if (last && ++k < nvt) {
        if ((k & 31) == 0) m = load_meta(vstart, va, vb, v0, nvt, k + lane);
        s = __shfl_sync(kFull, m.s, k & 31);
        e = __shfl_sync(kFull, m.e, k & 31);
        wa = __shfl_sync(kFull, m.wa, k & 31);
        wb = __shfl_sync(kFull, m.wb, k & 31);
      }
      if (k < nvt && s + kChunk * lane < e)
        nxt = load_chunk(cl, cu, co, s + kChunk * lane);
      if (kMode == 0)
        group_segmented(a, na, b, nb, c, live, abase, bbase, last, carry,
                        carry_q, acc, lane);
      else
        group_atomic(a, na, b, nb, c, live, abase, bbase, acc);
    }
  }
  __syncwarp();
  for (int o = lane; o < kOW; o += 32) {
    const long long yo = t * kOW + o;
    if (yo < n_out) y[yo] = acc[o];
  }
}

// A CTA's accumulators, kWarps copies of a tile's: past the 48 KB a launch
// may take by default, each instance's limit is raised once a device; the
// card refuses a CTA that needs more than it has.
// The COO tail: a warp an output slot of it (tseg: each slot's pairs,
// po-sorted, tpo the slot), the lanes' strided partial sums then a
// butterfly, fixed orders both; added to y after the main kernel.
constexpr int kTailWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kTailWarps * 32)
pair_tail_kernel(const T* __restrict__ a, long long na,
                 const T* __restrict__ b, long long nb,
                 const int* __restrict__ tl, const int* __restrict__ tu,
                 const int* __restrict__ tseg, const int* __restrict__ tpo,
                 int nseg, T* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const long long seg =
      (long long)blockIdx.x * kTailWarps + (threadIdx.x >> 5);
  if (seg >= nseg) return;
  const int e = __ldg(tseg + seg + 1);
  T v = T(0);
  for (int i = __ldg(tseg + seg) + lane; i < e; i += 32)
    v = v + mul(gather(a, na, __ldg(tl + i)), gather(b, nb, __ldg(tu + i)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(kFull, v, off);
  if (lane == 0) y[__ldg(tpo + seg)] += v;
}

template <typename T, int kMode>
cudaError_t launch(const void* a, long long na, const void* b, long long nb,
                   const void* cl, const void* cu, const void* co,
                   const void* vstart, const void* va, const void* vb,
                   const void* tstart, int T_tiles, long long n_out,
                   const void* tl, const void* tu, const void* tseg,
                   const void* tpo, int nseg, void* y, cudaStream_t st) {
  constexpr int kBytes = kWarps * kOW * sizeof(T);
  static std::atomic<bool> raised[kMaxDevices];
  if (kBytes > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!raised[dev].load(std::memory_order_relaxed)) {
      err = cudaFuncSetAttribute(pair_stream_kernel<T, kMode>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBytes);
      if (err != cudaSuccess) return err;
      raised[dev].store(true, std::memory_order_relaxed);
    }
  }
  const long long grid = (T_tiles + kWarps - 1) / kWarps;
  pair_stream_kernel<T, kMode><<<static_cast<unsigned>(grid), kWarps * 32,
                                 kBytes, st>>>(
      static_cast<const T*>(a), na, static_cast<const T*>(b), nb,
      static_cast<const int16_t*>(cl), static_cast<const int16_t*>(cu),
      static_cast<const int16_t*>(co), static_cast<const long long*>(vstart),
      static_cast<const int*>(va), static_cast<const int*>(vb),
      static_cast<const int*>(tstart), T_tiles, n_out, static_cast<T*>(y));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return err;
  pair_tail_kernel<T><<<(nseg + kTailWarps - 1) / kTailWarps,
                        kTailWarps * 32, 0, st>>>(
      static_cast<const T*>(a), na, static_cast<const T*>(b), nb,
      static_cast<const int*>(tl), static_cast<const int*>(tu),
      static_cast<const int*>(tseg), static_cast<const int*>(tpo), nseg,
      static_cast<T*>(y));
  return cudaGetLastError();
}

}  // namespace

// mode 0: kernel D; mode 1: kernel E.  The stream: cl, cu, co int16, each
// live vreg's pairs padded to a multiple of 8 (padding slot 1024), 16-byte
// aligned; vstart int64 (live vregs + 1), va, vb int32 window rows (one a
// live vreg), tstart int32 (T + 1); the COO tail tl, tu int32 po-sorted,
// tseg int32 (nseg + 1) and tpo int32 (nseg) its slots; a and b hold na
// and nb values of the value type, y n_out <= T * 1024.
extern "C" int pair_contract_launch(
    int mode, int vcode, const void* a, long long na, const void* b,
    long long nb, const void* cl, const void* cu, const void* co,
    const void* vstart, const void* va, const void* vb, const void* tstart,
    int T_tiles, long long n_out, const void* tl, const void* tu,
    const void* tseg, const void* tpo, int nseg, void* y, void* stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if ((mode != 0 && mode != 1) || T_tiles <= 0 || n_out <= 0 ||
      n_out > (long long)T_tiles * kOW || na < 0 || nb < 0 || nseg < 0 ||
      misaligned(cl) || misaligned(cu) || misaligned(co))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vcode * 2 + mode) {
    case kF32 * 2 + 0:
      return launch<float, 0>(a, na, b, nb, cl, cu, co, vstart, va, vb,
                              tstart, T_tiles, n_out, tl, tu, tseg, tpo,
                              nseg, y, st);
    case kF32 * 2 + 1:
      return launch<float, 1>(a, na, b, nb, cl, cu, co, vstart, va, vb,
                              tstart, T_tiles, n_out, tl, tu, tseg, tpo,
                              nseg, y, st);
    case kF64 * 2 + 0:
      return launch<double, 0>(a, na, b, nb, cl, cu, co, vstart, va, vb,
                               tstart, T_tiles, n_out, tl, tu, tseg, tpo,
                               nseg, y, st);
    case kF64 * 2 + 1:
      return launch<double, 1>(a, na, b, nb, cl, cu, co, vstart, va, vb,
                               tstart, T_tiles, n_out, tl, tu, tseg, tpo,
                               nseg, y, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pair_contract_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
