// Packed exact lower-triangular solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ginkgo_tpu/ops/tri_packed.py::_tri_kernel
// (built by _build_tri_call, driven by packed_trisolve_tpu).  On the plan of
// ginkgo_tpu_torch/ops/tri_packed.py::plan_packed_trisolve it scans the
// 256-row blocks t = 0 .. nb-1 in order and computes
//
//     x_t = inv_t @ (b_t - cross_t),
//     cross_t[s] = sum_{w < 4 Wv} crossv[e] * x[(t - P) * 256 + crossi[e]],
//     e = ((t * Wv + w / 4) * 8 + (w % 4) * 2 + s / 128) * 128 + s % 128,
//
// the recurrence of packed_trisolve_reference (its slots past 4 nwv[t] hold
// zeros, so nwv is never read here).  Upper factors arrive flipped
// (flip = 1): row r of the solve is row n-1-r of b and x.
//
// Bound.  The bytes a solve needs are the lower triangles of the
// (nb, 256, 256) f32 inverses (about n * 128 * 4 bytes), the nonzero
// int16 + f32 cross slots, b and x: 43 ns a block on the FEM factor.  But
// the blocks form a chain: on an ILU factor every block reads the one
// before it (P = 3 on the FEM factor, and its chain is all nb blocks
// deep), so no two blocks can run at once and the solve takes nb times
// the latency of one step.  The design keeps that step short and on chip,
// and keeps the stream off it:
//
//   * a thread-block cluster of 8 CTAs (one cluster per group of up to K
//     right-hand sides, K <= 8) walks the blocks; CTA q owns rows 32q ..
//     32q+31 of every block (every warp runs the same instructions
//     whatever its rows: the rows near the diagonal only skip loads);
//   * the stream: nothing of block t's inverse, cross slots or b depends
//     on x, so each CTA copies its slice `stages - 1` blocks ahead of the
//     chain into a ring in shared memory: its 32 whole inverse rows as one
//     32 KB TMA bulk copy, the 32-row pieces of its cross planes as 16-byte
//     cp.async copies and its b values as 4-byte ones (zero past n),
//     spread over the threads; each stage completes on its own mbarrier
//     (the bulk bytes, one cp.async arrival a thread);
//   * the chain state: every CTA keeps the last P + 1 blocks of x (the
//     carry window, block u in slot u % (P + 1), rows of K values) in its
//     own shared memory; x leaves the cluster only as output;
//   * a step: each CTA sums the cross terms of its 32 rows from its
//     window (warp g takes planes g, g+8, ...), forms their right-hand
//     side and sends it to the 7 other CTAs; then multiplies its 32
//     inverse rows by the whole right-hand side (a warp 4 rows, two float4
//     a lane, the float4s above the diagonal skipped: the inverse of a
//     lower triangle has exact zeros there) and sends its x rows into the
//     7 other windows.  Both exchanges are TMA bulk copies from shared
//     memory into the other CTAs' shared memory, completing their bytes on
//     the receiver's mbarrier (its own arrive.expect_tx arms it each
//     step), one a peer, issued by 7 lanes after a CTA barrier: no
//     generic remote stores and no release fence on the chain.  The
//     stream's copies of a later block are issued while the right-hand
//     side travels; x goes to global memory from the window, written by
//     warps that never signal.  The barriers and the right-hand-side
//     buffers alternate with the step's parity.
//
// Measured on the way (tools/torch_cf_probe.py, the FEM factor, per
// block): about 110 small bulk copies a block kept the chain at 5.2 us;
// generic remote stores with cluster barriers or with release arrivals
// cost 2.5-2.9 us, of which about 1,800 cycles waited on the release
// (after the global x stores of the same thread); every CTA forming the
// whole right-hand side took 2,200 cycles of the step for the gather;
// 14 copies an exchange issued by one thread, and a proxy fence inside
// the product's row loop, cost about 1,000 cycles more than this form;
// issuing the stream's copies at the top of a step, before the x wait,
// instead of while the right-hand side travels, 15 % more.
//
// The launch asks for the dynamic shared memory of the chosen ring; a plan
// whose ring and window do not fit the card is refused
// (cudaErrorInvalidValue), and the error reaches the caller.  The device's
// limit is asked of the driver, and each instance's raised to it, on the
// device's first launch; a launch asks the driver nothing else.  Rows >= n
// of the last block (identity inverse, zero b) are computed and never
// written out.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

#ifdef GTS_TRI_TRACE
// measurement build (tools/torch_cf_probe.py; the hooks read a clock and
// change nothing else): clock64() of CTA 0's thread 0 at each phase
// boundary of steps 64 .. 127, read by tri_packed_trace
__device__ long long g_tri_trace[64 * 8];
#define GTS_TRACE(i)                                     \
  if (tid == 0 && blockIdx.x == 0 && t >= 64 && t < 128) \
    g_tri_trace[(t - 64) * 8 + (i)] = clock64();
#else
#define GTS_TRACE(i)
#endif

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

constexpr int kS = 256;                   // rows per block
constexpr int kCluster = 8;               // CTAs of a cluster (portable)
constexpr int kRows = kS / kCluster;      // rows of a block per CTA
constexpr int kThreads = 256;             // 128 and 512 measured slower
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = kRows / kWarps;  // product rows a warp
constexpr int kMaxRhs = 8;
constexpr int kMaxStages = 6;

// block row held in row r (0 <= r < 32) of CTA q's slice
__host__ __device__ __forceinline__ int slice_row(int q, int r) {
  return kRows * q + r;
}

__host__ __device__ __forceinline__ long long align128(long long v) {
  return (v + 127) / 128 * 128;
}

// dynamic shared memory of one CTA, in bytes from its start
struct Layout {
  long long stage;    // bytes of one ring stage
  long long cv, ci;   // a stage's cross values / indices, [plane][row]
  long long bs;       // a stage's b values, [column][row]
  long long win;      // the carry window, (P + 1) blocks of 256 x K
  long long rhs;      // two right-hand sides, 256 x K each (step parity)
  long long part;     // the warps' partial cross sums
  long long bars;     // ring stages, then rhs_ready[2], x_ready[2]
  long long total;
};

__host__ __device__ __forceinline__ Layout make_layout(int P, int Wv, int K,
                                                       int stages) {
  Layout l;
  l.cv = (long long)kRows * kS * 4;
  l.ci = l.cv + 4LL * Wv * kRows * 4;
  l.bs = l.ci + 4LL * Wv * kRows * 2;
  l.stage = align128(l.bs + (long long)K * kRows * 4);
  l.win = stages * l.stage;
  l.rhs = align128(l.win + (long long)(P + 1) * kS * K * 4);
  l.part = l.rhs + 2LL * kS * K * 4;
  l.bars = align128(l.part + (long long)kWarps * K * kRows * 4);
  l.total = l.bars + 8LL * (stages + 4);
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> own shared memory, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// own shared memory -> the same offsets in CTA `rank` of the cluster,
// completing `bytes` on that CTA's barrier at `bar`'s offset
__device__ __forceinline__ void bulk_s2peer(const void* buf, unsigned bytes,
                                            uint64_t* bar, unsigned rank) {
  asm volatile(
      "{\n .reg .b32 d, m;\n"
      " mapa.shared::cluster.u32 d, %0, %3;\n"
      " mapa.shared::cluster.u32 m, %2, %3;\n"
      " cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [d], [%0], %1, [m];\n}\n" ::"r"(smem_u32(buf)),
      "r"(bytes), "r"(smem_u32(bar)), "r"(rank)
      : "memory");
}

// Lanes 0 .. 6 of warp 0 after a CTA barrier (the writers of the rows
// fenced them for the async proxy before it): send this CTA's 32 rows of
// K values of the 256 x K buffer `buf` to the same rows of the 7 other
// CTAs, one copy each, completing on their barriers at `bar`.
__device__ __forceinline__ void send_rows(const float* buf, uint64_t* bar,
                                          int q, int K, int lane) {
  if (lane < kCluster - 1)
    bulk_s2peer(buf + kRows * q * K, kRows * K * 4u, bar,
                (q + 1 + lane) % kCluster);
}

// All threads: copy block t's slice into ring stage `st` on barrier `bar`
// (one expect-tx arrival from thread 0, one cp.async arrival a thread).
template <int K>
__device__ __forceinline__ void issue_block(
    unsigned char* st, uint64_t* bar, const Layout& L, const float* inv,
    const int16_t* crossi, const float* crossv, const float* b,
    long long ldb, long long n, int flip, int c0, int kc, int t, int Wv,
    int q, int tid) {
  if (tid == 0) {
    // the stage was last read by the generic proxy; order those reads
    // before the async proxy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect_tx(bar, kRows * kS * 4u);
    bulk_g2s(st, inv + ((long long)t * kS + kRows * q) * kS, kRows * kS * 4u,
             bar);
  }
  // the 32-row pieces of the cross planes: 128 B of values and 64 B of
  // indices each, as 16-byte pieces
  const int s0 = kRows * q;
  for (int c = tid; c < 48 * Wv; c += kThreads) {
    const int w = c / 12, piece = c % 12;
    const long long e =
        (((long long)t * Wv + (w >> 2)) * 8 + (w & 3) * 2 + (s0 >> 7)) * 128 +
        (s0 & 127);
    const int r0 = w * kRows;
    const void* src =
        piece < 8 ? static_cast<const void*>(crossv + e + 4 * piece)
                  : static_cast<const void*>(crossi + e + 8 * (piece - 8));
    const unsigned char* dst =
        piece < 8 ? st + L.cv + (r0 + 4 * piece) * 4
                  : st + L.ci + (r0 + 8 * (piece - 8)) * 2;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  }
  // b of slice row r, column c (zeros past n and past the cluster's
  // columns)
  if (tid < kRows * K) {
    const int r = tid % kRows, c = tid / kRows;
    const long long row = (long long)t * kS + slice_row(q, r);
    const bool live = c < kc && row < n;
    const float* src = b + (flip ? n - 1 - row : row) * ldb + c0 + c;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_u32(st + L.bs + (c * kRows + r) * 4)),
                 "l"(live ? src : b), "r"(live ? 4 : 0)
                 : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
tri_cluster_kernel(const float* __restrict__ inv,
                   const int16_t* __restrict__ crossi,
                   const float* __restrict__ crossv, int nb, int P, int Wv,
                   int stages, long long n, int flip,
                   const float* __restrict__ b, long long ldb,
                   float* __restrict__ x, long long ldx, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int c0 = static_cast<int>(blockIdx.x / kCluster) * K;
  const int kc = min(K, k - c0);
  const Layout L = make_layout(P, Wv, K, stages);
  const int Pw = P + 1;                   // window slots
  float* win = reinterpret_cast<float*>(smem + L.win);
  float* part = reinterpret_cast<float*>(smem + L.part);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* rhs_ready = bars + stages;    // [t & 1]: rhs of block t here
  uint64_t* x_ready = rhs_ready + 2;      // [u & 1]: x of block u here
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // bytes the 7 other CTAs send into this one in an exchange
  const unsigned peer_bytes = (kCluster - 1) * kRows * K * 4u;

  for (int e = tid; e < Pw * kS * K; e += kThreads) win[e] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], kThreads + 1);
    // an exchange's phase: this CTA's expect-tx arrival, then the bytes
    for (int h = 0; h < 2; ++h) {
      mbar_init(&rhs_ready[h], 1);
      mbar_init(&x_ready[h], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every window is zero and every barrier initialised before any CTA
  // copies into another's shared memory or issues a stream copy
  cluster.sync();

  const int ahead = stages - 1;
  for (int t = 0; t < ahead && t < nb; ++t)
    issue_block<K>(smem + (long long)t * L.stage, &bars[t], L, inv, crossi,
                   crossv, b, ldb, n, flip, c0, kc, t, Wv, q, tid);

  for (int t = 0; t < nb; ++t) {
    const int stage = t % stages;
    unsigned char* st = smem + (long long)stage * L.stage;
    float* rhs = reinterpret_cast<float*>(smem + L.rhs) + (t & 1) * kS * K;
    GTS_TRACE(0)
    // arm this step's exchanges (the peers' bytes may land before)
    if (tid == 0) {
      mbar_expect_tx(&rhs_ready[t & 1], peer_bytes);
      if (t + 1 < nb) mbar_expect_tx(&x_ready[t & 1], peer_bytes);
    }
    // x of block t - 1 is in the window once the peers' bytes landed
    if (t > 0) mbar_wait(&x_ready[(t - 1) & 1], ((t - 1) >> 1) & 1);
    GTS_TRACE(1)
    mbar_wait(&bars[stage], (t / stages) & 1);
    GTS_TRACE(2)

    // -- cross term of slice row `lane` over planes warp, warp + 8, ...
    const float* cv = reinterpret_cast<const float*>(st + L.cv);
    const int16_t* ci = reinterpret_cast<const int16_t*>(st + L.ci);
    // window position id lies in block t - P + id / 256, kept in slot
    // (t - P + id / 256) mod (P + 1) = (t + 1 + id / 256) mod (P + 1)
    const int base = (t + 1) % Pw;
    float acc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = 0.f;
    for (int w = warp; w < 4 * Wv; w += kWarps) {
      const float v = cv[w * kRows + lane];
      const int id = ci[w * kRows + lane];
      int slot = base + (id >> 8);
      if (slot >= Pw) slot -= Pw;
      const float* xr = win + (slot * kS + (id & (kS - 1))) * K;
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] += v * xr[c];
    }
#pragma unroll
    for (int c = 0; c < K; ++c) part[(warp * K + c) * kRows + lane] = acc[c];
    __syncthreads();
    GTS_TRACE(3)
    // -- rhs of slice row rb, column cb, into this CTA's rows of rhs
    if (tid < kRows * K) {
      const int rb = tid % kRows, cb = tid / kRows;
      float cross = 0.f;
#pragma unroll
      for (int g = 0; g < kWarps; ++g)
        cross += part[(g * K + cb) * kRows + rb];
      rhs[slice_row(q, rb) * K + cb] =
          reinterpret_cast<const float*>(st + L.bs)[cb * kRows + rb] - cross;
      // the async proxy sends these rows: order the write before it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();
    if (warp == 0) send_rows(rhs, &rhs_ready[t & 1], q, K, lane);
    // the stream's copies of block t + stages - 1, while the rows travel;
    // its stage held block t - 1, and every thread passed the end of that
    // step
    if (t + ahead < nb) {
      const int ts = (t + ahead) % stages;
      issue_block<K>(smem + (long long)ts * L.stage, &bars[ts], L, inv,
                     crossi, crossv, b, ldb, n, flip, c0, kc, t + ahead, Wv,
                     q, tid);
    }
    mbar_wait(&rhs_ready[t & 1], (t >> 1) & 1);
    GTS_TRACE(4)

    // -- x_t = inv_t @ rhs on this CTA's rows: warp w takes slice rows w,
    // w + 8, w + 16, w + 24
    const float* iv = reinterpret_cast<const float*>(st);
    float4 a[kPerWarp][2];
#pragma unroll
    for (int h = 0; h < kPerWarp; ++h) {
      const int r = warp + h * kWarps;
      const int i = slice_row(q, r);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = u * 128 + 4 * lane;
        a[h][u] = j <= i ? *reinterpret_cast<const float4*>(iv + r * kS + j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    const int slot = t % Pw;
    float xv[kPerWarp];    // lane c < K: column c of the warp's rows
#pragma unroll
    for (int h = 0; h < kPerWarp; ++h) {
      const int i = slice_row(q, warp + h * kWarps);
      float sum[K];
#pragma unroll
      for (int c = 0; c < K; ++c) sum[c] = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = u * 128 + 4 * lane;
        if (j <= i) {
          if constexpr (K == 1) {
            const float4 r4 = *reinterpret_cast<const float4*>(rhs + j);
            sum[0] += a[h][u].x * r4.x + a[h][u].y * r4.y +
                      a[h][u].z * r4.z + a[h][u].w * r4.w;
          } else {
#pragma unroll
            for (int c = 0; c < K; ++c)
              sum[c] += a[h][u].x * rhs[j * K + c] +
                        a[h][u].y * rhs[(j + 1) * K + c] +
                        a[h][u].z * rhs[(j + 2) * K + c] +
                        a[h][u].w * rhs[(j + 3) * K + c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < K; ++c)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], off);
      xv[h] = sum[0];
#pragma unroll
      for (int c = 1; c < K; ++c)
        if (lane == c) xv[h] = sum[c];
    }
    if (lane < K) {
#pragma unroll
      for (int h = 0; h < kPerWarp; ++h)
        win[(slot * kS + slice_row(q, warp + h * kWarps)) * K + lane] = xv[h];
      // the async proxy sends these rows: order the writes before it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();
    GTS_TRACE(5)
    if (warp == 0 && t + 1 < nb)
      send_rows(win + slot * kS * K, &x_ready[t & 1], q, K, lane);
    // x of this CTA's rows, from the window, by warps that never signal
    for (int e = tid - 32; tid >= 32 && e < kRows * K; e += kThreads - 32) {
      const int r = e % kRows, c = e / kRows;
      const long long row = (long long)t * kS + slice_row(q, r);
      if (c < kc && row < n)
        x[(flip ? n - 1 - row : row) * ldx + c0 + c] =
            win[(slot * kS + slice_row(q, r)) * K + c];
    }
    GTS_TRACE(6)
  }
  // no CTA leaves while a peer may still copy into or out of its shared
  // memory
  cluster.sync();
}

constexpr int kMaxDevices = 64;

// The current device and its opt-in limit of dynamic shared memory a CTA,
// asked of the driver on the device's first launch and kept; false (the
// error cleared) if the runtime cannot say.
bool device_limit(int* dev, int* limit) {
  static std::atomic<int> limits[kMaxDevices];  // 0: not asked yet
  if (cudaGetDevice(dev) != cudaSuccess || *dev >= kMaxDevices) {
    cudaGetLastError();
    return false;
  }
  *limit = limits[*dev].load(std::memory_order_relaxed);
  if (*limit == 0) {
    if (cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               *dev) != cudaSuccess) {
      cudaGetLastError();
      return false;
    }
    limits[*dev].store(*limit, std::memory_order_relaxed);
  }
  return true;
}

// The widest K (right-hand sides a cluster) whose window and a ring of at
// least 3 stages (else 2) fit `limit` bytes of shared memory, with as many
// stages (up to 6) as fit; K = 1 with two stages when nothing fits (the
// launch then asks for more than the card has and is refused).
struct Choice {
  int K, stages;
};

Choice choose(int P, int Wv, int k, long long limit) {
  for (int min_stages = 3; min_stages >= 2; --min_stages)
    for (int K = k < kMaxRhs ? k : kMaxRhs; K >= 1; --K)
      for (int s = kMaxStages; s >= min_stages; --s)
        if (make_layout(P, Wv, K, s).total <= limit) return Choice{K, s};
  return Choice{1, 2};
}

// The launch of instance K: on a device's first launch of it, its limit of
// dynamic shared memory is raised to the device's; a plan that needs more
// is refused.
template <int K>
cudaError_t launch_k(const float* inv, const int16_t* crossi,
                     const float* crossv, int nb, int P, int Wv, int stages,
                     long long n, int flip, const float* b, long long ldb,
                     float* x, long long ldx, int k, int dev, int limit,
                     cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  const long long bytes = make_layout(P, Wv, K, stages).total;
  cudaError_t err = cudaSuccess;
  if (!raised[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(tri_cluster_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err == cudaSuccess) raised[dev].store(true, std::memory_order_relaxed);
  }
  if (err == cudaSuccess && bytes > limit) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(kCluster * ((k + K - 1) / K)));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, tri_cluster_kernel<K>, inv, crossi, crossv,
                             nb, P, Wv, stages, n, flip, b, ldb, x, ldx, k);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  // clear the error so that no later, unrelated check reports it
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

// nwv is part of the plan and of this interface; the kernel sums all 4 Wv
// planes of a block, as the reference does, and so never reads it.
extern "C" int tri_packed_launch(int xcode, const void* inv,
                                 const void* crossi, const void* crossv,
                                 const void* nwv, int nb, int P, int Wv,
                                 long long n, int flip, const void* b,
                                 long long ldb, void* x, long long ldx, int k,
                                 void* stream) {
  (void)nwv;
  if (xcode != kF32 || n <= 0 || nb <= 0 || P <= 0 || Wv <= 0 || k <= 0 ||
      n > (long long)nb * kS)
    return cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  if (!device_limit(&dev, &limit)) return cudaErrorInvalidDevice;
  const Choice ch = choose(P, Wv, k, limit);
  const float* iv = static_cast<const float*>(inv);
  const int16_t* ci = static_cast<const int16_t*>(crossi);
  const float* cv = static_cast<const float*>(crossv);
  const float* bb = static_cast<const float*>(b);
  float* xx = static_cast<float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ch.K) {
#define GTS_CASE(KK)                                                       \
  case KK:                                                                 \
    return launch_k<KK>(iv, ci, cv, nb, P, Wv, ch.stages, n, flip, bb, ldb, \
                        xx, ldx, k, dev, limit, st);
    GTS_CASE(1) GTS_CASE(2) GTS_CASE(3) GTS_CASE(4)
    GTS_CASE(5) GTS_CASE(6) GTS_CASE(7) GTS_CASE(8)
#undef GTS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// What a launch for (P, Wv, k) uses on the current device: out[0] CTAs a
// cluster, out[1] right-hand sides a cluster, out[2] ring stages, out[3]
// dynamic shared memory bytes a CTA, out[4] the device's opt-in limit.
extern "C" int tri_packed_config(int P, int Wv, int k, long long* out) {
  int dev = 0, limit = 0;
  if (P <= 0 || Wv <= 0 || k <= 0) return cudaErrorInvalidValue;
  if (!device_limit(&dev, &limit)) return cudaErrorInvalidDevice;
  const Choice ch = choose(P, Wv, k, limit);
  out[0] = kCluster;
  out[1] = ch.K;
  out[2] = ch.stages;
  out[3] = make_layout(P, Wv, ch.K, ch.stages).total;
  out[4] = limit;
  return 0;
}

#ifdef GTS_TRI_TRACE
extern "C" int tri_packed_trace(long long* out) {
  return cudaMemcpyFromSymbol(out, g_tri_trace, sizeof(g_tri_trace));
}
#endif

extern "C" const char* tri_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
