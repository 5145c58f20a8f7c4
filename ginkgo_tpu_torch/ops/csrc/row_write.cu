// In-place write of one Krylov-basis row for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ginkgo_tpu/solver/krylov_basis.py::kern
// (built by _row_write_call, driven by inplace_row_write): one aliased
// HBM->HBM DMA of ``row`` into row i of the basis store.  Here the store is
// a contiguous (m_pad, n) or (m_pad, n, k) tensor, so row i is the n * k
// consecutive elements at element offset i * n * k; the wrapper
// (ginkgo_tpu_torch/ops/row_write.py) hands the kernel that address, the
// row, the element count and the element size.  The store and the row have
// one dtype: the caller casts (or quantises) the row first.
//
// Bound: bytes.  Each element is read once and written once (2 * n * k *
// itemsize bytes); there is no arithmetic.
//
// Design: Hopper's counterpart of the TPU's DMA is TMA's bulk copy.
//   * where the row and its destination are 16-byte aligned alike, the
//     aligned body is cut into chunks of kChunk bytes (the last one
//     shorter, a multiple of 16); a persistent grid of kCtasPerSm CTAs an
//     SM takes chunks j = blockIdx.x, blockIdx.x + gridDim.x, ...;
//   * in each CTA one thread drives a ring of kStages chunks in shared
//     memory: cp.async.bulk global -> shared completing on the stage's
//     mbarrier, then cp.async.bulk shared -> global in a bulk group; a
//     stage is loaded again once the store that read it has finished
//     reading (cp.async.bulk.wait_group.read), so kStages - 1 loads stay in
//     flight beside the stores;
//   * the ragged head before the first aligned address and the tail after
//     the last 16 bytes are copied by the second warp of CTA 0 in scalar
//     code of the element's own width (1, 2, 4 or 8 bytes);
//   * a row whose two addresses are not aligned alike is copied whole in
//     that scalar code, a thread an element over a grid-stride loop;
//   * a 16-byte element (complex128) is copied as two 8-byte words, so the
//     same code serves it and no access is misaligned;
//   * i comes from the host, which knows the Arnoldi index there: no
//     scalar prefetch, no device-side index read;
//   * a device's SM count and the ring kernel's shared-memory limit are
//     set on the first launch there and kept, so a launch asks the driver
//     nothing but the current device.

#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

constexpr int kChunk = 16384;     // bytes a ring stage
constexpr int kStages = 4;
constexpr int kCtasPerSm = 2;
constexpr int kBulkThreads = 64;  // warp 0: the ring; warp 1: ragged ends
constexpr int kBulkSmem = kStages * kChunk + 8 * kStages;
constexpr int kCopyThreads = 256;
constexpr long long kMaxCopyBlocks = 4096;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__global__ void __launch_bounds__(kBulkThreads)
row_write_bulk_kernel(T* __restrict__ dst, const T* __restrict__ src,
                      long long n, long long head, long long body_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x >= 32) {
    if (blockIdx.x == 0) {
      const long long tail = head + body_bytes / (long long)sizeof(T);
      for (long long e = threadIdx.x - 32; e < head; e += 32) dst[e] = src[e];
      for (long long e = tail + threadIdx.x - 32; e < n; e += 32)
        dst[e] = src[e];
    }
    return;
  }
  if (threadIdx.x != 0) return;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kChunk);
  const char* s8 = reinterpret_cast<const char*>(src + head);
  char* d8 = reinterpret_cast<char*>(dst + head);
  const long long chunks = (body_bytes + kChunk - 1) / kChunk;
  const long long mine =
      blockIdx.x < chunks ? (chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_u32(&bars[s]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  auto offset = [&](long long i) {
    return (blockIdx.x + i * gridDim.x) * (long long)kChunk;
  };
  auto bytes = [&](long long i) {
    const long long left = body_bytes - offset(i);
    return static_cast<unsigned>(left < kChunk ? left : kChunk);
  };
  auto load = [&](long long i) {
    const int s = static_cast<int>(i % kStages);
    const uint32_t bar = smem_u32(&bars[s]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     bar),
                 "r"(bytes(i))
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(smem + s * kChunk)),
        "l"(s8 + offset(i)), "r"(bytes(i)), "r"(bar)
        : "memory");
  };

  for (long long i = 0; i < mine && i < kStages; ++i) load(i);
  for (long long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % kStages);
    const uint32_t bar = smem_u32(&bars[s]);
    const unsigned parity = static_cast<unsigned>((i / kStages) & 1);
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    } while (!done);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(d8 + offset(i)), "r"(smem_u32(smem + s * kChunk)),
                 "r"(bytes(i))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // reload the stage of chunk i - 1 once its store has read it
    if (i >= 1 && i - 1 + kStages < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(i - 1 + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// rows whose two addresses are not 16-byte aligned alike
template <typename T>
__global__ void __launch_bounds__(kCopyThreads)
row_write_scalar_kernel(T* __restrict__ dst, const T* __restrict__ src,
                        long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += stride)
    dst[e] = src[e];
}

cudaError_t finish(cudaError_t err) {
  if (err == cudaSuccess) err = cudaGetLastError();
  // clear the error so that no later, unrelated check reports it
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <typename T>
cudaError_t launch_typed(void* dst, const void* src, long long n,
                         cudaStream_t stream) {
  constexpr long long kPer = 16 / sizeof(T);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  T* dt = static_cast<T*>(dst);
  const T* st = static_cast<const T*>(src);
  long long head = n, nvec = 0;
  if ((d % 16) == (s % 16) && (d % sizeof(T)) == 0) {
    // elements until dst (and so src) reaches a 16-byte boundary
    head = (long long)(((16 - d % 16) % 16) / sizeof(T));
    if (head > n) head = n;
    nvec = (n - head) / kPer;
  }
  if (nvec == 0) {
    long long blocks = (n + kCopyThreads - 1) / kCopyThreads;
    if (blocks > kMaxCopyBlocks) blocks = kMaxCopyBlocks;
    row_write_scalar_kernel<T><<<(unsigned)blocks, kCopyThreads, 0, stream>>>(
        dt, st, n);
    return finish(cudaSuccess);
  }
  // per device, set on its first launch: its SM count (0: not yet) and
  // this instance's shared-memory limit
  static std::atomic<int> sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return finish(err);
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int count = sms[dev].load(std::memory_order_relaxed);
  if (count == 0) {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(row_write_bulk_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBulkSmem);
    if (err != cudaSuccess) return finish(err);
    sms[dev].store(count, std::memory_order_relaxed);
  }
  const long long chunks = (nvec * 16 + kChunk - 1) / kChunk;
  const long long cap = (long long)count * kCtasPerSm;
  row_write_bulk_kernel<T>
      <<<(unsigned)(chunks < cap ? chunks : cap), kBulkThreads, kBulkSmem,
         stream>>>(dt, st, n, head, nvec * 16);
  return finish(cudaSuccess);
}

}  // namespace

// dst: the first element of the store's row i; src: the row; n: elements
// in the row; esize: bytes per element (1, 2, 4, 8 or 16).
extern "C" int row_write_launch(void* dst, const void* src, long long n,
                                int esize, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaErrorInvalidValue;
  switch (esize) {
    case 1: return launch_typed<uint8_t>(dst, src, n, st);
    case 2: return launch_typed<uint16_t>(dst, src, n, st);
    case 4: return launch_typed<uint32_t>(dst, src, n, st);
    case 8: return launch_typed<uint64_t>(dst, src, n, st);
    case 16: return launch_typed<uint64_t>(dst, src, 2 * n, st);  // 2 words
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* row_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
