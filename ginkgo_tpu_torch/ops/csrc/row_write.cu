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
// Design, the simple one that is right first:
//   * a grid-stride loop of 16-byte (uint4) loads and stores over the part
//     of the row where both addresses are 16-byte aligned;
//   * scalar code of the element's own width (1, 2, 4 or 8 bytes, so one
//     kernel serves int8, int16, bf16, f16, f32, f64 and complex64 stores)
//     for the ragged head before the first aligned address and the tail
//     after the last whole vector, and for the whole row when the two
//     addresses are not aligned alike;
//   * a 16-byte element (complex128) is copied as two 8-byte words, so the
//     same code serves it and no access is misaligned;
//   * i comes from the host, which knows the Arnoldi index there: no
//     scalar prefetch, no device-side index read.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

template <typename T>
__global__ void __launch_bounds__(256)
row_write_kernel(T* __restrict__ dst, const T* __restrict__ src, long long n,
                 long long head, long long nvec) {
  constexpr long long kPer = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  for (long long v = tid; v < nvec; v += stride) dv[v] = __ldg(sv + v);
  for (long long e = tid; e < head; e += stride) dst[e] = src[e];
  for (long long e = head + nvec * kPer + tid; e < n; e += stride)
    dst[e] = src[e];
}

template <typename T>
cudaError_t launch_typed(void* dst, const void* src, long long n,
                         cudaStream_t stream) {
  constexpr long long kPer = 16 / sizeof(T);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  long long head = n, nvec = 0;
  if ((d % 16) == (s % 16) && (d % sizeof(T)) == 0) {
    // elements until dst (and so src) reaches a 16-byte boundary
    head = (long long)(((16 - d % 16) % 16) / sizeof(T));
    if (head > n) head = n;
    nvec = (n - head) / kPer;
  }
  const long long work = nvec > 0 ? nvec : n;
  const int threads = 256;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  row_write_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<T*>(dst), static_cast<const T*>(src), n, head, nvec);
  return cudaGetLastError();
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
    case 16: return launch_typed<uint64_t>(dst, src, 2 * n, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* row_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
