#!/usr/bin/env python3
"""Time ``ops/csrc/sell_spmv.cu`` (kernels B and H) against the one design
alternative left open: the superblock's x window staged in shared memory.

    python3 tools/torch_sell_probe.py

The variant ``staged`` is measurement only; no path of the package runs
it.  It takes blocks of 1024 threads, one a superblock (32 slices), which
first copy the superblock's x window (XW columns, at most 64 KB in f32)
into shared memory and then walk the slices as the kernel does at k = 1
(a thread a row, j unrolled by 8), reading x from there.

On the packed main-path matrix (the locally permuted 256x64x64 stencil)
and the FEM matrix of the ILU path, f32, k = 1: the variant is checked
against the kernel (same order of sums, so equal to the last bit), then
the two are timed in turns (kernel, variant, variant, kernel) with CUDA
events, queued behind a spinning kernel.  Prints the card's
``nvidia-smi`` name and power limit and one JSON object per matrix;
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
import ginkgo_tpu_torch as gtt  # noqa: E402
from ginkgo_tpu_torch.benchmark import build_matrix_data  # noqa: E402
from ginkgo_tpu_torch.ops import _cuda, spmv_packed  # noqa: E402
from ginkgo_tpu_torch.utils.generators import (permute_locally,  # noqa: E402
                                               stencil_3d)

VARIANT = r"""
#include <cuda_runtime.h>
#include <cstdint>

// a block of 1024 threads a superblock: its x window first copied into
// shared memory, then a thread a row, a warp a slice, j unrolled by 8
extern "C" __global__ void __launch_bounds__(1024)
staged(const float* __restrict__ sv, const int16_t* __restrict__ sc,
       const long long* __restrict__ sp, const int* __restrict__ xbase,
       long long n_slices, long long n, long long m, int xw,
       const float* __restrict__ x, float* __restrict__ y) {
  extern __shared__ float xs[];
  const long long base = 128LL * xbase[blockIdx.x];
  for (int i = threadIdx.x; i < xw; i += blockDim.x)
    xs[i] = base + i < m ? __ldg(x + base + i) : 0.f;
  __syncthreads();
  const long long s = blockIdx.x * 32LL + (threadIdx.x >> 5);
  if (s >= n_slices) return;
  const long long start = sp[s];
  const long long width = (sp[s + 1] - start) >> 5;
  const float* v = sv + start + (threadIdx.x & 31);
  const int16_t* c = sc + start + (threadIdx.x & 31);
  float acc = 0.f;
  long long j = 0;
  for (; j + 8 <= width; j += 8) {
    float w[8], xv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      w[u] = __ldg(v + (j + u) * 32);
      const int col = __ldg(c + (j + u) * 32);
      xv[u] = col < xw ? xs[col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += w[u] * xv[u];
  }
  for (; j < width; ++j) {
    const int col = __ldg(c + j * 32);
    if (col < xw) acc += __ldg(v + j * 32) * xs[col];
  }
  const long long r = s * 32 + (threadIdx.x & 31);
  if (r < n) y[r] = acc;
}

extern "C" int launch(const void* sv, const void* sc, const void* sp,
                      const void* xbase, long long n_slices, long long n,
                      long long m, int xw, const void* x, void* y,
                      void* stream) {
  const int smem = xw * 4;
  cudaFuncSetAttribute(staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  staged<<<(unsigned)((n_slices + 31) / 32), 1024, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sv), static_cast<const int16_t*>(sc),
      static_cast<const long long*>(sp), static_cast<const int*>(xbase),
      n_slices, n, m, xw, static_cast<const float*>(x),
      static_cast<float*>(y));
  return cudaGetLastError();
}
"""


def build_variant():
    out = REPO / "build" / "sell_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "staged.cu"
    src.write_text(VARIANT)
    lib = out / "libstaged.so"
    done = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on the variant:\n{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.launch.argtypes = [P, P, P, P, L, L, L, I, P, P, P]
    dll.launch.restype = ctypes.c_int
    return dll


def staged(dll, sell, meta, x):
    def run():
        y = torch.empty((meta["n"], 1), dtype=torch.float32, device=x.device)
        code = dll.launch(
            sell["sv"].data_ptr(), sell["sc"].data_ptr(),
            sell["sp"].data_ptr(), sell["xbase"].data_ptr(),
            meta["n_slices"], meta["n"], meta["m"], meta["XW"],
            x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"staged launch failed: CUDA error {code}")
        return y
    return run


def probe(label, A, dll):
    sell, smeta = A.sell, A.sell_meta
    meta = dict(smeta)
    x = torch.randn((A.shape[1], 1), dtype=torch.float32, device="cuda")
    fns = {"kernel": lambda: spmv_packed.pell_spmv_cuda(sell, smeta, x),
           "staged": staged(dll, sell, meta, x)}
    want = fns["kernel"]()
    torch.cuda.synchronize()
    equal = bool(torch.equal(fns["staged"](), want))
    times = {name: [] for name in fns}
    for name in ("kernel", "staged", "staged", "kernel"):
        times[name].append(cs.time_ms(fns[name], 50, queue_ahead=True))
    nbytes = cs.stream_needed_bytes(meta["entries"], 4, *A.shape)
    print(json.dumps({
        "probe": "sell_staged", "matrix": label, "n": A.shape[0],
        "entries": meta["entries"], "stream_slots": sell["sv"].numel(),
        "XW": meta["XW"], "bound_ms": cs.bound(nbytes, 0)[0],
        "staged_equal_to_kernel": equal, "ms_in_turns": times,
        "ms_mean": {name: float(np.mean(t)) for name, t in times.items()}}),
        flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sell_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    dll = build_variant()
    for label, make in (
            ("packed", lambda: permute_locally(stencil_3d(*cs.PACKED_DIMS,
                                                          points=27))),
            ("fem", lambda: build_matrix_data(cs.ILU_CASE))):
        A = gtt.Csr.from_data(make(), dtype=np.float32)
        probe(label, A, dll)
        del A
    return 0


if __name__ == "__main__":
    sys.exit(main())
