"""Banded (diagonal-offset) SpMV/SpMM — the counterpart of
``ginkgo_tpu/ops/spmv_pallas.py``.

y[i, k] = sum_d dv[d, i] * x[i + off_d, k] over the build-time blocked
layout ``dvb (G, D, S, 128)``.  This module holds the host layout planner
(verbatim), the plain torch version and the wrapper of the CUDA kernel
``csrc/dia_spmv.cu``, which replaces the Pallas kernel
``ginkgo_tpu/ops/spmv_pallas.py::_dia_kernel``.

The kernel is bounded by bytes: it streams dvb once a launch, plus x and y.
One real column takes its narrow instance; two or more take its wide one,
which reads dvb once for up to 16 columns and moves x and y in 16-byte
pieces on neighbouring lanes (``kernel_instance``).  See the source for
their design.

Complex values take the same kernel instantiated for interleaved complex
types (``dia_spmv_complex_cuda``, counted apart): it replaces the TPU's
``dia_spmv_complex`` (``spmv_pallas.py:246``), which splits the values into
re/im planes for two real passes because Mosaic has no complex vregs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from .registry import register

LANES = 128
MAX_RHS = 8        # columns a launch of the complex instantiation
WIDE_RHS = 16      # columns a launch of the wide instance

# (value storage, vector) dtypes the kernel takes: f32 math for f32 and
# bf16/f16 storage with f32 vectors, f64 math for f64
KERNEL_DTYPES = {(torch.float32, torch.float32),
                 (torch.bfloat16, torch.float32),
                 (torch.float16, torch.float32),
                 (torch.float64, torch.float64)}
# and its complex instantiations: complex64 math for a complex64 matrix or
# a real f32/bf16/f16 one with a complex64 vector, complex128 for complex128
COMPLEX_KERNEL_DTYPES = {(torch.complex64, torch.complex64),
                         (torch.float32, torch.complex64),
                         (torch.bfloat16, torch.complex64),
                         (torch.float16, torch.complex64),
                         (torch.complex128, torch.complex128)}
_F32ISH = (torch.float32, torch.bfloat16, torch.float16)


def kernel_vector(value_dtype, b):
    """``b`` as the SpMV kernels take it: with a complex64 matrix a real
    f32/bf16/f16 vector is cast to complex64 first, as the JAX package's
    ``dia_spmv_tpu``/``pell_spmv_tpu`` do (``_c64_capable``)."""
    if value_dtype == torch.complex64 and b.dtype in _F32ISH:
        return b.to(torch.complex64)
    return b


def plan_banded_layout(offsets, n, *, S=128, NB=4):
    """Static layout plan for a banded matrix (build-time)."""
    lo = -min(min(offsets), 0)
    hi = max(max(offsets), 0)
    LO = -(-lo // LANES)
    HI = hi // LANES + 1
    NS = -(-n // LANES)
    while S > 8 and S > NS:
        S //= 2
    G = -(-NS // S)
    NB = max(1, min(NB, G))
    G = -(-G // NB) * NB           # whole NB groups
    NSp = G * S
    W = -(-(S + LO + HI) // 8) * 8  # DMA windows: 8-sublane aligned
    HI += W - (S + LO + HI)
    return dict(S=S, NB=NB, LO=LO, HI=HI, W=W, G=G, NSp=NSp, n=n)


def block_diag_values(diag_values, meta):
    """(D, n) -> (G, D, S, 128) contiguous per-block chunks: a numpy array
    on the host, or a tensor on its own device."""
    D, n = diag_values.shape
    NSp, S, G = meta["NSp"], meta["S"], meta["G"]
    if isinstance(diag_values, torch.Tensor):
        dv = diag_values.new_zeros((D, NSp * LANES))
        dv[:, :n] = diag_values
        return dv.reshape(D, G, S, LANES).permute(1, 0, 2, 3).contiguous()
    dv = np.zeros((D, NSp * LANES), diag_values.dtype)
    dv[:, :n] = diag_values
    return np.ascontiguousarray(
        dv.reshape(D, G, S, LANES).transpose(1, 0, 2, 3))


def unblock_diag_values(dvb, meta):
    """(G, D, S, 128) -> (D, n) — used by the plain version."""
    G, D, S, _ = dvb.shape
    return dvb.permute(1, 0, 2, 3).reshape(D, -1)[:, :meta["n"]]


@register("dia_spmv", "reference")
def dia_spmv_reference(offsets, dvb, meta, b, out=None):
    """Plain version of the banded kernel: unblock the (G, D, S, 128)
    layout back to (D, n), pad b once by the band extent, and accumulate
    full-length shifted slices in diagonal order.  With ``out`` the result
    is copied into it and ``out`` returned."""
    diag_values = unblock_diag_values(dvb, meta)
    n = meta["n"]
    lo = -min(min(offsets), 0)
    hi = max(max(offsets), 0)
    xp = F.pad(b, (0, 0, lo, hi))
    acc = diag_values[0][:, None].to(b.dtype) * xp[lo + offsets[0]:
                                                   lo + offsets[0] + n]
    for d, off in enumerate(offsets[1:], start=1):
        acc = acc + diag_values[d][:, None].to(b.dtype) * \
            xp[lo + off: lo + off + n]
    return acc if out is None else out.copy_(acc)


@functools.lru_cache(maxsize=64)
def _offsets_on(offsets: tuple, device: torch.device):
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def kernel_instance(k, is_complex):
    """The instance of kernel A that takes ``k`` columns: complex operands
    the complex instantiation (``MAX_RHS`` columns a launch); one real
    column the narrow instance (a thread a row); two or more the wide one
    (lanes on 16-byte pieces of a row, ``WIDE_RHS`` columns a launch)."""
    if is_complex:
        return "complex"
    return "narrow" if k == 1 else "wide"


def column_chunks(k, width):
    """(first column, columns) of each launch over ``k`` columns."""
    return [(c0, min(width, k - c0)) for c0 in range(0, k, width)]


@register("dia_spmv", "cuda")
def dia_spmv_cuda(offsets, dvb, meta, b, out=None):
    """Banded SpMV/SpMM on the CUDA kernel, its instance chosen by
    ``kernel_instance``: one column launches the narrow instance here, more
    go to ``dia_spmv_wide_cuda`` and complex operands to
    ``dia_spmv_complex_cuda``.  ``out`` (optional): a contiguous (n, k)
    tensor the kernel writes instead of a new one.

    A tensor on the CPU takes the plain version; on a CUDA device this
    launches the kernel or raises — it never falls back."""
    b = kernel_vector(dvb.dtype, b)
    if b.device.type != "cuda":
        return dia_spmv_reference(offsets, dvb, meta, b, out)
    instance = kernel_instance(b.shape[-1],
                               b.is_complex() or dvb.is_complex())
    if instance == "complex":
        return dia_spmv_complex_cuda(offsets, dvb, meta, b, out)
    if instance == "wide":
        return dia_spmv_wide_cuda(offsets, dvb, meta, b, out)
    y = _output(offsets, dvb, meta, b, KERNEL_DTYPES, out)
    if y.numel() == 0:
        return y
    _launch("dia_spmv_launch", offsets, dvb, meta, b, y, 0, 1)
    dia_spmv_cuda.launches += 1
    return y


def dia_spmv_wide_cuda(offsets, dvb, meta, b, out=None):
    """Banded SpMM on the kernel's wide instance (real ``KERNEL_DTYPES``),
    one launch per <= 16 columns, each reading dvb once.

    A tensor on the CPU takes the plain version; on a CUDA device this
    launches the kernel or raises."""
    if b.device.type != "cuda":
        return dia_spmv_reference(offsets, dvb, meta, b, out)
    y = _output(offsets, dvb, meta, b, KERNEL_DTYPES, out)
    if y.numel() == 0:
        return y
    for c0, cols in column_chunks(b.shape[1], WIDE_RHS):
        _launch("dia_spmv_wide_launch", offsets, dvb, meta, b, y, c0, cols)
        dia_spmv_wide_cuda.launches += 1
    return y


def dia_spmv_complex_cuda(offsets, dvb, meta, b, out=None):
    """Complex banded SpMV/SpMM on the kernel's complex instantiation
    (``COMPLEX_KERNEL_DTYPES``), one launch per <= 8 columns: the
    counterpart of ``ginkgo_tpu/ops/spmv_pallas.py::dia_spmv_complex``.

    A tensor on the CPU takes the plain version; on a CUDA device this
    launches the kernel or raises."""
    b = kernel_vector(dvb.dtype, b)
    if b.device.type != "cuda":
        return dia_spmv_reference(offsets, dvb, meta, b, out)
    y = _output(offsets, dvb, meta, b, COMPLEX_KERNEL_DTYPES, out)
    if y.numel() == 0:
        return y
    for c0, cols in column_chunks(b.shape[1], MAX_RHS):
        _launch("dia_spmv_launch", offsets, dvb, meta, b, y, c0, cols)
        dia_spmv_complex_cuda.launches += 1
    return y


def _output(offsets, dvb, meta, b, dtypes, out=None):
    """Check that the operands fit the kernel and return the (n, k)
    output (``out`` when given); raises on what the kernel does not
    take."""
    n = meta["n"]
    if (dvb.dtype, b.dtype) not in dtypes:
        raise TypeError(f"dia_spmv kernel takes (values, vector) dtypes "
                        f"{sorted(map(str, dtypes))}, got "
                        f"({dvb.dtype}, {b.dtype})")
    G, D, S, lanes = dvb.shape
    if (b.ndim != 2 or b.shape[0] != n or lanes != LANES
            or D != len(offsets) or G * S * LANES < n):
        raise ValueError(f"dia_spmv: dvb {tuple(dvb.shape)} with "
                         f"{len(offsets)} offsets and b {tuple(b.shape)} do "
                         f"not fit n={n}")
    if dvb.device != b.device:
        raise ValueError(f"dia_spmv: dvb on {dvb.device}, b on {b.device}")
    if not (dvb.is_contiguous() and b.is_contiguous()):
        raise ValueError("dia_spmv: dvb and b must be contiguous")
    if out is None:
        return torch.empty((n, b.shape[1]), dtype=b.dtype, device=b.device)
    if (tuple(out.shape) != (n, b.shape[1]) or out.dtype != b.dtype
            or out.device != b.device or not out.is_contiguous()):
        raise ValueError(f"dia_spmv: out {tuple(out.shape)}/{out.dtype} on "
                         f"{out.device} is not a contiguous "
                         f"({n}, {b.shape[1]})/{b.dtype} on {b.device}")
    return out


def _launch(entry, offsets, dvb, meta, b, y, c0, cols):
    """One launch of ``entry`` for columns ``[c0, c0 + cols)`` of ``b``
    into ``y``."""
    n, k = meta["n"], b.shape[1]
    offs = _offsets_on(tuple(int(o) for o in offsets), b.device)
    G, D, S, _ = dvb.shape
    esize = b.element_size()
    launch = getattr(_cuda.library("dia_spmv"), entry)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        code = launch(
            _cuda.type_code(dvb.dtype), _cuda.type_code(b.dtype),
            dvb.data_ptr(), offs.data_ptr(), D, S, n,
            b.data_ptr() + c0 * esize, k, y.data_ptr() + c0 * esize, k,
            cols, stream)
    _cuda.check("dia_spmv", code)


dia_spmv_cuda.launches = 0           # narrow launches since the last reset
dia_spmv_wide_cuda.launches = 0      # wide launches since the last reset
dia_spmv_complex_cuda.launches = 0   # complex launches since the last reset
