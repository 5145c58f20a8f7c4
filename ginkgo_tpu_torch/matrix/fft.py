"""DFT operators (Fft / Fft2 / Fft3) (``ginkgo_tpu/matrix/fft.py`` in
torch).

Analog of ``include/ginkgo/core/matrix/fft.hpp:45,143,255`` — the discrete
Fourier transform as a LinOp, backed by cuFFT in the reference and here by
``torch.fft`` (the JAX package calls ``jnp.fft``; no Pallas kernel computes
an FFT).  Convention matches Ginkgo/FFTW: unnormalised forward, inverse =
conjugate transpose scaled by 1/N.
"""

from __future__ import annotations

import torch

from ..base.dtypes import complex_dtype
from ..base.linop import LinOp


class Fft(LinOp):
    """1-D DFT over multivector rows: x = scale * FFT(b) columnwise."""

    def __init__(self, size, inverse=False, scale=1.0):
        self.size = int(size)
        self.inverse = bool(inverse)
        self.scale = float(scale)

    @property
    def shape(self):
        return (self.size, self.size)

    def _apply(self, b):
        bc = b.to(complex_dtype(b.dtype))
        out = (torch.fft.ifft(bc, dim=0) if self.inverse
               else torch.fft.fft(bc, dim=0))
        return out if self.scale == 1.0 else out * self.scale

    def transpose(self):
        return self          # the DFT matrix is symmetric

    def conj_transpose(self):
        # true adjoint: F^H = N * ifft (the op convention keeps ifft
        # normalised, so the adjoint carries the explicit N)
        if self.inverse:
            return Fft(size=self.size, inverse=False,
                       scale=self.scale / self.size)
        return Fft(size=self.size, inverse=True,
                   scale=self.scale * self.size)


class FftNd(LinOp):
    """N-D DFT on a flattened grid: rows index the grid row-major
    (``fft.hpp`` Fft2/Fft3 semantics)."""

    def __init__(self, dims, inverse=False, scale=1.0):
        self.dims = tuple(int(d) for d in dims)
        self.inverse = bool(inverse)
        self.scale = float(scale)

    @property
    def shape(self):
        n = 1
        for d in self.dims:
            n *= d
        return (n, n)

    def _apply(self, b):
        k = b.shape[1]
        bc = b.to(complex_dtype(b.dtype))
        grid = bc.reshape(*self.dims, k)
        axes = tuple(range(len(self.dims)))
        out = (torch.fft.ifftn(grid, dim=axes) if self.inverse
               else torch.fft.fftn(grid, dim=axes))
        out = out.reshape(self.shape[0], k)
        return out if self.scale == 1.0 else out * self.scale

    def conj_transpose(self):
        n = self.shape[0]
        if self.inverse:
            return FftNd(dims=self.dims, inverse=False,
                         scale=self.scale / n)
        return FftNd(dims=self.dims, inverse=True, scale=self.scale * n)


def Fft2(n1, n2=None, inverse=False):
    return FftNd(dims=(n1, n2 if n2 is not None else n1), inverse=inverse)


def Fft3(n1, n2=None, n3=None, inverse=False):
    n2 = n2 if n2 is not None else n1
    n3 = n3 if n3 is not None else n1
    return FftNd(dims=(n1, n2, n3), inverse=inverse)
