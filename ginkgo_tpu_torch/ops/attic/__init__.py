"""Attic: superseded SpMV kernel generations (``ginkgo_tpu/ops/attic`` in
torch).

Two earlier answers to the general-unstructured SpMV problem, both
superseded by the packed-slot windowed-ELL kernel (``ops/spmv_packed.py``,
the ``packed`` CSR strategy):

- ``spmv_windowed``: windowed ELL with int16 window-relative columns
  (kernel G);
- ``spmv_chunked``: chunk ELL, one x chunk per 8-slot vreg (kernel H).

Both kernels are ``csrc/sell_spmv.cu`` over their slab's compact stream
(``ops/spmv_sell.py``).

Each module holds its host planner (verbatim), a plain torch version, the
wrapper of its CUDA kernel and an ``apply`` that adds the COO tail.  These
modules are NOT imported by the package; their kernels enter the registry
only when imported explicitly:

    from ginkgo_tpu_torch.ops.attic import spmv_windowed, spmv_chunked
"""
