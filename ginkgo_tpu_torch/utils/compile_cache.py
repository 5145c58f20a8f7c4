"""The kernels' build cache (``ginkgo_tpu/utils/compile_cache.py``'s API
in torch).

The JAX package points JAX's persistent compilation cache at a directory
so that the minutes-long first compile of its nested-loop solvers is paid
once per machine.  The port compiles nothing at solve time: its
hand-written kernels are built by ``nvcc`` at first use into
``ginkgo_tpu_torch/_kernels/``, under names carrying a digest of source
and flags, and every later process loads them from there
(``ops/_cuda.py``).  That directory is the port's persistent cache, and
``enable_compilation_cache`` names it; it changes nothing, and no solver
calls it.
"""

from __future__ import annotations

import os

from ..base.exceptions import NotSupportedError


def enable_compilation_cache(path: str | None = None) -> str | None:
    """The directory the port's kernels are built in and loaded from, or
    None when ``GINKGO_TPU_NO_COMPILE_CACHE`` is set.  The location is
    fixed: ``path`` may only name that same directory."""
    if os.environ.get("GINKGO_TPU_NO_COMPILE_CACHE"):
        return None
    from ..ops._cuda import BUILD_DIR
    if path is not None and os.path.abspath(path) != str(BUILD_DIR):
        raise NotSupportedError(
            f"the port's kernels are built in {BUILD_DIR}; another cache "
            f"location ({path}) is not supported")
    return str(BUILD_DIR)
