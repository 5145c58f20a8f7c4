"""CLI dispatcher: ``python -m ginkgo_tpu_torch.benchmark <suite> [flags]``.

Suites mirror Ginkgo's benchmark executables: spmv, solver,
preconditioner, blas, sparse_blas, conversion, matrix_statistics,
distributed (weak scaling over a mesh of parts on one device),
matrix_generator.
"""

import importlib
import sys

SUITES = ("spmv", "solver", "preconditioner", "blas", "sparse_blas",
          "conversion", "matrix_statistics", "distributed",
          "matrix_generator")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in SUITES:
        sys.stderr.write(
            f"usage: python -m ginkgo_tpu_torch.benchmark "
            f"<{'|'.join(SUITES)}> [flags]\n")
        return 2
    mod = importlib.import_module(f".{argv[0]}", __package__)
    mod.main(argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
