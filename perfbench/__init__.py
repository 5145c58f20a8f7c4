"""The benchmark of ``ginkgo_tpu_torch`` on one CUDA card (see README.md)."""
