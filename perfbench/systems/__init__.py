"""Adapters to the system under test, one module a kind of configuration,
found by the ``system`` name in a configuration file.  Only these modules
import the program (``ginkgo_tpu_torch``), and only inside functions."""
