"""One reader a metric, ``<name>.py`` with ``read(run)``: the metric's
value from a finished run (``harness.Run``), or None where the run holds
nothing for it to read.  The harness reports a cell's ``end_to_end``
metrics with ``--trace 0`` and its ``per_layer`` ones with ``--trace 1``."""
