"""Seconds of ``Csr.from_data`` in set-up: the host planner and the upload
(the benchmark's own span around the call)."""


def read(run):
    return run.spans.get("from_data")
