"""Seconds from the process's start to the window's first solve: imports,
kernel and native builds (cached after a checkout's first run), the
matrix's generation, ``from_data``, the preconditioner and the warm-up."""


def read(run):
    return run.setup_s
