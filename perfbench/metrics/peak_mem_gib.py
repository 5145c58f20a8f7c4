"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 2**30
