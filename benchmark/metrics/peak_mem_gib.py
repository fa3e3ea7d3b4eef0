"""The device memory the window allocated at its peak
(`torch.cuda.max_memory_allocated` from the window's start), in GiB."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.trace is not None and run.peak_window_bytes else None
