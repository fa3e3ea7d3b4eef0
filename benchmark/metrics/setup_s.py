"""Seconds from the process's start to the window's first request: imports,
the kernels' build or load, the weights, the service, the warm-up batch."""


def read(run):
    return run.setup_s
