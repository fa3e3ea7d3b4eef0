"""Device milliseconds per batch of the NeRF render's input assembly: the
operations launched inside the program's `render.input` spans (the
triplane gather, both embeddings, their concatenation)."""

from benchmark.metrics import _program

_program.install()


def read(run):
    t = _program.reduction(run)
    r = t.ranges.get("render.input") if t is not None else None
    return 1e3 * float(r.device_s.sum()) / t.batches if r is not None and len(r.start) else None
