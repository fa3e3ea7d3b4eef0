"""Device milliseconds per batch of the render (the INR on the pixel grid,
or the NeRF render of every view)."""


def read(run):
    t = run.trace
    r = t.ranges.get("render.render") if t is not None else None
    return 1e3 * float(r.device_s.sum()) / t.batches if r is not None and len(r.start) else None
