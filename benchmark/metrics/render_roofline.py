"""The render's least time per batch (the reference render's FLOPs and
bytes at the cell's shapes, against the card's published peaks) over its
device time per batch, in percent."""

from benchmark.work.peaks import least_seconds


def read(run):
    t = run.trace
    r = t.ranges.get("render.render") if t is not None else None
    if r is None or not len(r.start):
        return None
    device = float(r.device_s.sum()) / t.batches
    least = least_seconds(run.work["render"] * run.batch, run.work["render_bytes"] * run.batch)
    return 100.0 * least / device if device > 0 else None
