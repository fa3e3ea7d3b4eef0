"""Per traced batch, the milliseconds of the traced window in which the
device ran none of the pipeline's sampling work: the window less, for each
batch, the device span from the first to the last operation launched inside
its `sample_latents` and decode calls.  It holds the host's noise draws,
the batching, the copy to the card and the uint8 copy-out."""

import numpy as np


def read(run):
    t = run.trace
    if t is None or not t.batches:
        return None
    pipe = [r for name in ("sampler.sample_latents", "render.decode") for r in t.select(name)]
    batches = t.ranges.get("service.batch")
    if not pipe or batches is None:
        return None
    busy = 0.0
    for b0, b1 in zip(batches.start, batches.end):
        first = [r.first_op[(r.start >= b0) & (r.end <= b1)] for r in pipe]
        last = [r.last_op[(r.start >= b0) & (r.end <= b1)] for r in pipe]
        first, last = np.concatenate(first), np.concatenate(last)
        if len(first) and last.max() > 0:
            busy += (last.max() - first.min()) / 1e9
    return 1e3 * (t.window_s - busy) / t.batches
