"""The UNet's attention blocks: their least time (work/attention.py, from
each call's shapes, against the card's published peaks) over their device
time, in percent."""

from benchmark.work.attention import block_bytes, block_flops
from benchmark.work.peaks import least_seconds


def read(run):
    t = run.trace
    if t is None:
        return None
    least = device = 0.0
    for name, r in t.ranges.items():
        if not name.startswith("kernels.attn_block/") or not len(r.start):
            continue
        b, c, h, w, _ = (int(v) for v in name.split("/", 1)[1].split("x"))
        least += len(r.start) * least_seconds(block_flops(b, c, h * w), block_bytes(b, c, h * w))
        device += float(r.device_s.sum())
    return 100.0 * least / device if device > 0 else None
