"""The attention kernels' least time (work/flash.py, from each launch's
shapes, against the card's published peaks) over their device time, in
percent: every launch inside the program's `kernels.mha_vmem/<shape>` and
`kernels.flash/<shape>` spans (ops/attention.py, ops/flash_attention.py)."""

from benchmark.metrics import _program
from benchmark.work.flash import attention_bytes, attention_flops
from benchmark.work.peaks import least_seconds

_program.install()
KERNELS = ("kernels.mha_vmem/", "kernels.flash/")


def read(run):
    t = _program.reduction(run)
    if t is None:
        return None
    least = device = 0.0
    for name, r in t.ranges.items():
        if not name.startswith(KERNELS) or not len(r.start):
            continue
        shape = [int(v) for v in name.split("/", 1)[1].split("x")]
        least += len(r.start) * least_seconds(attention_flops(*shape), attention_bytes(*shape))
        device += float(r.device_s.sum())
    return 100.0 * least / device if device > 0 else None
