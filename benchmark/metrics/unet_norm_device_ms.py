"""Device milliseconds of the operations launched inside the program's
`sampler.norm` spans (each ResBlock's GroupNorm and SiLU, and the output
head's) per UNet forward, the forwards being the traced batches'
`sampler.unet` calls."""

from benchmark.metrics import _program

_program.install()


def read(run):
    t = _program.reduction(run)
    if t is None:
        return None
    norm, unet = t.ranges.get("sampler.norm"), t.ranges.get("sampler.unet")
    if norm is None or unet is None or not len(norm.start) or not len(unet.start):
        return None
    return 1e3 * float(norm.device_s.sum()) / len(unet.start)
