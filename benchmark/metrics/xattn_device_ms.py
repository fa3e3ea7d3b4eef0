"""Device milliseconds per batch of the triplane UNet's cross-plane
attentions: the operations launched inside the program's `sampler.xattn`
spans (nn/unet_triplane.py::cross_plane)."""

from benchmark.metrics import _program

_program.install()


def read(run):
    t = _program.reduction(run)
    r = t.ranges.get("sampler.xattn") if t is not None else None
    return 1e3 * float(r.device_s.sum()) / t.batches if r is not None and len(r.start) else None
