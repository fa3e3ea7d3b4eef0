"""Device milliseconds of the operations one UNet forward call launches,
the mean over the traced batches' calls."""


def read(run):
    t = run.trace
    r = t.ranges.get("sampler.unet") if t is not None else None
    return 1e3 * float(r.device_s.mean()) if r is not None and len(r.start) else None
