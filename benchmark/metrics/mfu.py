"""The model FLOPs of the samples completed (counted once per sample over
the plain reference on the meta device: the denoiser times the steps, the
decoder, the render) over the seconds they took times the card's published
bf16 peak, in percent.  It is read over the traced run's whole window
outside the profile: the samples of every batch served there, over the
window's seconds less the stretch from before the profiler starts to the
end of its read-out, which slows a host-bound cell and holds the service up."""

from benchmark.work.peaks import BF16_FLOPS


def read(run):
    rest = run.session.unprofiled(run.window.seconds) if run.trace is not None else None
    if rest is None or not rest[0] or rest[1] <= 0:
        return None
    w = run.work
    return 100.0 * (w["denoiser"] + w["decoder"] + w["render"]) * rest[0] / (rest[1] * BF16_FLOPS)
