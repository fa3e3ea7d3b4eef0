"""Samples (images, or scenes of n_views views) completed over the whole
window, per second of the window."""


def read(run):
    return run.samples / run.window.seconds if run.window.seconds > 0 else None
