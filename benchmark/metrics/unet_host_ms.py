"""Host milliseconds of one UNet forward call (its enqueue, or its wait
where the launch queue is full), the mean over every forward of the traced
run's window outside the profile, which costs the host time on every
launch."""


def read(run):
    rest = run.session.unprofiled(run.window.seconds) if run.trace is not None else None
    if rest is None or not rest[2]:
        return None
    return 1e3 * sum(rest[2]) / len(rest[2])
