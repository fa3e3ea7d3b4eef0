"""The percent of the UNet forwards that replayed the forward's CUDA graphs
(the program's `sampler.graphed` values: 1 for a replay, 0 for an eager
forward), over the forwards of the traced run's window outside the profile
and its read-out.  A program that records no such value leaves it out."""

from benchmark.metrics import _program

_program.install()


def read(run):
    s, rec = run.session, _program.recorder(run)
    if rec is None:
        return None
    opened = run.window.opened * 1e9
    graphed = [v for name, _, t, v, _ in rec.values if name == "sampler.graphed"
               and t >= opened and (t < s.paused or t > s.resumed)]
    if not graphed:
        return None
    return 100.0 * sum(v == 1 for v in graphed) / len(graphed)
