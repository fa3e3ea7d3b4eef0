"""The 95th percentile of the milliseconds a request waits in the service's
queue, from `generate` enqueuing it to the worker taking it into a batch
(the program's `service.queue_wait` values), over the requests of the
traced run's window that neither waited through the profile and its
read-out nor were taken inside it."""

import statistics

from benchmark.metrics import _program

_program.install()


def read(run):
    s, rec = run.session, _program.recorder(run)
    if rec is None:
        return None
    opened = run.window.opened * 1e9
    waits = [v for name, _, t, v, _ in rec.values if name == "service.queue_wait"
             and t - v * 1e9 >= opened and (t < s.paused or t - v * 1e9 > s.resumed)]
    if len(waits) < 20:
        return None
    return 1e3 * statistics.quantiles(waits, n=100, method="inclusive")[94]
