"""Host milliseconds of one DDIM step (the program's `sampler.step` span:
the model call, mixed prediction and update it enqueues, or its wait where
the launch queue is full), the mean over every step of the batches of the
traced run's window outside the profile and its read-out."""

from benchmark.metrics import _program
from benchmark.metrics.service_host_ms import worker_spans

_program.install()


def read(run):
    batches = worker_spans(run)
    steps = [t1 - t0 for _, _, inside in batches or () for t0, t1 in inside.get("sampler.step", ())]
    return sum(steps) / len(steps) / 1e6 if steps else None
