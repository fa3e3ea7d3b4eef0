"""The program's own spans and values (ddmi_tpu_torch/core/tracing.py), for
the readers of this directory that read them.

The harness loads the per-layer readers in a traced run alone, and before
it builds the session (run.py); each of these readers calls `install()`
as it is loaded, which installs the program's recorder, so that it holds
the spans and values of the warm-up and of the whole window.  An untraced
run loads none of them and installs no recorder.  The readers tell the
warm-up and the profile apart by the host's clock, on which the session
keeps its batches and the profile's start and stop.

`reduction(run)` is the traced batches' reduction (harness/trace.py) with
the worker thread's program spans of the profiled stretch beside the
harness's spans, so that device work is given to the program's spans too
and an idle gap is named by the program span open at its start; it prints
those idle gaps to standard error.  The run's own `trace` is left as the
harness made it.  A program without core/tracing.py records nothing:
`recorder` and `reduction` give None, and the readers leave their metrics
out of the line."""

from __future__ import annotations

import json
import sys

try:
    from ddmi_tpu_torch.core import tracing
except ImportError:
    tracing = None

_last = [None, None]   # the run last reduced, and its reduction


def install() -> None:
    """Install the program's recorder, unless one is installed."""
    if tracing is not None and tracing.recorder() is None:
        tracing.enable()


def recorder(run):
    """The program's recorder in a traced run whose profile was read, else
    None."""
    if tracing is None or run.trace is None or run.session.reduction_args is None:
        return None
    return tracing.recorder()


def reduction(run):
    if _last[0] is run:
        return _last[1]
    from benchmark.harness import trace

    rec, out = recorder(run), None
    if rec is not None:
        s = run.session
        stop, worker = s.reduction_args[1], s.svc._worker_thread.ident
        program = [(n, t0, t1) for n, tid, t0, t1, _ in rec.spans
                   if tid == worker and t1 >= s.paused and t0 <= stop]
        if program:
            out = trace.reduce(s.events[0], s.spans.done + program, s.prof.marks,
                               *s.reduction_args)
            print("program spans: idle gaps " + json.dumps(out.idle_gaps), file=sys.stderr,
                  flush=True)
    _last[:] = [run, out]
    return out
