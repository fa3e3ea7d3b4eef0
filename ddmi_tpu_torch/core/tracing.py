"""Spans and values recorded inside the port, in memory, on the host's clock.

`span(name, **attrs)` is a context manager around work on the thread that
launches the device work it covers.  With no recorder installed and no
torch profiler running it checks two module globals and returns one shared
no-op context: it reads no clock and records nothing.  `enable()` installs a
`Recorder` and returns it; while one is installed, a span appends
(name, thread id, start ns, end ns, attrs) to `Recorder.spans` as it closes,
and `observe(name, value, **attrs)` appends (name, thread id, ns, value,
attrs) to `Recorder.values`: a per-request quantity that is not an interval
on the launching thread.  `disable()` removes the recorder, and
`recorder()` returns the one installed, if any.  The thread id is
`threading.get_ident()` (`Thread.ident`; the kernel's id costs a system
call).  There is no exporter: whoever enabled the recorder reads it.

The clock is `time.perf_counter_ns`, the clock of the benchmark's own spans
(benchmark/harness/spans.py), which `benchmark/harness/trace.py::clock_offset`
ties to a device profile through the spin kernels that close it.  The
program's spans therefore land on the device timeline within the
uncertainty of that tie, which each traced run prints.

While a torch profiler is running (torch.autograd.profiler's module flag,
one global read), a span also opens a `torch.profiler.record_function`
range of its name, so a profile (`core/metrics.py::ProfilerHook`'s Chrome
traces, chip_smoke.py's splits) shows the spans: the training paths'
`stage1/*` stages and the sampling spans below.

A span is opened only on the thread that launches the device work it
covers: a device trace gives an operation to every span open at its launch,
and names an idle gap by the open span that started last, whatever its
thread.  Names are `<layer>.<what>`:

    service.collect     serve/server.py::_worker: top of the loop to the
                        batch taken (lock, linger, take); attrs batch,
                        seeds (in take order), samples, padding
    service.queue_wait  (value) per request taken: seconds from `generate`
                        enqueuing it to the worker taking it; attrs
                        batch, seed
    service.noise       _run_batch: the per-seed numpy draws, their
                        concatenation and the copy to the device
    service.finish      _run_batch: the finite check, where the worker
                        waits for the batch's device work
    service.reply       _run_batch: the uint8 conversion, the copy to the
                        host, the results handed to the requests
    sampler.step        diffusion/process.py: one DDIM step (model call,
                        mixed prediction, update)
    sampler.norm        nn/unet.py: a ResBlock's GroupNorm and its SiLU,
                        and the output head's; inside the CUDA graphs'
                        segments it records at their capture alone
    sampler.graphed     (value) nn/unet.py: per UNet forward, 1 where it
                        replayed the forward's CUDA graphs, 0 where it ran
                        eagerly
    render.input        domains/nerf.py::render_rays: `mlp_input`
    render.mlp          domains/nerf.py::render_rays: `run_mlp`
    sampler.xattn       nn/unet_triplane.py: one cross-plane attention of
                        the TriplaneUNet (`cross_plane`); a replay of its
                        CUDA graphs opens and closes it around the graphs
                        and the kernel call it covers (core/graphs.py)
    decoder.xattn       nn/video_vae.py: one cross-plane attention of the
                        video decoder (`AttnBlock1DExpand`)
    kernels.mha_vmem/<B>x<nh>x<n>x<hd>
                        ops/attention.py: one launch of the short-sequence
                        attention kernel on (B, nh, n, hd) operands
    kernels.flash/<B>x<nh>x<n>x<hd>
                        ops/flash_attention.py: one launch of the flash
                        forward

The kernels' names carry their operands' shapes, which `shape_span`
formats only where the span will record.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from torch.autograd import profiler as _profiler


class Recorder:
    """What the spans and values recorded while this recorder was installed."""

    def __init__(self):
        self.spans = []   # (name, thread id, start ns, end ns, attrs)
        self.values = []  # (name, thread id, ns, value, attrs)

    def clear(self) -> None:
        self.spans.clear()
        self.values.clear()


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs) -> None:
        pass


OFF = _Off()
_recorder: Optional[Recorder] = None


class _Span:
    __slots__ = ("_recorder", "_name", "attrs", "_t0", "_range")

    def __init__(self, recorder: Optional[Recorder], name: str, attrs: dict):
        self._recorder, self._name, self.attrs = recorder, name, attrs
        self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._recorder is not None:
            self._recorder.spans.append(
                (self._name, threading.get_ident(), self._t0, t1, self.attrs))
        return None

    def set(self, **attrs) -> None:
        """Attributes known only once the span's work is done."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A span `name` around the `with` block (see the module's docstring)."""
    recorder = _recorder
    if recorder is None and not _profiler._is_profiler_enabled:
        return OFF
    return _Span(recorder, name, attrs)


def shape_span(prefix: str, shape):
    """A span `<prefix>/<d0>x<d1>x...` of a shape; its name is formatted
    only where the span will record."""
    recorder = _recorder
    if recorder is None and not _profiler._is_profiler_enabled:
        return OFF
    return _Span(recorder, prefix + "/" + "x".join(str(int(d)) for d in shape), {})


def observe(name: str, value: float, **attrs) -> None:
    """Record `value` under `name` at the present time, if a recorder is
    installed."""
    recorder = _recorder
    if recorder is not None:
        recorder.values.append(
            (name, threading.get_ident(), time.perf_counter_ns(), value, attrs))


def enable() -> Recorder:
    """Install a new recorder and return it."""
    global _recorder
    _recorder = Recorder()
    return _recorder


def recorder() -> Optional[Recorder]:
    """The installed recorder, or None."""
    return _recorder


def disable() -> None:
    """Remove the recorder: spans and values record nothing again."""
    global _recorder
    _recorder = None
