"""CUDA graphs for the sampler's repeated work: the UNet forward's segments
between its attention blocks (nn/unet.py) and the DDIM update
(diffusion/process.py).

A graph replays the kernels its capture launched, on the tensors they
launched on: its inputs are static tensors that the caller writes before a
replay, and its outputs are the tensors the captured code returned, which
each replay overwrites.  Parameters and schedules are read where they lay at
the capture, so an in-place update (an optimizer step, `load_state_dict`,
`copy_`) is seen by the next replay and a tensor that moves is not.

`available(t)` says whether graphs can run work on `t` (a CUDA tensor).
`Capturer(device)` captures callables on a side stream of its own, into
graphs that share one memory pool: they must replay in the order they were
captured, as the UNet's segments do.  `static_like(t)` allocates a static
input outside inference mode, so that it can be written in place in and
out of `torch.inference_mode`.  `Segments` captures a callable whole,
cut into graphs at the calls it routes through `eager` and at the ends of
its `span`s (the TriplaneUNet's forward, nn/unet_triplane.py)."""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from ddmi_tpu_torch.core import tracing


def available(t: torch.Tensor) -> bool:
    """Whether work on `t` can be captured: a CUDA tensor."""
    return t.is_cuda


def static_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised normal (not inference) tensor like `t`, of its memory
    format."""
    with torch.inference_mode(False):
        return torch.empty_like(t)


class Capturer:
    """Captures callables into CUDA graphs that share one memory pool."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.pool = None
        self._graph = self._current = None

    def begin(self) -> None:
        """Start a graph: what this thread launches until `end` is captured
        on the side stream."""
        self._graph = torch.cuda.CUDAGraph()
        self._current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(self._current)
        torch.cuda.set_stream(self.stream)
        self._graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self):
        """End the graph `begin` started and replay it once on the current
        stream -> the graph."""
        graph, self._graph = self._graph, None
        try:
            graph.capture_end()
        finally:
            torch.cuda.set_stream(self._current)
        self._current.wait_stream(self.stream)
        if self.pool is None:
            self.pool = graph.pool()
        graph.replay()
        return graph

    def capture(self, fn):
        """Capture `fn()` into a graph and replay it once on the current
        stream: -> (graph, fn's output), whose tensors the graph's replays
        overwrite.  Every kernel `fn` launches must have run once before in
        the process (lazy module loading), and `fn` must not synchronise."""
        self.begin()
        try:
            out = fn()
        except BaseException:
            self.abandon()
            raise
        return self.end(), out

    def abandon(self) -> None:
        """After an error inside a capture: leave the graph unfinished and
        the side stream."""
        self._graph = None
        torch.cuda.set_stream(self._current)


_cutting = threading.local()


def eager(fn, *xs):
    """`fn(*xs)`; inside `Segments.capture`, a cut there."""
    segments = getattr(_cutting, "segments", None)
    return fn(*xs) if segments is None else segments.cut(fn, xs)


def span(name: str):
    """`tracing.span(name)`; inside `Segments.capture`, a span that each
    replay opens and closes around the graphs and cuts it covers."""
    segments = getattr(_cutting, "segments", None)
    return tracing.span(name) if segments is None else segments.span(name)


class Segments:
    """A callable captured whole as graphs, with steps run eagerly between
    them: a cut at each `eager(fn, *xs)` call, which runs `fn(*xs,
    out=buf)` into a static tensor `buf` like xs[0] (the call's output,
    which `eager` returns), and a step at each end of a `span(name)`, which
    opens or closes the span.  `replay()` replays the graphs in order with
    each step between them, on the tensors of the capture: the cuts' calls
    run as in an eager forward (their spans, hooks and counters too), and
    a span holds the device work of the graphs and cuts it covers.  Two
    steps with no launch between them leave an empty graph (CUDA warns of
    it at the capture), which replays as nothing.  The rules of
    `Capturer.capture` hold for the callable."""

    def __init__(self, device):
        self.capturer, self.graphs, self.steps, self._open = Capturer(device), [], [], []

    def capture(self, fn):
        """Capture `fn()`, cut at its steps -> fn's output."""
        self.capturer.begin()
        _cutting.segments = self
        try:
            out = fn()
        except BaseException:
            self.capturer.abandon()
            raise
        finally:
            _cutting.segments = None
        self.graphs.append(self.capturer.end())
        return out

    def _step(self, step) -> None:
        """End the graph being captured, run `step()` eagerly and keep it
        for the replays, begin the next graph."""
        self.graphs.append(self.capturer.end())
        _cutting.segments = None
        try:
            step()
        finally:
            _cutting.segments = self
        self.steps.append(step)
        self.capturer.begin()

    def cut(self, fn, xs):
        buf = static_like(xs[0])
        self._step(functools.partial(fn, *xs, out=buf))
        return buf

    @contextlib.contextmanager
    def span(self, name: str):
        self._step(functools.partial(self._enter, name))
        yield
        self._step(self._exit)

    def _enter(self, name: str) -> None:
        s = tracing.span(name)
        s.__enter__()
        self._open.append(s)

    def _exit(self) -> None:
        self._open.pop().__exit__(None, None, None)

    def replay(self) -> None:
        self.graphs[0].replay()
        for step, graph in zip(self.steps, self.graphs[1:]):
            step()
            graph.replay()
