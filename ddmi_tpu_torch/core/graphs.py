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
out of `torch.inference_mode`."""

from __future__ import annotations

import torch


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

    def capture(self, fn):
        """Capture `fn()` into a graph and replay it once on the current
        stream: -> (graph, fn's output), whose tensors the graph's replays
        overwrite.  Every kernel `fn` launches must have run once before in
        the process (lazy module loading), and `fn` must not synchronise."""
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            out = fn()
            graph.capture_end()
        current.wait_stream(self.stream)
        if self.pool is None:
            self.pool = graph.pool()
        graph.replay()
        return graph, out
