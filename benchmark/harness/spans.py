"""The harness's spans around the calls into each layer of the program.

Nothing of the program is edited: a span is opened by a wrapper that
replaces a bound method on one instance, or by forward hooks on a module,
and is kept as (name, start, end) on the host's clock
(`time.perf_counter_ns`), in memory, from any thread.  The profile's device
operations are given to spans by their launch calls (trace.py), so the
profiler records no host operation and costs the host little.  Span names
are `<layer>.<what>`; an attention block's carries its shapes,
`kernels.attn_block/<b>x<c>x<h>x<w>x<heads>`, which the roofline reader
works from.  Spans are installed only in a traced run."""

from __future__ import annotations

import functools
import time

ATTN_BLOCK = "kernels.attn_block"
UNET = "sampler.unet"
BATCH = "service.batch"


class Spans:
    def __init__(self):
        self.done = []           # (name, start ns, end ns)

    def wrap(self, owner, attr: str, name: str) -> None:
        """Run owner.<attr>(...) inside a span `name`."""
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def spanned(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return orig(*args, **kwargs)
            finally:
                self.done.append((name, t0, time.perf_counter_ns()))

        setattr(owner, attr, spanned)

    def hook(self, module, name_of) -> None:
        """Run module's forward inside a span `name_of(module, inputs)`."""
        open_spans = []

        def pre(mod, inputs):
            open_spans.append((name_of(mod, inputs), time.perf_counter_ns()))

        def post(mod, inputs, output):
            name, t0 = open_spans.pop()
            self.done.append((name, t0, time.perf_counter_ns()))

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)

    def install(self, pipe, methods) -> None:
        """Spans on the pipeline: `methods` maps a span name to (dotted path
        of the owner below the pipeline, '' for the pipeline itself, method
        name); forward hooks on the denoiser and on each of its attention
        blocks."""
        for name, (path, attr) in methods.items():
            owner = pipe
            for part in filter(None, path.split(".")):
                owner = getattr(owner, part)
            self.wrap(owner, attr, name)
        self.hook(pipe.unet, lambda mod, inputs: UNET)
        for mod in pipe.unet.modules():
            if type(mod).__name__ == "AttentionBlock":
                self.hook(mod, attn_name)


def attn_name(module, inputs) -> str:
    b, c, h, w = inputs[0].shape
    return f"{ATTN_BLOCK}/{b}x{c}x{h}x{w}x{module.num_heads}"
