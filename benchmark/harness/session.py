"""One service under test: the port's SamplerService built on weights drawn
from a seed, with a log of which requests each batch served, warmed up with
one batch of the cell's shapes and driven for one window by the cell's
traffic driver.  In a traced run the window's first batch runs before any
profiler has started, the next `trace_batches` batches are profiled
(trace.py), and the rest of the window again runs without the profiler:
the host's times per layer are read outside the profile."""

from __future__ import annotations

import gc
import time

import torch

from benchmark.harness import spans, trace, weights
from benchmark.harness.spans import Spans


class Session:
    def __init__(self, cell, seed: int, device: str, traced: bool = False):
        from ddmi_tpu_torch.core.config import config_from_dict
        from ddmi_tpu_torch.serve.server import SamplerService

        self.cell, self.seed, self.device = cell, seed, device
        self.conf, self.traffic, self.domain = cell.config, cell.traffic, cell.domain()
        cfg = config_from_dict(self.conf["config"])
        with torch.device("meta"):
            self.meta = self.domain.reference_models(self.conf)
        self.specs = weights.model_specs(self.meta, self.domain.program_keys(cfg),
                                         self.conf["init"]["rules"])
        channels = self.conf["config"]["model"]["params"]["ddpmconfig"]["channels"]
        sds = weights.state_dicts(self.specs, seed, device, torch.bfloat16, self.conf["init"],
                                  channels)
        self.batch = int(self.traffic["service_batch"])
        self.svc = SamplerService(cfg, service_batch=self.batch,
                                  linger_ms=float(self.traffic["linger_ms"]), device=device,
                                  state_dicts=sds, **self.domain.service_kwargs(self.conf))
        del sds
        self.worker_tid = getattr(getattr(self.svc, "_worker_thread", None), "native_id", None)
        # which requests each batch served, in its order: the image render's
        # noise is keyed by the batch's first seed and the sample's position
        self.placed = {}
        # (start, end, samples) of every batch of the window and, in a traced
        # run, (start, seconds) of every UNet forward, on the host's clock
        self.batch_log = []
        self.unet_log = []
        self.spans = self.prof = self.trace_open = self.reduction_args = None
        # the host's clock (ns) before the profiler starts and after its read-out
        self.paused = self.resumed = None
        self.events = []
        run_batch = self.svc._run_batch
        n_traced = int(self.traffic["trace_batches"])

        def logged(take, count):
            first, pos = take[0].seed, 0
            for r in take:
                self.placed[r.seed] = (first, pos)
                pos += r.n
            if self.prof is not None and len(self.batch_log) == 1:
                self.paused = time.perf_counter_ns()
                self.prof.start()
                self.trace_open = time.perf_counter_ns()
            t0 = time.perf_counter_ns()
            out = run_batch(take, count)
            t1 = time.perf_counter_ns()
            self.batch_log.append((t0 / 1e9, t1 / 1e9, count))
            if self.spans is not None:
                self.spans.done.append((spans.BATCH, t0, t1))
            if self.prof is not None and len(self.batch_log) == 1 + n_traced:
                stop = time.perf_counter_ns()
                self.events.append(self.prof.stop())
                self.reduction_args = (self.trace_open, stop)
                self.resumed = time.perf_counter_ns()
            return out

        self.svc._run_batch = logged
        if traced:
            self.spans = Spans()
            self.spans.install(self.svc.pipe, self.domain.SPANS)
            started = []
            unet = self.svc.pipe.unet
            unet.register_forward_pre_hook(lambda m, i: started.append(time.perf_counter()))
            unet.register_forward_hook(lambda m, i, o: self.unet_log.append(
                (started[-1], time.perf_counter() - started.pop())))
            self.prof = trace.Profile()

    def warmup(self) -> None:
        self.svc.warmup()
        self.batch_log.clear()
        self.unet_log.clear()
        if self.spans is not None:
            self.spans.done.clear()

    def reduce(self):
        """The traced batches' reduction (trace.py), or None: untraced, or
        the window ended before they were done."""
        if not self.events:
            return None
        return trace.reduce(self.events[0], self.spans.done, self.prof.marks,
                            *self.reduction_args)

    def unprofiled(self, window_s: float):
        """The window outside its profile, from before the profiler starts
        to the end of its read-out (whose host cost would slow a host-bound
        cell, and which hold up the worker for seconds): (the samples of the
        batches served there, its seconds, the seconds of each UNet forward
        there).  None untraced, or where the window ended before the
        profile did."""
        if self.reduction_args is None:
            return None
        t0, t1 = self.paused / 1e9, self.resumed / 1e9
        out = [b for b in self.batch_log if b[1] <= t0 or b[0] >= t1]
        forwards = [dt for t, dt in self.unet_log if any(b[0] <= t <= b[1] for b in out)]
        return sum(b[2] for b in out), window_s - (t1 - t0), forwards

    def serve(self, seconds: float):
        """One window of the cell's traffic.  A traced run profiles batches
        2 to 1 + trace_batches of it, from the service's worker thread."""
        return self.cell.driver().run(self.svc, self.traffic, seconds, self.seed)

    def close(self) -> None:
        """Stop the service and free its memory."""
        self.svc.close()
        self.svc = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()
