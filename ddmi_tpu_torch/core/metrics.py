"""Metrics logging and the profiler hook (counterpart of
ddmi_tpu/core/metrics.py): a JSONL stream and stdout lines, whose device
values are deferred and read back once per flushed chunk, so the training
loop does not wait on the card every step; and a torch.profiler trace of a
window of steps, written as a Chrome trace."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricsLogger:
    """`write=False` (the ranks but 0 of a process group) keeps the records
    and returns them, for the NaN guard, but writes and prints nothing."""

    def __init__(self, directory: str, name: str = "train", stdout_every: int = 50,
                 write: bool = True):
        self.path = os.path.join(directory, f"{name}.jsonl")
        self._f = None
        if write:
            os.makedirs(directory, exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        self.stdout_every = stdout_every
        self._t0 = time.perf_counter()
        self._last_step_time = self._t0
        self._pending = []

    def defer(self, step: int, metrics: Dict[str, Any], prefix: str = "") -> None:
        """Queue a step's metrics without reading device values."""
        self._pending.append((step, time.perf_counter(), prefix, metrics))

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "") -> Optional[Dict[str, Any]]:
        """Write a record now (with any deferred ones before it)."""
        self.defer(step, metrics, prefix)
        return self.flush()

    def flush(self) -> Optional[Dict[str, Any]]:
        """Read every deferred value in one device-to-host copy, write the
        records, and return the last one (host floats)."""
        if not self._pending:
            return None
        tensors = [v.detach().float().reshape(()) for (_, _, _, m) in self._pending
                   for v in m.values() if torch.is_tensor(v)]
        read = iter(torch.stack(tensors).tolist() if tensors else [])
        host = [{k: next(read) if torch.is_tensor(v) else float(v) for k, v in m.items()}
                for (_, _, _, m) in self._pending]
        rec = None
        for (step, t, prefix, _), mv in zip(self._pending, host):
            rec = self._write(step, t, mv, prefix)
        self._pending.clear()
        return rec

    def _write(self, step: int, now: float, metrics, prefix: str) -> Dict[str, Any]:
        # step_time is the spacing of host timestamps: the dispatch cadence
        # for deferred records
        rec = {"step": int(step), "time": now - self._t0,
               "step_time": now - self._last_step_time}
        self._last_step_time = now
        for k, v in metrics.items():
            rec[prefix + k] = float(v)
        if self._f is None:
            return rec
        self._f.write(json.dumps(rec) + "\n")
        if self.stdout_every and step % self.stdout_every == 0:
            pretty = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in rec.items() if k != "time")
            print(f"[{prefix or 'train'}] {pretty}", flush=True)
        return rec

    def close(self):
        if self._f is not None:
            self._f.close()


class ProfilerHook:
    """A torch.profiler trace of the steps after `start_step` up to
    `start_step + num_steps`: `step(n)` after micro-step n starts the
    profile at n = start_step and stops it at n >= start_step + num_steps,
    then writes `<logdir>/trace_<start>_<stop>.json` (a Chrome trace, which
    chrome://tracing and Perfetto read) and keeps its path in `path`.  The
    profile records the host and, where a card is present, the card's
    kernels; `close()` stops and writes a profile the run ended inside."""

    def __init__(self, logdir: str, start_step: int = 10, num_steps: int = 3):
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.path: Optional[str] = None
        self._prof = None
        self._started = 0

    def step(self, step: int) -> None:
        if step == self.start_step and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._started = step
        elif step >= self.stop_step and self._prof is not None:
            self._stop(step)

    def _stop(self, step: int) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(self.logdir, f"trace_{self._started}_{step}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None

    def close(self, step: int) -> None:
        if self._prof is not None:
            self._stop(step)
