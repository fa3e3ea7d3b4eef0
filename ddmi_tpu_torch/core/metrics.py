"""Metrics logging (counterpart of ddmi_tpu/core/metrics.py::MetricsLogger):
a JSONL stream and stdout lines.  Device values are deferred and read back
once per flushed chunk, so the training loop does not wait on the card
every step."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricsLogger:
    def __init__(self, directory: str, name: str = "train", stdout_every: int = 50):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{name}.jsonl")
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
        self._f.write(json.dumps(rec) + "\n")
        if self.stdout_every and step % self.stdout_every == 0:
            pretty = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in rec.items() if k != "time")
            print(f"[{prefix or 'train'}] {pretty}", flush=True)
        return rec

    def close(self):
        self._f.close()
