"""What the host gave a window: the CPU seconds of the service's worker
thread (which enqueues every kernel, and spins while it waits on the card)
against the window's length, and the shortest, median and longest batch.
A host-bound cell's rate follows its batches; run.py prints this line on
standard error."""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional, Tuple

TICK = os.sysconf("SC_CLK_TCK")


def snapshot(worker_tid: Optional[int]) -> Tuple[float, float]:
    """(the host's clock, the worker thread's CPU seconds from /proc)."""
    try:
        fields = Path(f"/proc/self/task/{worker_tid}/stat").read_text().rsplit(")", 1)[1].split()
        cpu = (int(fields[11]) + int(fields[12])) / TICK
    except (OSError, IndexError, ValueError):
        cpu = 0.0
    return time.perf_counter(), cpu


def report(a: Tuple[float, float], b: Tuple[float, float], batches) -> str:
    """One line on the window between snapshots a and b; `batches` holds
    each batch's (start, end, samples) on the host's clock."""
    wall, cpu = b[0] - a[0], b[1] - a[1]
    secs = sorted(e - s for s, e, _ in batches)
    spread = (f"batches {len(secs)}: {secs[0]:.3f} s to {secs[-1]:.3f} s, median "
              f"{secs[len(secs) // 2]:.3f} s" if secs else "batches 0")
    return (f"host: window {wall:.3f} s; service worker on a CPU {cpu:.2f} s "
            f"({100 * cpu / max(wall, 1e-9):.1f}%); {spread}")
