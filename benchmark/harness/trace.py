"""The traced run's profile and its reduction to per-layer numbers.

The profile records device activity alone: the device operations (kernels,
copies, fills) and the runtime calls that launched them, which share
CUPTI's correlation id.  The harness's spans (spans.py) are kept on the
host's clock, and the profile's clock is tied to it by ALIGN spin kernels
that close the profile, each launched between two readings of the host's
clock.  A device operation belongs to every span that was open when its
launch call ran.  PAD spin kernels open the profile: late in a process
CUPTI drops a profile's first records, and then it drops those in place of
the window's own.  Spin kernels are left out of every sum.  The traced
window runs from the profile's start to the end of the last service batch
that completed inside it."""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.spans import BATCH

PAD = 64
ALIGN = 8


def _profile():
    from torch._C._profiler import _ExperimentalConfig

    return profile(activities=[ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


class Profile:
    """start() before the traced batches, stop() after them, which returns
    the kineto events.  The profile runs from the service's worker thread
    and records the device activity of every thread."""

    def __init__(self):
        self._prof = None
        self.marks: List[Tuple[int, int]] = []

    def start(self) -> None:
        self._prof = _profile()
        self._prof.__enter__()
        for _ in range(PAD):
            torch.cuda._sleep(1)

    def stop(self):
        for _ in range(ALIGN):
            t0 = time.perf_counter_ns()
            torch.cuda._sleep(1)
            self.marks.append((t0, time.perf_counter_ns()))
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        return self._prof.profiler.kineto_results.events()


@dataclasses.dataclass
class Ranges:
    """The instances of one span name inside the traced batches: host start
    and end (ns, the profile's clock), and the device seconds and span of
    the operations launched inside each."""

    start: np.ndarray
    end: np.ndarray
    device_s: np.ndarray
    first_op: np.ndarray
    last_op: np.ndarray


@dataclasses.dataclass
class Reduction:
    window: Tuple[int, int]           # ns, the profile's clock
    batches: int
    busy_s: float
    ranges: Dict[str, Ranges]
    top_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    ops: int
    clock_error_ns: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def select(self, prefix: str) -> List[Ranges]:
        """The ranges whose name is `prefix` or starts with `prefix/`."""
        return [r for n, r in self.ranges.items() if n == prefix or n.startswith(prefix + "/")]


def _merge(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals as sorted disjoint (starts, ends)."""
    if not len(starts):
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def clock_offset(spin_launches: List[int], marks: List[Tuple[int, int]]) -> Tuple[int, int]:
    """(profile clock - host clock, its uncertainty) in ns.  The last spin
    kernels' launches are the closing marks; each launch ran between its two
    host readings, so each mark bounds the offset, and the offset lies where
    the bounds meet (else, as a clock that moved, by the tightest mark)."""
    m = min(ALIGN, len(spin_launches), len(marks))
    if not m:
        raise RuntimeError("the profile holds none of the closing spin kernels' launches")
    k = np.array(sorted(spin_launches)[-m:], dtype=np.int64)
    h = np.array(marks[-m:], dtype=np.int64)
    lo, hi = (k - h[:, 1]).max(), (k - h[:, 0]).min()
    if lo > hi:
        i = int(np.argmin(h[:, 1] - h[:, 0]))
        lo, hi = k[i] - h[i, 1], k[i] - h[i, 0]
    return int((lo + hi) // 2), int((hi - lo) // 2)


def reduce(events, spans, marks, opened_ns: int, stop_ns: int, top: int = 10,
           gaps: int = 5) -> Reduction:
    """events: the profile's; spans: (name, start, end) on the host's clock;
    marks: the host readings around each closing spin kernel's launch;
    opened_ns and stop_ns: the traced window's opening (once the profile has
    started) and the profile's stop, on the host's clock."""
    ops = []            # (start, end, corr, name)
    launch = {}         # corr -> launch call's start, the profile's clock
    spin = set()
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if "spin_kernel" in name:
                spin.add(e.correlation_id())
            elif not e.is_user_annotation():
                ops.append((e.start_ns(), e.end_ns(), e.correlation_id(), name))
        elif name.startswith("cu") and not e.is_user_annotation():
            launch[e.correlation_id()] = e.start_ns()
    offset, err = clock_offset([launch[c] for c in spin if c in launch], marks)
    by_name = collections.defaultdict(list)
    for name, s, e in spans:
        by_name[name].append((s + offset, e + offset))
    w0, stop = opened_ns + offset, stop_ns + offset
    batch_ends = sorted(e for s, e in by_name.get(BATCH, []) if s >= w0 and e <= stop)
    if not batch_ends:
        raise RuntimeError("no service batch completed inside the profile")
    w1 = batch_ends[-1]
    complete = np.array(sorted((s, e) for s, e in by_name[BATCH] if s >= w0 and e <= w1))
    o_start = np.array([o[0] for o in ops], dtype=np.int64)
    o_end = np.array([o[1] for o in ops], dtype=np.int64)
    o_launch = np.array([launch.get(o[2], -1) for o in ops], dtype=np.int64)
    o_dur = (o_end - o_start) / 1e9

    def inside_complete(t: np.ndarray) -> np.ndarray:
        i = np.searchsorted(complete[:, 0], t, side="right") - 1
        return (i >= 0) & (t <= complete[np.clip(i, 0, None), 1])

    ranges = {}
    for name, inst in by_name.items():
        inst = np.array(sorted(inst), dtype=np.int64)
        keep = inst[inside_complete(inst[:, 0]) & (inst[:, 1] <= w1)]
        n = len(keep)
        dev = np.zeros(n)
        first = np.full(n, np.iinfo(np.int64).max)
        last = np.zeros(n, dtype=np.int64)
        if n:
            i = np.searchsorted(keep[:, 0], o_launch, side="right") - 1
            hit = (i >= 0) & (o_launch >= 0) & (o_launch <= keep[np.clip(i, 0, None), 1])
            np.add.at(dev, i[hit], o_dur[hit])
            np.minimum.at(first, i[hit], o_start[hit])
            np.maximum.at(last, i[hit], o_end[hit])
        ranges[name] = Ranges(keep[:, 0], keep[:, 1], dev, first, last)

    # busy time and idle gaps inside the window
    cs, ce = np.clip(o_start, w0, w1), np.clip(o_end, w0, w1)
    live = ce > cs
    ms, me = _merge(cs[live], ce[live])
    busy = float((me - ms).sum()) / 1e9
    gap_s = np.concatenate([[w0], me])
    gap_e = np.concatenate([ms, [w1]])
    width = gap_e - gap_s
    named = []
    for k in np.argsort(-width)[:gaps]:
        if width[k] <= 0:
            break
        t = gap_s[k]
        open_at = [(s, n) for n, inst in by_name.items() for s, e in inst if s <= t < e]
        named.append((max(open_at)[1] if open_at else "between batches", float(width[k]) / 1e9))
    totals = collections.defaultdict(float)
    for (s, e, _, name), a, b in zip(ops, cs, ce):
        if b > a:
            totals[name[:120]] += (b - a) / 1e9
    top_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return Reduction((int(w0), int(w1)), len(complete), busy, ranges, top_ops, named,
                     int(live.sum()), err)
