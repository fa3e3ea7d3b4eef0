#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell comes from BENCHMARK.json at the root of the checkout.  A run
builds or loads the port's CUDA kernels (cached under build/ in the
checkout), makes the weights on the card from the seed, builds the port's
SamplerService on them, warms it up with one batch of the cell's shapes,
then drives it with the cell's traffic for `--seconds`, and checks a sample
of the served outputs against the plain reference (benchmark/reference/).
The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 also breakdown, and last the
numbers the check compared, each with its limit; the same numbers are the
last lines of standard error.  --trace 0 reports the cell's end-to-end
metrics; --trace 1 reports its per-layer metrics: the window's first batch
runs before any profiler starts, the next `trace_batches` batches are
profiled, and the host's times are read outside the profile.  Without a CUDA device, or with fewer
than the cell asks for, it prints no result and exits 2."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

T_TOP = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"
# every cache the run writes lies at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_TOP = process_age()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, device: str = "cuda") -> int:
    args = parse(argv)
    from benchmark.harness import cell as cells
    from benchmark.harness import guard

    cell = cells.load(args.workload, ROOT)
    readers = cells.readers(cell, bool(args.trace))

    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        err(f"no result: {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cuda = device == "cuda"

    from benchmark.harness import check, host
    from benchmark.harness.session import Session
    from benchmark.reference.numerics import Numerics, fp32_mode

    if cuda:
        from ddmi_tpu_torch.ops import build
        build.build_all(build.LIBRARIES)
    sess = Session(cell, args.seed, device, traced=bool(args.trace))
    sess.warmup()
    if cuda:
        torch.cuda.synchronize()
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    before = host.snapshot(sess.worker_tid)
    window = sess.serve(args.seconds)
    setup_s = AGE_AT_TOP + (window.opened - T_TOP)
    err(host.report(before, host.snapshot(sess.worker_tid), sess.batch_log))
    if cuda:
        torch.cuda.synchronize()
        peak_window = torch.cuda.max_memory_allocated()
    else:
        peak_setup = peak_window = 0
    done = [r for r in window.records if r.error is None]
    failed = len(window.records) - len(done)
    for r in window.records:
        if r.error is not None:
            err(f"request {r.seed} failed: {r.error!r}")
    reduction = sess.reduce()
    work = sess.domain.sample_work(sess.conf, sess.meta)
    # what the metric readers read
    run = SimpleNamespace(window=window, done=done,
                          samples=sum(r.result.shape[0] for r in done), setup_s=setup_s,
                          trace=reduction, work=work, batch=sess.batch,
                          peak_window_bytes=peak_window, session=sess)
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the output check, once the program is freed
    sess.close()
    fp32_mode()
    numbers = check.run(sess.domain, sess.conf, sess.specs, args.seed, device, done,
                        sess.placed, Numerics(), log=err)

    correct = failed == 0 and all(v["value"] <= v["limit"] for v in numbers.values())
    limit_w = power_limit() if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(max(peak_setup, peak_window))}
    result = {"correct": bool(correct), "attempted": len(window.records), "failed": failed,
              "metrics": metrics, "device": dev, "card": limit_w}
    if reduction is not None:
        dev["busy_s"], dev["window_s"] = reduction.busy_s, reduction.window_s
        result["breakdown"] = {"device_ops": [list(o) for o in reduction.top_ops],
                               "idle_gaps": [list(g) for g in reduction.idle_gaps]}
        err(f"trace: {reduction.batches} batches, {reduction.ops} device operations in "
            f"{reduction.window_s:.3f} s; host and profile clocks tied to within "
            f"{reduction.clock_error_ns / 1e3:.1f} us")
    result["check"] = numbers
    loaded = guard.forbidden_loaded()
    if loaded:
        err(f"no result: the run loaded {', '.join(loaded)}")
        return 3
    err(f"card: {limit_w}")
    for name, v in numbers.items():
        err(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
