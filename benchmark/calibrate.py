#!/usr/bin/env python3
"""Readings that the output check's limit is set from, in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds <n> [<n> ...]
        [--control <n> [<n> ...]] [--seconds <s>]

For each seed: the cell's service on that seed's weights, one short window
of its traffic, then the check's number (pixel_mae, harness/check.py) of
the program against the float32 reference: the lower reading is the
largest over the seeds.  For each control seed: the same requests worked
out by the reference computed in fp8 (reference/numerics.py), in the
program's place, against the float32 reference: the upper reading is the
smallest over them.  Prints one JSON line per seed and, for the control,
the share of pixels at 0 or 255 and the pixel spread of the reference."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def reading(cell, seed: int, control: bool, seconds: float, device: str) -> dict:
    """One seed's readings: the program's pixel MAE per checked request and,
    with `control`, the fp8 reference's, against the float32 reference."""
    import numpy as np
    import torch

    from benchmark.harness import check
    from benchmark.harness.session import Session
    from benchmark.reference.numerics import Numerics, fp32_mode

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True     # the program runs under the defaults
    sess = Session(cell, seed, device)
    sess.warmup()
    window = sess.serve(seconds)
    sess.close()
    done = [r for r in window.records if r.error is None]
    chosen = check.choose(done, int(sess.conf["check"]["requests"]), seed, sess.placed)
    fp32_mode()
    models = check.reference_models(sess.domain, sess.conf, sess.specs, seed, device)
    maes, ref = check.readings(sess.domain, sess.conf, models, chosen, sess.placed,
                               Numerics(), device)
    line = {"seed": seed, "requests": len(chosen), "failed": len(window.records) - len(done),
            "program": maes}
    if control:
        reqs = [check.Request(r.seed, *sess.placed[r.seed]) for r in chosen]
        with torch.no_grad():
            low = sess.domain.reference(models, sess.conf, reqs, Numerics("fp8"), device)
        line["control"] = [float(np.abs(a.astype(np.float32) - b.astype(np.float32)).mean()
                                 / 255.0) for a, b in zip(low, ref)]
        line["ref_std"] = [float(x.astype(np.float32).std() / 255.0) for x in ref]
        line["ref_saturated"] = [float(((x == 0) | (x == 255)).mean()) for x in ref]
    del models
    if device == "cuda":
        torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t0
    return line


def main(argv=None, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    from benchmark.harness import cell as cells

    cell = cells.load(args.workload, ROOT)
    if device == "cuda":
        from ddmi_tpu_torch.ops import build
        build.build_all(build.LIBRARIES)
    for seed in args.seeds:
        print(json.dumps(reading(cell, seed, seed in args.control, args.seconds, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
