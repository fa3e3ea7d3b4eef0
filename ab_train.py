"""Compare two checkouts of the port on celebahq stage-2 training, and on the
host time of the flash wrapper, with the two run in turns.

    python3 ab_train.py TREE_A TREE_B [--pairs 10] [--steps 20]

Each measurement is a process of its own, in the order A B, B A, A B, ...
(`--pairs` pairs), that imports the ddmi_tpu_torch of its checkout and runs
on one card.  A process
  - times the host enqueue of one `flash_attention` and one `mha_vmem` call
    at (2, 16, 2048, 16), the video UNet's commonest flash shape (the best
    of three loops of 200 calls, no synchronise inside);
  - builds the celebahq stage-2 pipeline at full width
    (configs/ldm/celebahq.yaml, seeded weights, zero-init layers perturbed as
    the checkout's chip_smoke.py does) and runs Trainer.train_stage2 over
    `--steps` micro-steps of batch-5 synthetic 256^2 images: its steady
    micro-steps/s is taken over micro-steps 2..steps, as chip_smoke.py takes
    it over 2..10;
  - times ten more micro-steps with no synchronise inside: the host's
    enqueue per micro-step, and the time until the card has finished them.
The parent prints every measurement, each checkout's median, Mann-Whitney's
U of the micro-step rates (the count of pairs in which A beat B, ties
half), and the card's name and power limit.  Trees are given as paths; build
outputs go to each checkout's own build/kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TAG = "AB_RESULT "


def _enqueue_us(torch, fn, calls: int = 200, loops: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(loops):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * best / calls


def measure(tree: str, steps: int) -> dict:
    """One checkout's numbers, in this process."""
    tree = os.path.abspath(tree)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    os.chdir(tree)
    import dataclasses

    import torch

    import chip_smoke
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.data.synthetic import SyntheticImages
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.ops import attention, flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = {"tree": tree}

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 16, 2048, 16), generator=g, device=dev).bfloat16()
               for _ in range(3))
    res["flash_enqueue_us"] = _enqueue_us(
        torch, lambda: flash_attention.flash_attention(q, k, v, 0.25))
    res["mha_vmem_enqueue_us"] = _enqueue_us(torch, lambda: attention.mha_vmem(q, k, v, 0.25))
    del q, k, v

    cfg = load_config("configs/ldm/celebahq.yaml")
    extra = {**cfg.data.extra, "nan_check_every": 5, "prefetch": 2}
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, extra=extra))
    pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed)
    chip_smoke.perturb_zero_init(pipe, 41)
    data = SyntheticImages(cfg.data.batch_size, 256, length=steps, seed=0)
    trainer = Trainer(cfg, pipe, data, save_dir=os.path.join(tree, "build", "ab_train"))
    stamps, step_fn = [], pipe.stage2_train_step

    def timed(*a, **kw):
        out = step_fn(*a, **kw)
        stamps.append(time.perf_counter())
        return out

    pipe.stage2_train_step = timed
    state = trainer.train_stage2(epochs=1)
    torch.cuda.synchronize()
    pipe.stage2_train_step = step_fn
    res["micro_steps_per_s"] = (len(stamps) - 1) / (stamps[-1] - stamps[0])

    x = torch.from_numpy(next(iter(data))).to(dev)
    gg = torch.Generator(device=dev).manual_seed(43)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, _ = pipe.stage2_train_step(state, x, generator=gg)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res["enqueue_ms_per_micro_step"] = 1e3 * (t1 - t0) / 10
    res["done_ms_per_micro_step"] = 1e3 * (t2 - t0) / 10
    return res


def _u(a, b) -> float:
    return sum(1.0 if x > y else 0.5 if x == y else 0.0 for x in a for y in b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(TAG + json.dumps(measure(args.one, args.steps)), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two checkouts, A and B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[ab] card: {smi}", flush=True)
    names = {"A": args.trees[0], "B": args.trees[1]}
    runs = {"A": [], "B": []}
    for i in range(args.pairs):
        for which in ("AB" if i % 2 == 0 else "BA"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", names[which],
                 "--steps", str(args.steps)],
                capture_output=True, text=True, timeout=600)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TAG)]
            if proc.returncode != 0 or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
                raise SystemExit(f"the measurement of {which} ({names[which]}) failed")
            r = json.loads(lines[-1][len(TAG):])
            runs[which].append(r)
            print(f"[ab] pair {i + 1} {which}: {r['micro_steps_per_s']:.4f} micro-steps/s; "
                  f"enqueue {r['enqueue_ms_per_micro_step']:.2f} ms/micro-step, done "
                  f"{r['done_ms_per_micro_step']:.2f}; flash enqueue "
                  f"{r['flash_enqueue_us']:.1f} us/call, mha_vmem {r['mha_vmem_enqueue_us']:.1f}",
                  flush=True)
    for key in ("micro_steps_per_s", "enqueue_ms_per_micro_step", "done_ms_per_micro_step",
                "flash_enqueue_us", "mha_vmem_enqueue_us"):
        a = [r[key] for r in runs["A"]]
        b = [r[key] for r in runs["B"]]
        print(f"[ab] {key}: A median {statistics.median(a):.4f} (min {min(a):.4f}, max "
              f"{max(a):.4f}); B median {statistics.median(b):.4f} (min {min(b):.4f}, max "
              f"{max(b):.4f}); U(A > B) {_u(a, b):g} of {len(a) * len(b)}", flush=True)
    print(json.dumps({"A": names["A"], "B": names["B"], "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
