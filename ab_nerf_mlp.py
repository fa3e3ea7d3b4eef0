#!/usr/bin/env python3
"""The NeRF MLP kernel of this checkout against that of another, on one GPU.

    python3 ab_nerf_mlp.py OTHER_CHECKOUT [--reps 20]

Builds `OTHER_CHECKOUT/ddmi_tpu_torch/csrc/nerf_mlp.cu` with this
checkout's nvcc flags into `build/ab/`, folds one seeded MLP at srn_cars'
widths (W 256, D 6, skips 2 and 4, in_xyz 159, in_dir 27) and times both
libraries on the same bf16 inputs (4096 rays x 256 samples) with CUDA
events, in the order other, this, this, other, each `--reps` launches, so
that a drift of the card's clock over the run falls on both alike.  Both
outputs are held against the plain version.  Prints one JSON line with the
medians, every round's ms a launch, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def build_other(src: str) -> ctypes.CDLL:
    from ddmi_tpu_torch.ops import build

    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.dirname(src)
    h = hashlib.sha256(open(src, "rb").read())
    for name in sorted(os.listdir(csrc)):
        if name.endswith(".cuh"):
            h.update(open(os.path.join(csrc, name), "rb").read())
    lib = os.path.join(out_dir, f"libnerf_mlp_other_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src], check=True,
                       capture_output=True, text=True)
    return ctypes.CDLL(lib)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_nerf_mlp: needs a CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    from ddmi_tpu_torch.nn.inr import INRNeRF
    from ddmi_tpu_torch.ops import nerf_mlp

    dev = torch.device("cuda", 0)
    other = build_other(os.path.join(os.path.abspath(args.other), "ddmi_tpu_torch", "csrc",
                                     "nerf_mlp.cu"))
    other.ddmi_nerf_mlp.argtypes = nerf_mlp._lib().ddmi_nerf_mlp.argtypes
    other.ddmi_nerf_mlp.restype = ctypes.c_int
    torch.manual_seed(0)
    m = INRNeRF(6, 256, 159, 27, (2, 4)).to(dev)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn_like(p))
    f = nerf_mlp.fold_nerf_params(m)
    N = 4096 * 256
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((N, 186), generator=g, device=dev).bfloat16()
    out_other = torch.empty((N, 4), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run_other():
        err = other.ddmi_nerf_mlp(x.data_ptr(), *(t.data_ptr() for t in f.tensors()),
                                  out_other.data_ptr(), N, 159, 27, f.wx.shape[1],
                                  f.w_dird.shape[0], 6, (1 << 2) | (1 << 4), stream)
        assert err == 0, err
        return out_other

    def run_this():
        return nerf_mlp.nerf_mlp_fused(f, x)

    def timed(fn):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    with torch.no_grad():
        ref = nerf_mlp.nerf_mlp_plain(f, x)
        errs = {}
        for tag, fn in (("other", run_other), ("this", run_this)):
            out = fn().clone()
            torch.cuda.synchronize()
            errs[tag] = float((out - ref).abs().max())
            assert (out[:, :3] - ref[:, :3]).abs().max().item() <= 0.005, tag
            assert torch.isfinite(out).all(), tag
        rounds = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other", "other", "this", "this", "other"):
            rounds[tag].append(timed(run_other if tag == "other" else run_this))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "nvidia_smi": smi, "shape": [N, 159, 27], "reps": args.reps,
        "other_ms": statistics.median(rounds["other"]),
        "this_ms": statistics.median(rounds["this"]),
        "rounds": rounds, "max_abs_err_vs_plain": errs,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
