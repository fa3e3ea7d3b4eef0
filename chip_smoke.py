#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ddmi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:
  1. device: name, count, `nvidia-smi` name and power limit; no CUDA device
     means exit 3 (there is no CPU fallback);
  2. build: the four CUDA libraries from ddmi_tpu_torch/csrc with nvcc
     (sm_90a), one nvcc each, all at once, and for every kernel (the flash
     core's instances, which mha_vmem also runs, the attn_block GEMMs and
     GroupNorm, nerf_mlp, both inr_decode kernels) its registers, spills
     and dynamic shared memory from the ptxas report;
  3. image kernels: attn_block and inr_decode against their plain PyTorch
     versions at celebahq's shapes, timed against them with CUDA events;
     attn_block through the entry the UNet calls, on bf16 parameters in the
     module's layout, with a bit-identical repeat, one launch per call, its
     device time from the profiler, its enqueue time and, as a yardstick
     that is not one call, the same block as a chain of library calls
     (GroupNorm, cuBLAS GEMMs, SDPA); inr_decode also with its device time
     from the profiler, TFLOP/s and share of the bf16 peak, and with noise
     against the plain version fed the kernel's own Philox draws;
  4. image slice: the image SamplerService on configs/ldm/celebahq.yaml at
     full width (seeded weights, zero-init layers perturbed, bf16, batch 8,
     256^2, NFE 100) answers concurrent requests that coalesce into one
     batch plus a repeat of a seed; the launch counters show the batches
     went through both kernels;
  5. image breakdown and reference: one UNet forward, the decode and the
     render timed, a profile of the forward with the attention blocks' share
     of its device time; the slice at a small config,
     bf16 with the kernels on the GPU against fp32 plain versions on the CPU;
  6. video slice: the video SamplerService on configs/ldm/skytimelapse.yaml
     with the stage-1 decoder and INR of configs/d2c-vae/skytimelapse.yaml
     at full width (bf16, batch 2, 16 x 256^2, NFE 200): two concurrent
     requests coalesce into one batch, a repeat of a seed is bit-identical,
     and the launch counters of attn_block, mha_vmem and flash_attention
     match the per-batch counts exactly;
  7. video breakdown: one TriplaneUNet forward, the decode and the render
     timed, a profile of the forward, and the shapes each attention kernel
     is called at;
  8. video kernels: attn_block, mha_vmem and flash_attention against their
     plain versions at every one of those shapes, each also timed against
     torch's scaled_dot_product_attention where one call computes the same;
     each mha_vmem line also gives its device time from the profiler and
     the wrapper's enqueue time; each flash line the exp-unit floor beside
     the tensor bound, TFLOP/s and the wrapper's enqueue time;
  9. video reference: a small video config, bf16 with the kernels on the GPU
     against fp32 plain versions on the CPU, that goes through all three
     attention kernels;
 10. nerf kernel: nerf_mlp against its plain version at the render's shape
     (4096 rays x 256 samples) and at a ragged N, with a bit-identical
     repeat and one launch per call, timed against the plain version and
     against the bf16 INRNeRF module (a chain of cuBLAS GEMMs);
     attn_block at the two srn_cars UNet shapes;
 11. nerf slice: the NeRF SamplerService on configs/ldm/srn_cars.yaml at
     full width (bf16, batch 2, 8 views at 128^2, 256 samples per ray, NFE
     200): two concurrent requests coalesce, a repeat of a seed is
     bit-identical, and the counters read exactly attn_block 2200 (11 blocks
     per forward, counted from the module tree) and nerf_mlp 64 per batch;
 12. nerf breakdown: one UNet forward, one scene's decode and one view's
     render (split into the triplane gather with the embeddings, the MLP
     kernel and the compositing) timed, with profiles of the render and the
     forward;
 13. nerf reference: a small config with a width-256 MLP, bf16 with the
     kernels on the GPU against fp32 plain versions on the CPU;
 14. train kernels: the flash backward (dk/dv and dq kernels) against its
     plain version at the celebahq training shape (5, 16, 1024, 32), at
     (2, 4, 2048, 16) and at a ragged (1, 2, 1000, 64), timed against the
     plain version and the backward of torch's scaled_dot_product_attention;
     the forward's row log-sum-exp against torch.logsumexp; the exp floor
     and TFLOP/s beside each, as in phase 8;
 15. train slice: Trainer.train_stage2 on configs/ldm/celebahq.yaml at full
     width (fp32 master parameters, bf16 compute, batch 5 of 256^2
     synthetic images, accumulation over 5, 10 micro-steps): the counters
     read exactly flash forward 50 and backward 50 (and 0 for the
     inference kernels), every loss is finite, the parameters change at
     micro-steps 5 and 10 only; micro-steps/s, one micro-step split into
     encode / forward / backward / optimizer+EMA, a profile, peak memory;
 16. train reference: one micro-step at a small config, bf16 with the
     kernels on the GPU against fp32 plain versions on the CPU (loss and
     gradient cosine);
 17. occupancy slice: attn_block at the shapenet UNet's two shapes at batch
     8; the occupancy SamplerService on configs/ldm/shapenet.yaml with the
     stage-1 blocks of configs/d2c-vae/shapenet.yaml at full width (bf16,
     batch 8, NFE 200, MISE 64 -> 256^3 at threshold 0.2, 100,000 points per
     mesh per round; the random field's offset set so that 5% of the box is
     inside): two concurrent requests coalesce into one batch, a repeat of a
     seed gives bit-identical meshes, the counters read exactly attn_block
     2200 per batch and 0 for every other kernel, every vertex is finite and
     inside the box; meshes/s, batch time, vertex and face counts, peak
     memory;
 18. occupancy breakdown: one UNet forward (events, device time, host
     enqueue), the batch's decode and its peak memory, the lockstep
     extraction split into MISE rounds, points, INR3D device time, octree
     host time and marching cubes; a profile of one full evaluation round;
 19. occupancy reference and encode path: a small config at NFE 4, bf16 with
     the kernels on the GPU against fp32 plain versions on the CPU (logits on
     a 32^3 grid, inside/outside agreement, meshes' Chamfer-L1); a
     3000-point sphere cloud through the full-width pointnet, triplane
     encoder and posterior (bf16 latents against fp32 on the CPU), the
     full-width decode and INR3D on those latents against the CPU (logits,
     agreement), then extraction;
 20. stage-1 slice: Trainer.train_stage1 on configs/d2c-vae/celebahq.yaml at
     full width (batch 10 of 512^2 synthetic images, 256^2 multiscale
     targets, fp32 masters with bf16 compute, accumulation over 5, LPIPS on
     a random VGG16, the SN regulariser; 10 micro-steps): every loss term
     finite, the VAE's and INR's parameters bit-unchanged through
     micro-step 9 and all changed at 10 (the first update's rate is 0), the
     SN state changed at every micro-step, no launch of the six kernels;
     the eval hook after the epoch's checkpoint logs PSNR, saves its images
     and launches inr_decode once; micro-steps/s, samples/s, peak memory,
     a micro-step split (multiscale, encode, decode, INR, LPIPS, SN,
     backward, optimizer), host against device time and a profile;
 21. stage-1 checkpoint: the state saved as the trainer saves it restores
     bit for bit into a scrambled state, and a resumed trainer goes on 2
     micro-steps with finite losses;
 22. reconstruction: ImagePipeline.reconstruct of 4 of the 512^2 images at
     256^2 and at 512^2, one inr_decode launch per call, pixels finite in
     [0, 1], PSNR logged; inr_decode against its plain version at both
     token counts;
 23. adversarial stage 1 (configs/d2c-vae/celebahq_gan.yaml, 5
     micro-steps): the discriminator changes at every micro-step, the VAE
     and INR at none, finite losses, the extra time per micro-step;
 24. the stage-1 -> stage-2 hand-off: configs/ldm/celebahq.yaml's
     train_stage2 takes the VAE and INR from the stage-1 checkpoint, runs 2
     micro-steps and saves, and a new trainer resumes for 1 more;
 25. stage-1 reference: one loss and its gradients at a small config, bf16
     on the GPU against fp32 on the CPU (loss within 2%, each term within
     5%, gradient cosine >= 0.999).

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Nothing in this run imports JAX or the JAX
package.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
NFE = 100
BATCH = 8
RESOLUTION = 256
VIDEO_BATCH = 2
VIDEO_NFE = 200
NERF_BATCH = 2
NERF_NFE = 200
NERF_VIEWS = 8
NERF_RES = 128
# H100 SXM peaks (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM rate
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# the exp unit: 16 ex2 per clock per SM, 132 SMs at the 1,980 MHz boost clock
EXP_RATE = 16 * 132 * 1.98e9
# attn_block against its fp32 plain version (the JAX bf16 bar)
ATTN_MAX_ERR, ATTN_MIN_CORR = 0.031, 0.99999
# mha_vmem / flash_attention against their fp32 plain versions: bf16
# rounding of q * scale (mha_vmem), of the probabilities and of the output
MHA_REL_ERR, MHA_MIN_CORR = 0.02, 0.9999
# inr_decode: bf16 activations between 13 matmuls
INR_REL_MEAN_ERR = 0.02
# nerf_mlp against its plain version on the same bf16 operands: fp32 sums in
# another order may flip a bf16 rounding of h (the JAX kernel's bar)
NERF_RGB_ERR, NERF_SIGMA_REL_ERR = 0.005, 0.01
# references: bf16 + kernels vs fp32 plain, 4 DDIM steps, pixels in [0, 1]
REF_MEAN_ERR, REF_MAX_ERR = 0.02, 0.25
# the NeRF reference's random-weight scene is nearly uniform (pixel std about
# 0.02), so its bars are tighter, and its std must be several times the mean
# bar: a flat image at the mean colour then fails
NERF_REF_MEAN_ERR, NERF_REF_MAX_ERR, NERF_REF_MIN_STD = 0.002, 0.02, 0.01
# celebahq attention blocks per UNet forward by (H, C, heads): 5 at 32x32,
# 5 at 16x16, 6 at 8x8
ATTN_SHAPES = [((32, 512, 16), 5), ((16, 1024, 32), 5), ((8, 2048, 64), 6)]
# skytimelapse per batch (from ddmi_tpu_torch/nn/unet_triplane.py and
# nn/video_vae.py, confirmed by the launch counters): 32 fused blocks, 18
# mha_vmem and 6 flash attentions per UNet forward, 2 flash in the decode
VIDEO_LAUNCHES = {"attn_block": 32 * VIDEO_NFE, "mha_vmem": 18 * VIDEO_NFE,
                  "flash_attention": 6 * VIDEO_NFE + 2}
# srn_cars UNet attention blocks per forward by (H, C, heads): 5 at 8x8 (ds 2),
# 6 at 4x4 (ds 4); per batch 11 per forward and one MLP launch per 4096-ray
# chunk: 2 scenes x 8 views x 4 chunks
NERF_ATTN_SHAPES = [((8, 512, 16), 5), ((4, 1024, 32), 6)]
NERF_LAUNCHES = {"attn_block": 11 * NERF_NFE,
                 "nerf_mlp": NERF_BATCH * NERF_VIEWS * (NERF_RES * NERF_RES // 4096)}
# shapenet occupancy (configs/ldm/shapenet.yaml, bench_3d.py's protocol):
# batch 8, NFE 200, MISE 64 -> 256^3, 100,000 points per mesh per round; the
# UNet has srn_cars' attention shapes at batch 8 (11 blocks per forward)
OCC_BATCH = 8
OCC_NFE = 200
OCC_POINTS = 100_000
OCC_ATTN_SHAPES = NERF_ATTN_SHAPES
OCC_LAUNCHES = {"attn_block": 11 * OCC_NFE}
# the occupancy reference: bf16 + kernels vs fp32 plain at NFE 4 on a 32^3
# grid: logits mean|err| / mean|ref|, inside/outside agreement, and the
# meshes' Chamfer-L1 as a share of the box (1.1)
OCC_REF_REL_ERR, OCC_REF_AGREE, OCC_REF_CHAMFER = 0.02, 0.99, 0.01
# the share of the box a random-weight field is set to put inside the surface
OCC_INSIDE = 0.05
# stage-2 training on configs/ldm/celebahq.yaml: batch 5 of 256^2 images,
# gradient accumulation over 5 micro-steps, 10 micro-steps (2 optimizer
# updates); 5 flash attentions per UNet forward (the 32 x 32 blocks: C 512,
# 16 heads of 32), each differentiated once
TRAIN_STEPS = 10
TRAIN_SHAPE = (5, 16, 1024, 32)
TRAIN_LAUNCHES = {"flash_attention": 5 * TRAIN_STEPS, "flash_attention_bwd": 5 * TRAIN_STEPS}
# the flash backward against its fp32 plain version on the same bf16 operands:
# bf16 rounding of p and ds before their products and of the outputs
FLASH_BWD_REL_ERR, FLASH_BWD_MIN_CORR = 0.03, 0.999
# the forward's row log-sum-exp against torch.logsumexp of the fp32 scores
LSE_MAX_ERR = 1e-4
# one micro-step at a small config, bf16 + kernels on the GPU against fp32
# plain versions on the CPU: the loss, and the cosine of all gradients
TRAIN_REF_LOSS_REL, TRAIN_REF_MIN_COS = 0.02, 0.999
# stage-1 training on configs/d2c-vae/celebahq.yaml: batch 10 of 512^2
# synthetic images (the multiscale targets need twice the 256^2 anchor),
# accumulation over 5, 10 micro-steps; the adversarial config 5
S1_BATCH, S1_RES, S1_STEPS, S1_GAN_STEPS = 10, 512, 10, 5
# one stage-1 micro-step at a small config, bf16 on the GPU against fp32 on
# the CPU: the loss, each term (recon, KL, LPIPS, SN), the gradient cosine
S1_REF_LOSS_REL, S1_REF_TERM_REL, S1_REF_MIN_COS = 0.02, 0.05, 0.999
# the kernels of one attention block call (csrc/attn_block.cu), by profiler name
ATTN_BLOCK_KERNELS = ("::group_norm_kernel", "::gemm_kernel<", "flash_fwd_kernel")
KERNELS = {
    "attn_block": ("ddmi_tpu_torch/csrc/attn_block.cu", "ddmi_tpu/ops/pallas/attn_block.py:199"),
    "inr_decode": ("ddmi_tpu_torch/csrc/inr_decode.cu", "ddmi_tpu/ops/pallas/inr_decode.py:307"),
    "mha_vmem": ("ddmi_tpu_torch/csrc/flash.cu", "ddmi_tpu/ops/pallas/attention.py:100"),
    "flash_attention": ("ddmi_tpu_torch/csrc/flash.cu", "ddmi_tpu/nn/attention1d.py:77"),
    "nerf_mlp": ("ddmi_tpu_torch/csrc/nerf_mlp.cu", "ddmi_tpu/ops/pallas/nerf_mlp.py:213"),
    "flash_attention_bwd": ("ddmi_tpu_torch/csrc/flash.cu",
                            "jax/experimental/pallas/ops/tpu/flash_attention.py:1121,1456"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 0) -> float:
    """Mean device time of fn() over `reps` calls (0: enough calls for
    about 0.3 s), after two warm-up calls."""
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not reps:
        start.record()
        fn()
        end.record()
        end.synchronize()
        reps = int(min(50, max(2, 300.0 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel, plain, reps: int = 0):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def enqueue_us(torch, fn, calls: int = 50) -> float:
    """Host time to enqueue one fn() (no synchronise inside the loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def flash_yardsticks(torch, kms, flops, exps, kernel=None) -> str:
    """The text a flash line adds: the exp-unit floor beside the tensor
    bound, TFLOP/s and the wrapper's enqueue time (for calls under 1 ms)."""
    text = f"; exp floor {1e3 * exps / EXP_RATE:.4f} ms; {flops / kms / 1e9:.1f} TFLOP/s"
    if kernel is not None and kms < 1.0:
        text += f"; wrapper enqueue {enqueue_us(torch, kernel):.1f} us/call"
    return text


def bound(flops: float, nbytes: float):
    """(ms, what bounds it): the least time the card could take for work of
    `flops` bf16 operations moving `nbytes` bytes."""
    t_op, t_mem = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_op, t_mem), ("operations" if t_op >= t_mem else "bytes")


class Ledger:
    """Per kernel, the time of one service batch's calls on each path: the
    sum over the shapes the path calls it at of (calls per batch x time per
    call), for the kernel, its plain version, the library call and the
    bound."""

    def __init__(self):
        self.rows = collections.defaultdict(lambda: {
            "ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0,
            "t_op": 0.0, "t_mem": 0.0, "max_abs_err": 0.0, "by_path": {}})

    def add(self, name, path, calls, kms, pms, lms, flops, nbytes, err):
        r = self.rows[name]
        bms, _ = bound(flops, nbytes)
        for key, val in (("ms", kms), ("plain_ms", pms), ("bound_ms", bms)):
            r[key] += calls * val
        if lms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + calls * lms
        r["t_op"] += calls * flops / PEAK_FLOPS
        r["t_mem"] += calls * nbytes / PEAK_BYTES
        r["max_abs_err"] = max(r["max_abs_err"], err)
        p = r["by_path"].setdefault(path, {"calls_per_batch": 0, "ms": 0.0, "plain_ms": 0.0,
                                           "bound_ms": 0.0, "library_ms": None})
        p["calls_per_batch"] += calls
        p["ms"] += calls * kms
        p["plain_ms"] += calls * pms
        p["bound_ms"] += calls * bms
        if lms is not None:
            p["library_ms"] = (p["library_ms"] or 0.0) + calls * lms

    def add_extra(self, name, path, calls, **times):
        """Further per-call times (ms) beside `ms`, summed over the calls
        like it, into the kernel's row and its path's: attn_block's device
        time from the profiler and its library chain's."""
        r = self.rows[name]
        for key, val in times.items():
            for d in (r.setdefault("extra", {}), r["by_path"][path]):
                d[key] = d.get(key, 0.0) + calls * val

    def entry(self, name, launches):
        r = self.rows[name]
        src, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": "operations" if r["t_op"] >= r["t_mem"] else "bytes",
                "library_ms": r["library_ms"], **r.get("extra", {}),
                "per": "service batch of each sampling path; the train path's 10 micro-steps; "
                       "one call of each reconstruction",
                "by_path": r["by_path"]}


LEDGER = Ledger()


def perturb_zero_init(module, seed: int, noise: bool = True) -> None:
    """Seeded random values for every all-zero parameter (output convs,
    proj_out, biases and, if `noise`, NoiseInjection gains) and a mixing
    logit of 0, so that no branch of the slice is silently skipped."""
    import torch

    dev = next(module.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name == "mixing_logit":
                p.zero_()
            elif not bool(p.any()) and (noise or ".noise." not in name):
                std = 0.1 / p[0].numel() ** 0.5 if p.ndim > 1 else 0.02
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * std)


def reset_launches():
    from ddmi_tpu_torch.ops import attention, attn_block, flash_attention, inr_decode, nerf_mlp

    fns = {"attn_block": attn_block.fused_attention_block,
           "inr_decode": inr_decode.inr_decode_fused,
           "mha_vmem": attention.mha_vmem,
           "flash_attention": flash_attention.flash_attention,
           "nerf_mlp": nerf_mlp.nerf_mlp_fused,
           "flash_attention_bwd": flash_attention.flash_attention_bwd}
    for fn in fns.values():
        fn.launches = 0
    return lambda: {k: fn.launches for k, fn in fns.items()}


def device_ms(torch, fn, reps: int = 20, attempts: int = 3) -> float:
    """Device time of one fn() from the profiler: the sum of the kernels'
    device time over `reps` calls (after a warm-up), per call.  Unlike CUDA
    events around a small call it leaves out the host's enqueue.  A profile
    that records no kernel at all (CUPTI now and then delivers an empty
    one, seen once in a run of unchanged code) is taken again, up to
    `attempts` times in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages())
        if total:
            return total / 1000 / reps
        log(f"[profiler] profile {attempt + 1} of {attempts} recorded no device time")
    raise AssertionError("the profiler saw no device time")


def attn_block_chain(torch, x, nw, nb, wq, bq, wp, bp, nh, s, eps=1e-5):
    """The block as a chain of library calls, a yardstick and not one call:
    torch's GroupNorm, the qkv product (cuBLAS), SDPA, the proj product with
    bias and residual (cuBLAS); weights in the module's layout."""
    import torch.nn.functional as F

    B, H, W, C = x.shape
    n, hd = H * W, C // nh
    h = F.group_norm(x.permute(0, 3, 1, 2), 32, nw, nb, eps).permute(0, 2, 3, 1)
    qkv = F.linear(h.reshape(B * n, C), wq[:, :, 0], bq).view(B, n, nh, 3, hd)
    qkv = qkv.permute(3, 0, 2, 1, 4)
    o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=s)
    o = o.transpose(1, 2).reshape(B * n, C)
    return torch.addmm(x.reshape(B * n, C) + bp, o, wp[:, :, 0].t()).view(B, H, W, C)


def attn_block_case(torch, dev, path, calls, B, H, W, C, nh, seed):
    """attn_block at one shape, on bf16 parameters in the UNet module's
    layout through the entry the UNet calls, against its fp32 plain version
    (on the same values in the JAX layout); a repeat is bit-identical and
    each call counts one launch.  Adds to LEDGER the CUDA-events time as
    `ms` (as every kernel's), and beside it the device time from the
    profiler and that of the same block as a chain of library calls."""
    from ddmi_tpu_torch.ops import attn_block

    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    bf = torch.bfloat16
    x = rnd(B, H, W, C).to(bf)
    nw, nb = (1 + 0.1 * rnd(C)).to(bf), (0.1 * rnd(C)).to(bf)
    wq, bq = (rnd(3 * C, C, 1) / C**0.5).to(bf), (0.1 * rnd(3 * C)).to(bf)
    wp, bp = (rnd(C, C, 1) / C**0.5).to(bf), (0.1 * rnd(C)).to(bf)
    s = (C // nh) ** -0.5
    jq, jb, jp = attn_block.module_to_jax_layout(wq.float(), bq.float(), wp.float(), nh)
    kern = lambda: attn_block.attention_block(x, nw, nb, wq, bq, wp, bp, nh, s)
    plain = lambda: attn_block.attention_block_plain(
        x.float(), nw.float(), nb.float(), jq, jb, jp, bp.float(), nh, s)
    chain = lambda: attn_block_chain(torch, x, nw, nb, wq, bq, wp, bp, nh, s)
    before = attn_block.fused_attention_block.launches
    out, again = kern(), kern()
    launched = attn_block.fused_attention_block.launches - before
    ref = plain()
    torch.cuda.synchronize()
    out = out.float()
    err = (out - ref).abs().max().item()
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1].item()
    same = torch.equal(out, again.float())
    kev, pms = paired_ms(kern, plain)
    kms, cms = device_ms(torch, kern), device_ms(torch, chain)
    enq = enqueue_us(torch, kern)
    n = H * W
    flops = 8 * B * n * C * C + 4 * B * n * n * C
    nbytes = 2 * x.numel() * 2 + (4 * C * C) * 2 + (4 * C + 2 * C) * 2
    bms, by = bound(flops, nbytes)
    log(f"[kernel] attn_block {path} B={B} n={n} C={C} heads={nh} hd={C // nh} (x{calls}/batch): "
        f"max|err| {err:.6f} corr {corr:.8f}, repeat identical {same}, launches {launched}/2; "
        f"device {kms:.4f} ms ({flops / kms / 1e9:.1f} TFLOP/s), events {kev:.4f} ms, enqueue "
        f"{enq:.1f} us; plain fp32 {pms:.4f} ms; library chain (GroupNorm + cuBLAS + SDPA + "
        f"cuBLAS, not one call) device {cms:.4f} ms; library none (no single PyTorch call); "
        f"bound {bms:.4f} ms ({by})")
    if not (err <= ATTN_MAX_ERR and corr >= ATTN_MIN_CORR and same and launched == 2):
        raise AssertionError(f"attn_block fails at n={n}, C={C}, heads={nh}: err {err}, corr "
                             f"{corr}, repeat identical {same}, launches {launched}")
    LEDGER.add("attn_block", path, calls, kev, pms, None, flops, nbytes, err)
    LEDGER.add_extra("attn_block", path, calls, device_ms=kms, library_chain_device_ms=cms)


def attention_case(torch, dev, name, calls, B, nh, n, hd, seed, path="video"):
    """mha_vmem or flash_attention at one (B, nh, n, hd) against its plain
    version and torch's scaled_dot_product_attention; adds to LEDGER."""
    import torch.nn.functional as F

    from ddmi_tpu_torch.ops import attention, flash_attention

    kernel, plain_fn = {
        "mha_vmem": (attention.mha_vmem, attention.mha_plain),
        "flash_attention": (flash_attention.flash_attention, flash_attention.flash_plain),
    }[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, nh, n, hd), generator=g, device=dev).bfloat16() for _ in range(3))
    s = hd**-0.5
    kern = lambda: kernel(q, k, v, s)
    plain = lambda: plain_fn(q, k, v, s)
    out, ref = kern().float(), plain().float()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1].item()
    del out, ref
    kms, pms = paired_ms(kern, plain)
    lms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=s))
    flops = 4 * B * nh * n * n * hd
    nbytes = 4 * q.numel() * 2
    bms, by = bound(flops, nbytes)
    extra, same, launched = "", True, 2
    if name == "flash_attention":
        extra = flash_yardsticks(torch, kms, flops, B * nh * n * n, kern)
    else:
        before = kernel.launches
        same = torch.equal(kern(), kern())
        launched = kernel.launches - before
        dms, enq = device_ms(torch, kern), enqueue_us(torch, kern)
        extra = (f"; device {dms:.4f} ms ({flops / dms / 1e9:.1f} TFLOP/s), wrapper enqueue "
                 f"{enq:.1f} us/call; repeat identical {same}, launches {launched}/2")
    log(f"[kernel] {name} B={B} heads={nh} n={n} hd={hd} (x{calls}/batch): max|err| {err:.6f} "
        f"(/max|ref| {rel:.5f}) corr {corr:.8f}; kernel {kms:.4f} ms, plain fp32 {pms:.4f} ms, "
        f"library sdpa {lms:.4f} ms, bound {bms:.4f} ms ({by}){extra}")
    if not (rel <= MHA_REL_ERR and corr >= MHA_MIN_CORR and same and launched == 2):
        raise AssertionError(f"{name} fails at n={n}, hd={hd}: rel {rel}, corr {corr}, repeat "
                             f"identical {same}, launches {launched}/2")
    LEDGER.add(name, path, calls, kms, pms, lms, flops, nbytes, err)
    if name == "mha_vmem":
        LEDGER.add_extra(name, path, calls, device_ms=dms, enqueue_ms=enq / 1000)


def image_kernel_phase(torch, dev):
    from ddmi_tpu_torch.core.config import MLPConfig
    from ddmi_tpu_torch.nn.inr import INRImage
    from ddmi_tpu_torch.ops import inr_decode

    for i, ((H, C, nh), per_forward) in enumerate(ATTN_SHAPES):
        attn_block_case(torch, dev, "image", per_forward * NFE, BATCH, H, H, C, nh, i)

    g = torch.Generator(device=dev).manual_seed(0)
    torch.manual_seed(1)
    cfg = MLPConfig(ch=256, latent_dim=64, in_ch=2, out_ch=3)
    mlp = INRImage(cfg).to(dev)
    perturb_zero_init(mlp, 2, noise=False)
    planes = [torch.randn((BATCH, 64, r, r), generator=g, device=dev).bfloat16()
              for r in (64, 128, 256)]
    folded = inr_decode.fold_inr_image_params(mlp, 1.0)
    toks = inr_decode.render_tokens(planes, RESOLUTION, 1.0, 2)
    kern = lambda: inr_decode.inr_decode_fused(folded, *toks, 0)
    plain = lambda: inr_decode.inr_decode_plain(folded, *toks, 0)
    before = inr_decode.inr_decode_fused.launches
    out, again = kern(), kern()
    launched = inr_decode.inr_decode_fused.launches - before
    same = torch.equal(out, again)
    out, ref = out.float(), plain().float()
    torch.cuda.synchronize()
    err = (out - ref).abs()
    rel = (err.mean() / ref.abs().mean()).item()
    kms, pms = paired_ms(kern, plain, 5)
    dms = device_ms(torch, kern, 5)
    N = toks[0].shape[0]
    ch, in0 = cfg.ch, cfg.latent_dim + cfg.in_ch
    macs = (2 * in0 * ch + 2 * ch * ch            # net_res1: conv1, skip; conv2, conv3
            + 2 * (2 * (ch + in0) * ch + 2 * ch * ch)   # net_res2, net_res3
            + 3 * ch * ch + ch * cfg.out_ch)      # net_res4, torgb
    nbytes = sum(t.numel() * 2 for t in toks) + out.numel() * 2 + (
        folded.wa.numel() + folded.wb.numel()) * 2
    flops = 2 * N * macs
    bms, by = bound(flops, nbytes)
    log(f"[kernel] inr_decode N={N} noise 0 (x1/batch): max|err| {err.max().item():.6f} "
        f"mean|err|/mean|ref| {rel:.6f}, repeat identical {same}, launches {launched}/2; "
        f"kernel {kms:.4f} ms (events), device {dms:.4f} ms ({flops / dms / 1e9:.1f} TFLOP/s = "
        f"{100 * flops / (dms / 1e3) / PEAK_FLOPS:.1f}% of the bf16 peak), plain {pms:.4f} ms, "
        f"library none (no single PyTorch call), bound {bms:.4f} ms ({by})")
    if not (rel < INR_REL_MEAN_ERR and same and launched == 2):
        raise AssertionError(f"inr_decode fails: relative mean error {rel}, repeat identical "
                             f"{same}, launches {launched}")
    LEDGER.add("inr_decode", "image", 1, kms, pms, None, flops, nbytes, err.max().item())
    LEDGER.add_extra("inr_decode", "image", 1, device_ms=dms)

    with torch.no_grad():
        folded.noise_w.fill_(0.3)
    folded.has_noise = True
    a, b, c = kern(), kern(), inr_decode.inr_decode_fused(folded, *toks, 1)
    draws = inr_decode.philox_normal(0, N, device=dev)
    ref = inr_decode.inr_decode_plain(folded, *toks, 0, noise=draws).float()
    torch.cuda.synchronize()
    finite, same, differs = (bool(torch.isfinite(a.float()).all()), torch.equal(a, b),
                             not torch.equal(a, c))
    err = (a.float() - ref).abs()
    rel = (err.mean() / ref.abs().mean()).item()
    log(f"[kernel] inr_decode with noise (gains 0.3): against the plain version on the "
        f"kernel's Philox draws max|err| {err.max().item():.6f} mean|err|/mean|ref| {rel:.6f}; "
        f"finite {finite}, same seed identical {same}, other seed differs {differs}")
    if not (finite and same and differs and rel < INR_REL_MEAN_ERR):
        raise AssertionError("inr_decode noise path failed its checks")


def serve(torch, dev, svc, requests, tag, equal=None):
    """Concurrent requests [(n, seed)] that coalesce into one batch, then a
    repeat of the batch's first seed, compared by `equal` (default: equal
    arrays).  -> (results, batch seconds, repeat seconds, launches, peak
    bytes)."""
    batches = []
    run = svc._sample

    def recording(noise, seed):
        out = run(noise, seed)
        batches.append((seed, bool(torch.isfinite(out).all())))
        return out

    svc._sample = recording
    results, errors = {}, []

    def ask(n, seed):
        try:
            results[seed] = svc.generate(n, seed=seed, timeout=900)
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    read = reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=ask, args=r) for r in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1000)
    t_batch = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"{tag} requests did not finish")
    first = batches[0][0]
    n_first = dict((s, n) for n, s in requests)[first]
    t0 = time.perf_counter()
    repeat = svc.generate(n_first, seed=first, timeout=900)
    t_repeat = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev)
    svc._sample = run
    log(f"[{tag}] batches run: {len(batches)} (first seed, finite): {batches}")
    same = (bool((repeat == results[first][:n_first]).all()) if equal is None
            else equal(repeat, results[first][:n_first]))
    log(f"[{tag}] repeat of seed {first} identical: {same}")
    if len(batches) != 2 or not all(f for _, f in batches) or not same:
        raise AssertionError(f"{tag} checks failed (coalescing, finiteness or repeat)")
    return results, t_batch, t_repeat, launches, peak


def image_slice_phase(torch, dev):
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.serve.server import SamplerService

    cfg = load_config(os.path.join(ROOT, "configs/ldm/celebahq.yaml"))
    ddpm = dataclasses.replace(cfg.model.ddpmconfig, sampling_timesteps=NFE)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, ddpmconfig=ddpm))
    t0 = time.perf_counter()
    svc = SamplerService(cfg, service_batch=BATCH, resolution=RESOLUTION, linger_ms=500,
                         device=dev, allow_init=True)
    perturb_zero_init(svc.pipe, 1)
    n_params = sum(p.numel() for p in svc.pipe.parameters())
    log(f"[slice] celebahq at full width: {n_params} parameters (bf16), set up in "
        f"{time.perf_counter() - t0:.1f} s")
    requests = [(3, 101), (3, 102), (2, 103)]
    try:
        t0 = time.perf_counter()
        svc.warmup()
        log(f"[slice] warm-up batch {time.perf_counter() - t0:.3f} s")
        results, t_batch, t_repeat, launches, peak = serve(torch, dev, svc, requests, "slice")
    finally:
        svc.close()
    for n, seed in requests:
        r = results[seed]
        log(f"[slice] request seed={seed} n={n}: {r.shape} {r.dtype} mean {r.mean():.3f}")
        if r.shape != (n, RESOLUTION, RESOLUTION, 3) or r.dtype.name != "uint8":
            raise AssertionError(f"bad result for seed {seed}: {r.shape} {r.dtype}")
    expect = 16 * NFE * 2
    log(f"[slice] launches over 2 batches: {launches} (attn_block expected {expect}, "
        f"inr_decode >= 2)")
    if launches["attn_block"] != expect or launches["inr_decode"] < 2:
        raise AssertionError(f"the slice did not go through both kernels: {launches}")
    log(f"[slice] coalesced batch of {BATCH} at {RESOLUTION}^2, NFE {NFE}: "
        f"{t_batch:.3f} s = {BATCH / t_batch:.4f} samples/s; repeat request "
        f"{t_repeat:.3f} s; peak allocated {peak / 2**30:.2f} GiB")
    return launches


def profile_top(torch, fn, tag, ours, what="the port's kernels", inference=True):
    """Device time of one fn() by kernel name; the share of names in `ours`."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode, profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1000) for e in prof.key_averages()
                   if e.device_time_total > 0), key=lambda r: -r[1])
    total = sum(ms for _, ms in rows)
    if not total:
        log(f"[{tag}] profiler saw no device time: kernel shares not measured")
        return
    mine = sum(ms for k, ms in rows if any(o in k for o in ours))
    log(f"[{tag}] device time {total:.3f} ms; {what} {mine:.3f} ms "
        f"({100 * mine / total:.1f}%); top kernels:")
    for key, ms in rows[:10]:
        log(f"[{tag}]   {ms:8.3f} ms {100 * ms / total:5.1f}%  {key[:90]}")


def image_breakdown_phase(torch, dev):
    """Where the batch time goes: one UNet forward, the decode and the render
    at the main path's shapes (bf16, seeded weights)."""
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.domains.image import ImagePipeline

    cfg = load_config(os.path.join(ROOT, "configs/ldm/celebahq.yaml"))
    pipe = ImagePipeline(cfg, device=dev, seed=0)
    perturb_zero_init(pipe, 1)
    pipe.cast(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((BATCH, 64, 64, 64), generator=g, device=dev)
    t = torch.full((BATCH,), 500, device=dev, dtype=torch.long)
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: pipe.unet(x, t), 5)
        z = x.bfloat16()
        dec_ms = cuda_ms(lambda: pipe.vae.decode(z), 3)
        hdbf = pipe.vae.decode(z)
        ren_ms = cuda_ms(lambda: pipe._render_grid(hdbf, RESOLUTION, 1.0, 0), 3)
    log(f"[breakdown] batch {BATCH}: UNet forward {unet_ms:.3f} ms (x{NFE} per batch = "
        f"{unet_ms * NFE / 1000:.3f} s), decode {dec_ms:.3f} ms, render {ren_ms:.3f} ms")
    profile_top(torch, lambda: pipe.unet(x, t), "breakdown", ATTN_BLOCK_KERNELS,
                "the attention blocks (attn_block's GroupNorm, GEMM and flash kernels)")


def image_reference_phase(torch, dev):
    """bf16 + kernels on the GPU against fp32 plain versions on the CPU, at a
    small config whose shapes both kernels take."""
    import numpy as np

    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.image import ImagePipeline

    cfg = config_from_dict({
        "model": {"embed_dim": 4, "params": {
            "unetconfig": dict(image_size=16, in_channels=4, model_channels=64,
                               out_channels=4, attention_resolutions=[2],
                               num_res_blocks=1, channel_mult=[1, 2],
                               num_head_channels=32),
            "ddconfig": dict(z_channels=8, resolution=64, out_ch=64, ch=32,
                             ch_mult=[1, 1, 2], num_res_blocks=1,
                             hdbf_resolutions=[32, 16]),
            "mlpconfig": dict(ch=256, latent_dim=64),
            "ddpmconfig": dict(image_size=16, channels=4, sampling_timesteps=4)}},
        "data": {"domain": "image", "test_resolution": 64}})
    cpu = ImagePipeline(cfg, device="cpu", seed=5)
    perturb_zero_init(cpu, 6, noise=False)
    gpu = ImagePipeline(cfg, device=dev, seed=5)
    gpu.load_state_dict(cpu.state_dict())
    gpu.cast(torch.bfloat16)
    noise = np.random.default_rng(7).standard_normal((2, 4, 16, 16)).astype(np.float32)
    ref = cpu.sample_images(2, 64, noise=torch.from_numpy(noise))
    got = gpu.sample_images(2, 64, noise=torch.from_numpy(noise).to(dev)).cpu()
    d = (got - ref).abs()
    log(f"[reference] small config, NFE 4: bf16 kernels vs fp32 plain on the CPU: "
        f"mean|diff| {d.mean().item():.6f}, max|diff| {d.max().item():.6f}, "
        f"pixel std {ref.std().item():.4f}")
    if not (d.mean().item() <= REF_MEAN_ERR and d.max().item() <= REF_MAX_ERR):
        raise AssertionError("the GPU slice disagrees with the CPU reference")


def video_config():
    """configs/ldm/skytimelapse.yaml with the stage-1 decoder and INR of
    configs/d2c-vae/skytimelapse.yaml."""
    from ddmi_tpu_torch.core.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs/ldm/skytimelapse.yaml"))
    s1 = load_config(os.path.join(ROOT, "configs/d2c-vae/skytimelapse.yaml"))
    model = dataclasses.replace(cfg.model, ddconfig=s1.model.ddconfig,
                                mlpconfig=s1.model.mlpconfig)
    return dataclasses.replace(cfg, model=model)


def video_slice_phase(torch, dev):
    """The video service at full width; returns (launches, service) with
    the service still open for the breakdown."""
    from ddmi_tpu_torch.serve.server import SamplerService

    cfg = video_config()
    if cfg.model.ddpmconfig.sampling_timesteps != VIDEO_NFE:
        raise AssertionError("configs/ldm/skytimelapse.yaml no longer samples at NFE 200")
    t0 = time.perf_counter()
    svc = SamplerService(cfg, service_batch=VIDEO_BATCH, linger_ms=500, device=dev,
                         allow_init=True)
    perturb_zero_init(svc.pipe, 11)
    pipe = svc.pipe
    n_params = sum(p.numel() for p in pipe.parameters())
    log(f"[video] skytimelapse at full width: {n_params} parameters (bf16), "
        f"{pipe.n_latent_tokens} latent tokens, planes {pipe.unet.cfg.plane_sizes}, "
        f"{pipe.frames} x {pipe.res}^2, set up in {time.perf_counter() - t0:.1f} s")
    requests = [(1, 201), (1, 202)]
    try:
        t0 = time.perf_counter()
        svc.warmup()
        log(f"[video] warm-up batch {time.perf_counter() - t0:.3f} s")
        results, t_batch, t_repeat, launches, peak = serve(torch, dev, svc, requests, "video")
    except BaseException:
        svc.close()
        raise
    shape = (1, pipe.frames, pipe.res, pipe.res, 3)
    for n, seed in requests:
        r = results[seed]
        log(f"[video] request seed={seed} n={n}: {r.shape} {r.dtype} mean {r.mean():.3f}")
        if r.shape != shape or r.dtype.name != "uint8":
            raise AssertionError(f"bad video for seed {seed}: {r.shape} {r.dtype}")
    expect = {k: 2 * v for k, v in VIDEO_LAUNCHES.items()}
    got = {k: launches[k] for k in expect}
    log(f"[video] launches over 2 batches: {got} (expected {expect}; inr_decode "
        f"{launches['inr_decode']}, expected 0)")
    if got != expect or launches["inr_decode"]:
        raise AssertionError(f"the video slice's launch counts are off: {launches}")
    log(f"[video] coalesced batch of {VIDEO_BATCH} at {pipe.frames} x {pipe.res}^2, "
        f"NFE {VIDEO_NFE}: {t_batch:.3f} s = {VIDEO_BATCH / t_batch:.4f} videos/s; repeat "
        f"request {t_repeat:.3f} s; peak allocated {peak / 2**30:.2f} GiB")
    return launches, svc


def video_breakdown_phase(torch, dev, pipe):
    """One TriplaneUNet forward, the decode and the render timed at the
    slice's shapes; a profile of the forward; and the (shape -> calls per
    batch) of each attention kernel, recorded from one forward and one
    decode."""
    from ddmi_tpu_torch.ops import attention, attn_block, flash_attention

    g = torch.Generator(device=dev).manual_seed(13)
    B = VIDEO_BATCH
    C = pipe.cfg.model.ddpmconfig.channels
    x = torch.randn((B, pipe.n_latent_tokens, C), generator=g, device=dev)
    t = torch.full((B,), 500, device=dev, dtype=torch.long)
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: pipe.unet(x, t), 5)
        z = x.to(pipe.vae.post_xy.weight.dtype)
        dec_ms = cuda_ms(lambda: pipe.vae.decode(z), 3)
        hdbf = pipe.vae.decode(z)
        ren_ms = cuda_ms(lambda: [pipe.render(hdbf, f) for f in range(pipe.frames)], 2)
    log(f"[video-breakdown] batch {B}: TriplaneUNet forward {unet_ms:.3f} ms (x{VIDEO_NFE} "
        f"per batch = {unet_ms * VIDEO_NFE / 1000:.3f} s), decode {dec_ms:.3f} ms, render "
        f"({pipe.frames} frames) {ren_ms:.3f} ms")
    profile_top(torch, lambda: pipe.unet(x, t), "video-breakdown", ATTN_BLOCK_KERNELS)

    shapes = collections.Counter()
    wrapped = [(attn_block, "attention_block"), (attention, "mha_vmem"),
               (flash_attention, "flash_attention")]
    originals = [getattr(mod, name) for mod, name in wrapped]

    def recorder(kind, fn, steps):
        def call(*args, **kw):
            a = args[0]
            if kind == "attn_block":
                shapes[(kind, tuple(a.shape), args[7])] += steps
            else:
                shapes[(kind, tuple(a.shape))] += steps
            return fn(*args, **kw)

        call.launches = 0  # the wrappers count on the module-level name
        return call

    with torch.inference_mode():
        try:
            for (mod, name), fn, kind in zip(wrapped, originals,
                                              ("attn_block", "mha_vmem", "flash_attention")):
                setattr(mod, name, recorder(kind, fn, VIDEO_NFE))
            pipe.unet(x, t)
            for (mod, name), fn, kind in zip(wrapped, originals,
                                              ("attn_block", "mha_vmem", "flash_attention")):
                setattr(mod, name, recorder(kind, fn, 1))
            pipe.vae.decode(z)
        finally:
            for (mod, name), fn in zip(wrapped, originals):
                setattr(mod, name, fn)
    per_batch = collections.Counter()
    for key, calls in shapes.items():
        per_batch[key[0]] += calls
    log(f"[video-breakdown] calls per batch by kernel: {dict(per_batch)}; shapes: "
        f"{sorted(shapes.items())}")
    if dict(per_batch) != VIDEO_LAUNCHES:
        raise AssertionError(f"recorded calls {dict(per_batch)} != {VIDEO_LAUNCHES}")
    return shapes


def video_kernel_phase(torch, dev, shapes):
    for i, (key, calls) in enumerate(sorted(shapes.items())):
        if key[0] == "attn_block":
            (B, H, W, C), nh = key[1], key[2]
            attn_block_case(torch, dev, "video", calls, B, H, W, C, nh, 100 + i)
        else:
            attention_case(torch, dev, key[0], calls, *key[1], 100 + i)
        torch.cuda.empty_cache()


def video_reference_phase(torch, dev):
    """bf16 + kernels on the GPU against fp32 plain versions on the CPU at a
    small video config that goes through all three attention kernels: the
    fused block (UNet ds 2, C 512, hd 64), mha_vmem (the UNet's cross-plane
    attentions at hd 16/32, the decoder's bottleneck at hd 64) and flash
    (the decoder's 64^2 level: n = 4096 + 2 * 8 * 64 = 5120, hd 32)."""
    import numpy as np

    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.video import VideoPipeline

    cfg = config_from_dict({
        "model": {"embed_dim": 16, "params": {
            "unetconfig": dict(in_channels=16, model_channels=256, out_channels=16,
                               num_res_blocks=1, attention_resolutions=[2],
                               channel_mult=[1, 2], num_head_channels=64),
            "ddconfig": dict(resolution=64, z_channels=32, out_ch=16, ch=32,
                             ch_mult=[1, 1, 2, 2], num_res_blocks=1,
                             hdbf_resolutions=[16, 32], inter_attn_resolutions=[8, 32, 64],
                             attn_type="vanilla-multihead"),
            "mlpconfig": dict(ch=256, latent_dim=16),
            "ddpmconfig": dict(channels=16, sampling_timesteps=4)}},
        "data": {"domain": "video", "frames": 8}})
    cpu = VideoPipeline(cfg, device="cpu", seed=5)
    perturb_zero_init(cpu, 6)
    gpu = VideoPipeline(cfg, device=dev, seed=5)
    gpu.load_state_dict(cpu.state_dict())
    gpu.cast(torch.bfloat16)
    noise = np.random.default_rng(8).standard_normal(
        (2, cpu.n_latent_tokens, 16)).astype(np.float32)
    ref = cpu.sample_videos(2, noise=torch.from_numpy(noise))
    read = reset_launches()
    got = gpu.sample_videos(2, noise=torch.from_numpy(noise).to(dev)).cpu()
    launches = read()
    d = (got - ref).abs()
    log(f"[video-reference] small config, NFE 4: bf16 kernels vs fp32 plain on the CPU: "
        f"mean|diff| {d.mean().item():.6f}, max|diff| {d.max().item():.6f}, pixel std "
        f"{ref.std().item():.4f}; launches {launches}")
    if not all(launches[k] > 0 for k in ("attn_block", "mha_vmem", "flash_attention")):
        raise AssertionError(f"the video reference missed a kernel: {launches}")
    if not (d.mean().item() <= REF_MEAN_ERR and d.max().item() <= REF_MAX_ERR):
        raise AssertionError("the GPU video slice disagrees with the CPU reference")


def nerf_mlp_macs(f) -> int:
    """Multiply-adds per point of the NeRF MLP of folded weights `f`, at its
    real widths (no padding): trunk, sigma, feature, dir and rgb heads."""
    W = f.width
    trunk = sum((f.in_xyz if i == 0 or i in f.skips else 0) + (W if i else 0)
                for i in range(f.depth)) * W
    return trunk + W + W * W + (W + f.in_dir) * (W // 2) + (W // 2) * 3


def nerf_kernel_phase(torch, dev):
    """nerf_mlp against its plain version at the render's 4096 x 256 points
    and at a ragged N; timed against the plain version and the bf16 INRNeRF
    module (cuBLAS GEMMs, one per layer).  attn_block at the srn_cars UNet
    shapes."""
    from ddmi_tpu_torch.nn.inr import INRNeRF
    from ddmi_tpu_torch.ops import nerf_mlp

    for i, ((H, C, nh), per_forward) in enumerate(NERF_ATTN_SHAPES):
        attn_block_case(torch, dev, "nerf", per_forward * NERF_NFE, NERF_BATCH, H, H, C, nh,
                        300 + i)
    torch.manual_seed(31)
    mlp = INRNeRF(6, 256, 3 * 32 + 63, 27, (2, 4)).to(dev)
    perturb_zero_init(mlp, 32)
    folded = nerf_mlp.fold_nerf_params(mlp)
    chain = INRNeRF(6, 256, 3 * 32 + 63, 27, (2, 4)).to(dev).bfloat16()
    chain.load_state_dict(mlp.state_dict())
    g = torch.Generator(device=dev).manual_seed(33)
    calls = NERF_LAUNCHES["nerf_mlp"]
    for N in (4096 * 256 - 37, 4096 * 256):
        x = torch.randn((N, 186), generator=g, device=dev).bfloat16()
        kern = lambda: nerf_mlp.nerf_mlp_fused(folded, x)
        plain = lambda: nerf_mlp.nerf_mlp_plain(folded, x)
        before = nerf_mlp.nerf_mlp_fused.launches
        out, again = kern(), kern()
        launched = nerf_mlp.nerf_mlp_fused.launches - before
        ref = plain()
        torch.cuda.synchronize()
        rgb_err = (out[:, :3] - ref[:, :3]).abs().max().item()
        sig_err = (out[:, 3] - ref[:, 3]).abs().max().item()
        sig_max = ref[:, 3].abs().max().item()
        same = torch.equal(out, again)
        log(f"[nerf-kernel] nerf_mlp N={N}: rgb max|err| {rgb_err:.6f}, sigma max|err| "
            f"{sig_err:.6f} (max|sigma| {sig_max:.4f}); repeat identical {same}, launches "
            f"{launched}/2")
        if not (rgb_err <= NERF_RGB_ERR and sig_err <= NERF_SIGMA_REL_ERR * max(1.0, sig_max)
                and bool(torch.isfinite(out).all()) and same and launched == 2):
            raise AssertionError(f"nerf_mlp fails at N={N}")
        del out, ref, again
    with torch.inference_mode():
        kms, pms = paired_ms(kern, plain, 5)
        cms = cuda_ms(lambda: chain(x), 5)
    N = x.shape[0]
    flops = 2 * N * nerf_mlp_macs(folded)
    nbytes = x.numel() * 2 + N * 4 * 4 + 2 * nerf_mlp_macs(folded)
    bms, by = bound(flops, nbytes)
    log(f"[nerf-kernel] nerf_mlp N={N} (x{calls}/batch): kernel {kms:.4f} ms, plain fp32 "
        f"{pms:.4f} ms, bf16 INRNeRF (cuBLAS GEMM chain, not one call) {cms:.4f} ms, library "
        f"none (no single PyTorch call), bound {bms:.4f} ms ({by}; {flops / 1e12:.4f} TFLOP, "
        f"{nbytes / 1e9:.4f} GB); {flops / kms / 1e9:.1f} TFLOP/s = "
        f"{100 * flops / (kms / 1e3) / PEAK_FLOPS:.1f}% of the bf16 peak")
    LEDGER.add("nerf_mlp", "nerf", calls, kms, pms, None, flops, nbytes,
               max(rgb_err, sig_err))
    LEDGER.rows["nerf_mlp"]["by_path"]["nerf"]["cublas_chain_ms"] = calls * cms


def nerf_config():
    """configs/ldm/srn_cars.yaml with its data.conv_config made absolute."""
    from ddmi_tpu_torch.core.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs/ldm/srn_cars.yaml"))
    data = dataclasses.replace(cfg.data, conv_config=os.path.join(ROOT, cfg.data.conv_config))
    return dataclasses.replace(cfg, data=data)


def count_attention_blocks(torch, unet, x, t):
    """(shape -> count) of the UNet's AttentionBlock calls in one forward,
    from forward hooks on the module tree, and how many the fused block
    takes."""
    from ddmi_tpu_torch.nn.unet import AttentionBlock
    from ddmi_tpu_torch.ops import attn_block

    seen = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.update([(tuple(args[0].shape[1:]), mod.num_heads)]))
        for m in unet.modules() if isinstance(m, AttentionBlock)]
    try:
        with torch.inference_mode():
            unet(x, t)
    finally:
        for h in hooks:
            h.remove()
    fused = sum(c for ((C, H, W), nh), c in seen.items() if attn_block.jax_supported(H * W, C, nh))
    return dict(seen), fused, len(hooks)


def nerf_slice_phase(torch, dev):
    """The NeRF service at full width; returns (launches, service) with the
    service still open for the breakdown."""
    from ddmi_tpu_torch.serve.server import SamplerService

    cfg = nerf_config()
    if cfg.model.ddpmconfig.sampling_timesteps != NERF_NFE:
        raise AssertionError("configs/ldm/srn_cars.yaml no longer samples at NFE 200")
    t0 = time.perf_counter()
    svc = SamplerService(cfg, service_batch=NERF_BATCH, resolution=NERF_RES,
                         n_views=NERF_VIEWS, linger_ms=500, device=dev, allow_init=True)
    perturb_zero_init(svc.pipe, 21)
    pipe = svc.pipe
    n_params = sum(p.numel() for p in pipe.parameters())
    mlp = pipe.mlp
    log(f"[nerf] srn_cars at full width: {n_params} parameters (bf16), latents "
        f"{pipe.latent_res}^2 x {cfg.model.ddpmconfig.channels}, MLP D {mlp.depth} W "
        f"{mlp.width} skips {mlp.skips} xyz {mlp.in_channels_xyz} dir {mlp.in_channels_dir}, "
        f"{pipe.n_samples} samples per ray, {NERF_VIEWS} views at {NERF_RES}^2, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    r, c = pipe.latent_res, cfg.model.ddpmconfig.channels
    x = torch.zeros((NERF_BATCH, c, r, r), device=dev)
    t = torch.full((NERF_BATCH,), 500, device=dev, dtype=torch.long)
    shapes, fused, blocks = count_attention_blocks(torch, pipe.unet, x, t)
    log(f"[nerf] UNet attention blocks in the module tree: {blocks}, called as "
        f"{shapes}; the fused block takes {fused} per forward")
    if fused * NERF_NFE != NERF_LAUNCHES["attn_block"] or blocks != fused:
        raise AssertionError(f"expected 11 fused attention blocks per forward, got {fused}")
    requests = [(1, 301), (1, 302)]
    try:
        t0 = time.perf_counter()
        svc.warmup()
        log(f"[nerf] warm-up batch {time.perf_counter() - t0:.3f} s")
        results, t_batch, t_repeat, launches, peak = serve(torch, dev, svc, requests, "nerf")
    except BaseException:
        svc.close()
        raise
    shape = (1, NERF_VIEWS, NERF_RES, NERF_RES, 3)
    for n, seed in requests:
        res = results[seed]
        log(f"[nerf] request seed={seed} n={n}: {res.shape} {res.dtype} mean {res.mean():.3f}")
        if res.shape != shape or res.dtype.name != "uint8":
            raise AssertionError(f"bad NeRF views for seed {seed}: {res.shape} {res.dtype}")
    expect = {k: 2 * v for k, v in NERF_LAUNCHES.items()}
    got = {k: launches[k] for k in expect}
    others = {k: v for k, v in launches.items() if k not in expect}
    log(f"[nerf] launches over 2 batches: {got} (expected {expect}); others {others} "
        f"(expected 0)")
    if got != expect or any(others.values()):
        raise AssertionError(f"the NeRF slice's launch counts are off: {launches}")
    log(f"[nerf] coalesced batch of {NERF_BATCH} scenes x {NERF_VIEWS} views at "
        f"{NERF_RES}^2, NFE {NERF_NFE}: {t_batch:.3f} s = {NERF_BATCH / t_batch:.4f} scenes/s "
        f"on {nvidia_smi()}; repeat request {t_repeat:.3f} s; peak allocated "
        f"{peak / 2**30:.2f} GiB")
    return launches, svc


def nerf_breakdown_phase(torch, dev, pipe):
    """One UNet forward, one scene's decode and one view's render at the
    slice's shapes, the render split over one 4096-ray chunk into the
    triplane gather with the embeddings, the MLP kernel and the compositing;
    profiles of one view's render and of one forward."""
    from ddmi_tpu_torch.domains.nerf import get_rays, raw2outputs, spherical_poses

    g = torch.Generator(device=dev).manual_seed(23)
    r, c = pipe.latent_res, pipe.cfg.model.ddpmconfig.channels
    x = torch.randn((NERF_BATCH, c, r, r), generator=g, device=dev)
    t = torch.full((NERF_BATCH,), 500, device=dev, dtype=torch.long)
    pose = spherical_poses(1, device=dev)[0]
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: pipe.unet(x, t), 5)
        z1 = x[:1]
        dec_ms = cuda_ms(lambda: pipe.decode_planes(z1), 3)
        planes = pipe.decode_planes(z1)
        folded = pipe.fold_mlp()
        view_ms = cuda_ms(lambda: pipe.render_image(planes, pose, NERF_RES, NERF_RES, folded), 3)
        ro, rd = (a.reshape(-1, 3)[:4096] for a in get_rays(NERF_RES, NERF_RES, pose))
        gather_ms = cuda_ms(lambda: pipe.mlp_input(planes, ro, rd), 3)
        xin, zv = pipe.mlp_input(planes, ro, rd)
        mlp_ms = cuda_ms(lambda: pipe.run_mlp(xin, folded), 3)
        raw = pipe.run_mlp(xin, folded)
        comp_ms = cuda_ms(lambda: raw2outputs(raw, zv, rd, pipe.white_bkgd), 3)
    per_batch = (NERF_NFE * unet_ms + NERF_BATCH * dec_ms
                 + NERF_BATCH * NERF_VIEWS * view_ms) / 1000
    log(f"[nerf-breakdown] batch {NERF_BATCH}: UNet forward {unet_ms:.3f} ms (x{NERF_NFE} = "
        f"{unet_ms * NERF_NFE / 1000:.3f} s), decode of one scene {dec_ms:.3f} ms, one "
        f"{NERF_RES}^2 view {view_ms:.3f} ms (x{NERF_BATCH * NERF_VIEWS} = "
        f"{NERF_BATCH * NERF_VIEWS * view_ms / 1000:.3f} s); sum {per_batch:.3f} s per batch")
    log(f"[nerf-breakdown] one 4096-ray chunk (x4 per view): triplane gather + embeddings "
        f"{gather_ms:.3f} ms, MLP kernel {mlp_ms:.3f} ms, compositing {comp_ms:.3f} ms")
    profile_top(torch, lambda: pipe.render_image(planes, pose, NERF_RES, NERF_RES, folded),
                "nerf-breakdown render", ("nerf_mlp_kernel",))
    profile_top(torch, lambda: pipe.unet(x, t), "nerf-breakdown forward", ATTN_BLOCK_KERNELS,
                "the attention blocks (attn_block's GroupNorm, GEMM and flash kernels)")


def nerf_reference_phase(torch, dev):
    """bf16 + kernels on the GPU against fp32 plain versions on the CPU, at a
    small config whose MLP width (256) the kernel takes and whose UNet
    attention (C 128, 4 heads at 4x4) the fused block takes; NFE 4, 2 views
    at 16^2."""
    import numpy as np

    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline

    cfg = config_from_dict({
        "model": {"embed_dim": 4, "params": {
            "unetconfig": dict(in_channels=12, model_channels=64, out_channels=12,
                               num_res_blocks=1, attention_resolutions=[2],
                               channel_mult=[1, 2], num_head_channels=32),
            "ddconfig": dict(z_channels=16, resolution=32, out_ch=32, ch=32,
                             ch_mult=[1, 2, 2], num_res_blocks=1, hdbf_resolutions=[],
                             inter_attn_resolutions=[32, 16, 8]),
            "mlpconfig": dict(D=6, W=256, skips=[2, 4], N_samples=64),
            "ddpmconfig": dict(channels=12, sampling_timesteps=4)}},
        "data": {"domain": "nerf"}})
    cpu = NeRFPipeline(cfg, device="cpu", seed=5)
    perturb_zero_init(cpu, 6)
    gpu = NeRFPipeline(cfg, device=dev, seed=5)
    gpu.load_state_dict(cpu.state_dict())
    gpu.cast(torch.bfloat16)
    noise = np.random.default_rng(9).standard_normal((2, 12, 8, 8)).astype(np.float32)
    ref = cpu.sample_nerfs(2, n_views=2, H=16, W=16, noise=torch.from_numpy(noise))
    read = reset_launches()
    got = gpu.sample_nerfs(2, n_views=2, H=16, W=16, noise=torch.from_numpy(noise).to(dev))
    got = got.cpu()
    launches = read()
    d = (got.clamp(0, 1) - ref.clamp(0, 1)).abs()
    log(f"[nerf-reference] small config, NFE 4, 2 views at 16^2: bf16 kernels vs fp32 plain "
        f"on the CPU: mean|diff| {d.mean().item():.6f}, max|diff| {d.max().item():.6f}, pixel "
        f"std {ref.std().item():.4f}; launches {launches}")
    if not (launches["nerf_mlp"] == 2 * 2 and launches["attn_block"] > 0):
        raise AssertionError(f"the NeRF reference missed a kernel: {launches}")
    if not ref.clamp(0, 1).std().item() >= NERF_REF_MIN_STD:
        raise AssertionError("the NeRF reference render is too flat to compare")
    if not (d.mean().item() <= NERF_REF_MEAN_ERR and d.max().item() <= NERF_REF_MAX_ERR):
        raise AssertionError("the GPU NeRF slice disagrees with the CPU reference")


def train_kernel_phase(torch, dev):
    """The flash backward against flash_bwd_plain at the celebahq training
    shape, a video-like shape and a ragged n, each timed against its plain
    version and the backward of torch's scaled_dot_product_attention (a
    yardstick the port never calls); the forward's LSE against
    torch.logsumexp; the LSE forward timed at the training shape."""
    import torch.nn.functional as F

    from ddmi_tpu_torch.ops import flash_attention as fa

    for i, (B, nh, n, hd) in enumerate([TRAIN_SHAPE, (2, 4, 2048, 16), (1, 2, 1000, 64)]):
        g = torch.Generator(device=dev).manual_seed(400 + i)
        q, k, v, do = (torch.randn((B, nh, n, hd), generator=g, device=dev).bfloat16()
                       for _ in range(4))
        s = hd**-0.5
        out, lse = fa.flash_attention_fwd(q, k, v, s, with_lse=True)
        ref_out, ref_lse = fa.flash_plain(q, k, v, s, with_lse=True)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, s)
        ref = fa.flash_bwd_plain(q, k, v, out, lse, do, s)
        torch.cuda.synchronize()
        lse_err = (lse - ref_lse).abs().max().item()
        stats = []
        for a, r in zip(got, ref):
            a, r = a.float(), r.float()
            err = (a - r).abs().max().item()
            corr = torch.corrcoef(torch.stack([a.flatten(), r.flatten()]))[0, 1].item()
            stats.append((err, err / r.abs().max().item(), corr))
        del got, ref
        kern = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, s)
        plain = lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, s)
        kms, pms = paired_ms(kern, plain)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o2 = F.scaled_dot_product_attention(*leaves, scale=s)
        lms = cuda_ms(lambda: torch.autograd.grad(o2, leaves, do, retain_graph=True))
        flops = 10 * B * nh * n * n * hd
        nbytes = 8 * q.numel() * 2 + 2 * lse.numel() * 4
        bms, by = bound(flops, nbytes)
        log(f"[train-kernel] flash_attention_bwd B={B} heads={nh} n={n} hd={hd}: "
            + ", ".join(f"d{c} max|err| {e:.6f} (/max|ref| {r:.5f}) corr {c2:.6f}"
                        for c, (e, r, c2) in zip("qkv", stats))
            + f"; LSE max|err| {lse_err:.2e}; kernel {kms:.4f} ms, plain fp32 {pms:.4f} ms, "
            f"library sdpa backward {lms:.4f} ms, bound {bms:.4f} ms ({by})"
            + flash_yardsticks(torch, kms, flops, 2 * B * nh * n * n, kern))
        if not all(r <= FLASH_BWD_REL_ERR and c2 >= FLASH_BWD_MIN_CORR for _, r, c2 in stats):
            raise AssertionError(f"flash backward disagrees at {(B, nh, n, hd)}: {stats}")
        if not lse_err <= LSE_MAX_ERR:
            raise AssertionError(f"flash forward LSE off by {lse_err} at {(B, nh, n, hd)}")
        if i == 0:
            LEDGER.add("flash_attention_bwd", "train", TRAIN_LAUNCHES["flash_attention_bwd"],
                       kms, pms, lms, flops, nbytes, max(e for e, _, _ in stats))
            fwd = lambda: fa.flash_attention_fwd(q, k, v, s, with_lse=True)
            fwd_plain = lambda: fa.flash_plain(q, k, v, s, with_lse=True)
            fms, fpms = paired_ms(fwd, fwd_plain)
            flms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=s))
            fflops, fbytes = 4 * B * nh * n * n * hd, 4 * q.numel() * 2 + lse.numel() * 4
            fbms, fby = bound(fflops, fbytes)
            ferr = (out.float() - ref_out.float()).abs().max().item()
            log(f"[train-kernel] flash_attention with LSE B={B} heads={nh} n={n} hd={hd}: "
                f"max|err| {ferr:.6f}; kernel {fms:.4f} ms, plain fp32 {fpms:.4f} ms, library "
                f"sdpa {flms:.4f} ms, bound {fbms:.4f} ms ({fby})"
                + flash_yardsticks(torch, fms, fflops, B * nh * n * n, fwd))
            LEDGER.add("flash_attention", "train", TRAIN_LAUNCHES["flash_attention"], fms, fpms,
                       flms, fflops, fbytes, ferr)
        del q, k, v, do, out, lse, leaves, o2
        torch.cuda.empty_cache()


def train_slice_phase(torch, dev):
    """Trainer.train_stage2 on configs/ldm/celebahq.yaml at full width
    (seeded weights, zero-init layers perturbed, a random-weight VAE
    encoder; fp32 master parameters, bf16 compute): batch 5 of 256^2
    SyntheticImages, accumulation over 5 micro-steps, 10 micro-steps.  The
    counters, the losses and when the parameters change are checked; then
    one micro-step's time split and profile."""
    from ddmi_tpu_torch.core.amp import amp_denoiser
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.data.synthetic import SyntheticImages
    from ddmi_tpu_torch.diffusion.process import diffusion_loss
    from ddmi_tpu_torch.domains.image import ImagePipeline

    cfg = load_config(os.path.join(ROOT, "configs/ldm/celebahq.yaml"))
    m = cfg.model
    if not (m.amp and m.lossconfig.gradient_accumulate_every == 5 and cfg.data.batch_size == 5):
        raise AssertionError("configs/ldm/celebahq.yaml no longer trains with amp, batch 5 "
                             "and accumulation over 5")
    extra = {**cfg.data.extra, "nan_check_every": 5, "prefetch": 2}
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, extra=extra))
    t0 = time.perf_counter()
    pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed)
    perturb_zero_init(pipe, 41)
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    n_enc = sum(p.numel() for p in pipe.vae.encoder.parameters())
    log(f"[train] celebahq stage 2 at full width: UNet {n_unet} parameters (fp32 masters, "
        f"bf16 compute), VAE encoder {n_enc} (frozen, bf16), set up in "
        f"{time.perf_counter() - t0:.1f} s")
    data = SyntheticImages(cfg.data.batch_size, 256, length=TRAIN_STEPS, seed=0)
    trainer = Trainer(cfg, pipe, data, save_dir=os.path.join(ROOT, "build", "train_smoke"))
    watch = {"input conv": pipe.unet.input_blocks[0][0].weight,
             "middle attention qkv": pipe.unet.middle_block[1].qkv.weight,
             "output conv": pipe.unet.out[2].weight, "mixing logit": pipe.mixing_logit}
    steps, step_fn = [], pipe.stage2_train_step

    def recording(state, x, **kw):
        before = {k: w.detach().clone() for k, w in watch.items()}
        out = step_fn(state, x, **kw)
        changed = [k for k, w in watch.items() if not torch.equal(before[k], w)]
        steps.append((state.step, changed, out[1]["loss"], time.perf_counter()))
        return out

    pipe.stage2_train_step = recording
    torch.cuda.reset_peak_memory_stats(dev)
    read = reset_launches()
    t0 = time.perf_counter()
    state = trainer.train_stage2(epochs=1, save=False)  # 18 GB of state at 1.01B parameters
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev)
    pipe.stage2_train_step = step_fn
    losses = [float(loss) for _, _, loss, _ in steps]
    changes = {i + 1: changed for i, (_, changed, _, _) in enumerate(steps)}
    log(f"[train] {len(steps)} micro-steps, losses {[round(v, 5) for v in losses]}; "
        f"parameters changed at {[i for i, c in changes.items() if c]}")
    log(f"[train] launches: {launches} (expected {TRAIN_LAUNCHES}, the others 0)")
    expect = {k: TRAIN_LAUNCHES.get(k, 0) for k in launches}
    if launches != expect:
        raise AssertionError(f"the train slice's launch counts are off: {launches}")
    if len(steps) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train slice: {len(steps)} micro-steps, losses {losses}")
    for i, changed in changes.items():
        if (i % 5 == 0) != (len(changed) == len(watch)) or (i % 5 and changed):
            raise AssertionError(f"micro-step {i} changed {changed}: parameters must change "
                                 f"at every 5th micro-step and only there")
    steady = (steps[-1][3] - steps[0][3]) / (len(steps) - 1)
    log(f"[train] {len(steps)} micro-steps in {t_run:.3f} s (the first includes set-up); "
        f"steady {1 / steady:.4f} micro-steps/s = {cfg.data.batch_size / steady:.4f} training "
        f"samples/s on {nvidia_smi()}; peak allocated {peak / 2**30:.2f} GiB")

    g = torch.Generator(device=dev).manual_seed(43)
    x = torch.from_numpy(next(iter(data))).to(dev)
    split = {"encode": [], "forward": [], "backward": [], "optimizer+EMA": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = pipe.encode_latents(x, generator=g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, _ = diffusion_loss(pipe.gd, amp_denoiser(pipe.unet, pipe.amp), pipe.mixing_logit,
                                 z, g)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pipe.stage2_apply(state)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            split[key].append(1e3 * dt)
    log("[train-breakdown] one micro-step (host clock with sync, 5 in a row, one of them an "
        "optimizer update and one an EMA update): " + "; ".join(
            f"{k} {sum(v) / len(v):.3f} ms mean ({', '.join(f'{x:.1f}' for x in v)})"
            for k, v in split.items()))
    profile_top(torch, lambda: pipe.stage2_train_step(state, x, generator=g), "train-profile",
                ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"),
                inference=False)
    return launches


def train_reference_phase(torch, dev):
    """One micro-step's loss and gradients at a small config (a UNet whose
    32 x 32 blocks take the flash tier, a tiny encoder): bf16 compute with
    the kernels on the GPU against fp32 plain versions on the CPU, on the
    same weights, images, t, noise and posterior eps."""
    import numpy as np

    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.image import ImagePipeline

    def cfg(amp):
        return config_from_dict({
            "model": {"amp": amp, "embed_dim": 4, "params": {
                "unetconfig": dict(image_size=32, in_channels=4, model_channels=64,
                                   out_channels=4, attention_resolutions=[1, 2],
                                   num_res_blocks=1, channel_mult=[1, 2],
                                   num_head_channels=32),
                "ddconfig": dict(z_channels=8, resolution=128, out_ch=8, ch=32,
                                 ch_mult=[1, 1, 2], num_res_blocks=1,
                                 hdbf_resolutions=[64, 32]),
                "mlpconfig": dict(ch=32, latent_dim=8),
                "ddpmconfig": dict(image_size=32, channels=4)}},
            "data": {"domain": "image"}})

    cpu = ImagePipeline(cfg(False), device="cpu", seed=5)
    perturb_zero_init(cpu, 6)
    gpu = ImagePipeline(cfg(True), device=dev, seed=5)
    gpu.load_state_dict(cpu.state_dict())
    cpu.init_stage2()
    gpu.init_stage2()
    rng = np.random.default_rng(10)
    x = rng.random((2, 128, 128, 3)).astype(np.float32)
    t = rng.integers(0, 1000, (2,))
    noise, eps = (rng.standard_normal((2, 4, 32, 32)).astype(np.float32) for _ in range(2))
    draws = {k: torch.from_numpy(a) for k, a in (("t", t), ("noise", noise), ("eps", eps))}
    ref, _ = cpu.stage2_loss(torch.from_numpy(x), **draws)
    ref.backward()
    read = reset_launches()
    got, _ = gpu.stage2_loss(torch.from_numpy(x).to(dev),
                             **{k: a.to(dev) for k, a in draws.items()})
    got.backward()
    torch.cuda.synchronize()
    launches = read()
    flat = lambda p: torch.cat([v.grad.float().cpu().flatten() for v in p.stage2_params().values()])
    a, r = flat(gpu), flat(cpu)
    cos = torch.nn.functional.cosine_similarity(a, r, dim=0).item()
    rel = abs(got.item() - ref.item()) / abs(ref.item())
    log(f"[train-reference] small config, one micro-step: bf16 kernels loss {got.item():.6f} vs "
        f"fp32 plain on the CPU {ref.item():.6f} (relative {rel:.5f}); gradient cosine "
        f"{cos:.6f}, |g - ref| / |ref| {((a - r).norm() / r.norm()).item():.5f}; launches "
        f"{launches}")
    if not (launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0):
        raise AssertionError(f"the train reference missed the flash kernels: {launches}")
    if not (rel <= TRAIN_REF_LOSS_REL and cos >= TRAIN_REF_MIN_COS):
        raise AssertionError("the GPU train step disagrees with the CPU reference")


def occupancy_config():
    """configs/ldm/shapenet.yaml with its data.conv_config made absolute; its
    stage-1 blocks are those of configs/d2c-vae/shapenet.yaml (checked)."""
    from ddmi_tpu_torch.core.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs/ldm/shapenet.yaml"))
    s1 = load_config(os.path.join(ROOT, "configs/d2c-vae/shapenet.yaml"))
    if (cfg.model.ddconfig, cfg.model.mlpconfig, cfg.model.embed_dim) != (
            s1.model.ddconfig, s1.model.mlpconfig, s1.model.embed_dim):
        raise AssertionError("shapenet's stage-1 blocks differ between the ldm and d2c-vae "
                             "configs")
    data = dataclasses.replace(cfg.data, conv_config=os.path.join(ROOT, cfg.data.conv_config))
    return dataclasses.replace(cfg, data=data)


def occupancy_grid(torch, n, dev):
    """(1, n^3, 3) fp32 points of the corner-aligned grid over the box
    [-0.55, 0.55]^3."""
    lin = torch.linspace(-0.55, 0.55, n, device=dev)
    return torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(1, -1, 3)


def recentre_field(torch, pipe, z, n=33) -> float:
    """Shift INR3D's output bias so that a share OCC_INSIDE of the fields
    decoded from z, on an n^3 grid, lies above the threshold's logit.  A
    random initialisation's field is otherwise all inside or all outside
    (MISE would refine nothing), and with its median at the threshold its
    surface fills the box; about 5% inside gives MISE a surface region of a
    few percent of the cells, as a ShapeNet object's.  -> the shift."""
    t = pipe.generation_kwargs["threshold"]
    pyr = pipe.decode_pyramids(z)
    pts = occupancy_grid(torch, n, pipe.device).expand(z.shape[0], -1, -1)
    with torch.no_grad():
        q = torch.quantile(pipe.logits_from_pyramids(pts, pyr).float().flatten(),
                           1 - OCC_INSIDE).item()
        pipe.mlp.net_out.bias.add_(math.log(t / (1 - t)) - q)
    return math.log(t / (1 - t)) - q


def mesh_checks(meshes, tag) -> list:
    """Finite vertices inside the box (within the pad ring's interpolation,
    1e-4), face indices in range; -> [(vertices, faces)] counts."""
    import numpy as np

    counts = []
    for i, (v, f) in enumerate(meshes):
        ok = (np.isfinite(v).all() and (np.abs(v) <= 0.55 + 1e-4).all()
              and (f.size == 0 or (f.min() >= 0 and f.max() < len(v))))
        if not ok:
            raise AssertionError(f"{tag}: mesh {i} has vertices outside the box or bad faces")
        counts.append((len(v), len(f)))
    return counts


def chamfer_l1(torch, a, b, dev, chunk=2048) -> float:
    """Symmetric Chamfer-L1 (the mean nearest-neighbour Euclidean distance
    each way, halved) between vertex sets a and b, in fp32 on `dev`."""
    a, b = torch.from_numpy(a).float().to(dev), torch.from_numpy(b).float().to(dev)

    def one_way(x, y):
        return torch.cat([torch.cdist(x[i : i + chunk], y).min(1).values
                          for i in range(0, len(x), chunk)]).mean()

    return 0.5 * (one_way(a, b) + one_way(b, a)).item()


def occupancy_slice_phase(torch, dev):
    """attn_block at the shapenet UNet's two shapes; then the occupancy
    service at full width; returns (launches, service) with the service
    still open for the breakdown and the encode path."""
    for i, ((H, C, nh), per_forward) in enumerate(OCC_ATTN_SHAPES):
        attn_block_case(torch, dev, "occ", per_forward * OCC_NFE, OCC_BATCH, H, H, C, nh,
                        400 + i)
    from ddmi_tpu_torch.serve.server import SamplerService

    cfg = occupancy_config()
    if cfg.model.ddpmconfig.sampling_timesteps != OCC_NFE:
        raise AssertionError("configs/ldm/shapenet.yaml no longer samples at NFE 200")
    t0 = time.perf_counter()
    svc = SamplerService(cfg, service_batch=OCC_BATCH, linger_ms=500, device=dev,
                         allow_init=True)
    pipe = svc.pipe
    perturb_zero_init(pipe, 51)
    mk = svc.mesh_kwargs
    if (mk["resolution0"], mk["upsampling_steps"], mk["threshold"], svc.res) != (64, 2, 0.2, 256):
        raise AssertionError(f"shapenet_3plane.yaml's generation settings changed: {mk}")
    n = {k: sum(p.numel() for p in getattr(pipe, k).parameters())
         for k in ("unet", "pointnet", "vae", "mlp")}
    r, c = pipe.latent_res, cfg.model.ddpmconfig.channels
    log(f"[occ] shapenet at full width: parameters {n} (bf16), latents {r}^2 x {c}, MISE "
        f"{mk['resolution0']} -> {svc.res}^3, threshold {mk['threshold']}, "
        f"{OCC_POINTS} points per mesh per round, set up in {time.perf_counter() - t0:.1f} s")
    x = torch.zeros((OCC_BATCH, c, r, r), device=dev)
    t = torch.full((OCC_BATCH,), 500, device=dev, dtype=torch.long)
    shapes, fused, blocks = count_attention_blocks(torch, pipe.unet, x, t)
    log(f"[occ] UNet attention blocks in the module tree: {blocks}, called as {shapes}; the "
        f"fused block takes {fused} per forward")
    if fused * OCC_NFE != OCC_LAUNCHES["attn_block"] or blocks != fused:
        raise AssertionError(f"expected 11 fused attention blocks per forward, got {fused}")
    requests = [(4, 401), (4, 402)]
    try:
        # the warm-up batch: its latents set the random field's offset
        g = torch.Generator(device=dev).manual_seed(52)
        t0 = time.perf_counter()
        z = pipe.sample_latents(OCC_BATCH, noise=torch.randn((OCC_BATCH, c, r, r), generator=g,
                                                             device=dev))
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        shift = recentre_field(torch, pipe, z)
        log(f"[occ] warm-up DDIM batch {t_warm:.3f} s; INR3D output bias shifted by "
            f"{shift:.4f} to put {OCC_INSIDE:.0%} of the box inside the surface")
        results, t_batch, t_repeat, launches, peak = serve(
            torch, dev, svc, requests, "occ", equal=same_meshes)
    except BaseException:
        svc.close()
        raise
    expect = {k: 2 * OCC_LAUNCHES.get(k, 0) for k in launches}
    log(f"[occ] launches over 2 batches: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"the occupancy slice's launch counts are off: {launches}")
    counts = []
    for nreq, seed in requests:
        res = results[seed]
        if len(res) != nreq:
            raise AssertionError(f"seed {seed} got {len(res)} meshes for {nreq}")
        counts += mesh_checks(res, f"occ seed {seed}")
    log(f"[occ] (vertices, faces) per mesh: {counts}")
    if not all(f for _, f in counts):
        raise AssertionError("an occupancy mesh is empty")
    log(f"[occ] coalesced batch of {OCC_BATCH} meshes at {svc.res}^3, NFE {OCC_NFE}: "
        f"{t_batch:.3f} s = {OCC_BATCH / t_batch:.4f} meshes/s on {nvidia_smi()}; repeat "
        f"request (4 meshes) {t_repeat:.3f} s; peak allocated {peak / 2**30:.2f} GiB")
    return launches, svc


def same_meshes(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(va, vb) and np.array_equal(fa, fb) for (va, fa), (vb, fb) in zip(a, b))


def occupancy_breakdown_phase(torch, dev, svc):
    """One UNet forward (events, host enqueue and profiler device time), the
    batch's decode and the lockstep extraction of its 8 meshes split into
    MISE rounds, points, INR3D device time (CUDA events around each round's
    call), octree host time and marching cubes; a profile of one full
    evaluation round."""
    import numpy as np

    from ddmi_tpu_torch.geometry.generation import generate_meshes_batched

    pipe = svc.pipe
    g = torch.Generator(device=dev).manual_seed(53)
    r, c = pipe.latent_res, pipe.cfg.model.ddpmconfig.channels
    x = torch.randn((OCC_BATCH, c, r, r), generator=g, device=dev)
    t = torch.full((OCC_BATCH,), 500, device=dev, dtype=torch.long)
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: pipe.unet(x, t), 5)
        unet_dev = device_ms(torch, lambda: pipe.unet(x, t), 5)
        unet_host = enqueue_us(torch, lambda: pipe.unet(x, t), 5) / 1000
    z = pipe.sample_latents(OCC_BATCH, noise=x)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    dec_ms = cuda_ms(lambda: pipe.decode_pyramids(z), 3)
    pyr = pipe.decode_pyramids(z)
    dec_peak = torch.cuda.max_memory_allocated(dev) - base
    ev = []

    def eval_group(pts):
        p = torch.from_numpy(pts).to(dev)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        with torch.no_grad():
            out = pipe.logits_from_pyramids(p, pyr)
        e.record()
        ev.append((s, e))
        return out.float().cpu().numpy()

    stats = {}
    t0 = time.perf_counter()
    meshes = generate_meshes_batched(eval_group, OCC_BATCH, stats=stats,
                                     **{k: v for k, v in svc.mesh_kwargs.items()
                                        if k != "refinement_step"})
    t_ext = time.perf_counter() - t0
    inr_ms = sum(s.elapsed_time(e) for s, e in ev)
    counts = mesh_checks(meshes, "occ-breakdown")
    log(f"[occ-breakdown] batch {OCC_BATCH}: UNet forward {unet_ms:.3f} ms of events, "
        f"{unet_dev:.3f} ms of device time, {unet_host:.3f} ms host enqueue (x{OCC_NFE} = "
        f"{unet_ms * OCC_NFE / 1000:.3f} s of events); decode of the batch {dec_ms:.3f} ms, "
        f"its peak {dec_peak / 2**30:.2f} GiB above the inputs")
    log(f"[occ-breakdown] extraction of {OCC_BATCH} meshes: {t_ext:.3f} s wall; "
        f"{stats['rounds']} MISE rounds, {stats['points']} points evaluated "
        f"({stats['rounds'] * OCC_BATCH * OCC_POINTS} with padding); INR3D device "
        f"{inr_ms:.3f} ms ({inr_ms / stats['rounds']:.3f} per round); eval calls "
        f"{1e3 * stats['eval_s']:.3f} ms wall (copies in and out included); octree host "
        f"{1e3 * stats['octree_s']:.3f} ms, octrees advanced per round {stats['advanced']}; "
        f"marching cubes {1e3 * stats['marching_cubes_s']:.3f} ms; (vertices, faces) {counts}")
    full = np.random.default_rng(54).uniform(-0.55, 0.55, (OCC_BATCH, OCC_POINTS, 3)).astype(
        np.float32)
    with torch.no_grad():
        fp = torch.from_numpy(full).to(dev)
        round_ms = cuda_ms(lambda: pipe.logits_from_pyramids(fp, pyr), 3)
        log(f"[occ-breakdown] one full round ({OCC_BATCH} x {OCC_POINTS} points): INR3D "
            f"{round_ms:.3f} ms of events")
        profile_top(torch, lambda: pipe.logits_from_pyramids(fp, pyr), "occ-breakdown round",
                    ("gemm", "grid_sampler"), "GEMMs and grid_sample")


def occupancy_reference_phase(torch, dev, svc):
    """A small config at NFE 4, bf16 with the kernels on the GPU against the
    fp32 plain versions on the CPU: logits on a 32^3 grid, inside/outside
    agreement and the meshes' Chamfer-L1.  Then a 3000-point sphere cloud
    through the full-width pointnet, triplane encoder and posterior (the
    service's bf16 stage 1, and the same weights in fp32 on the CPU), then
    decode and extraction on the card."""
    import numpy as np

    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline
    from ddmi_tpu_torch.geometry.generation import generate_meshes_batched

    cfg = config_from_dict({
        "model": {"embed_dim": 4, "pointnet": {"c_dim": 8, "hidden_dim": 32,
                                               "plane_resolution": 32, "n_blocks": 2},
                  "params": {
            "unetconfig": dict(in_channels=12, model_channels=64, out_channels=12,
                               num_res_blocks=1, attention_resolutions=[2],
                               channel_mult=[1, 2], num_head_channels=32),
            "ddconfig": dict(z_channels=16, resolution=32, in_channels=8, out_ch=32, ch=32,
                             ch_mult=[1, 2, 2], num_res_blocks=1, hdbf_resolutions=[8, 16],
                             inter_attn_resolutions=[32, 16, 8]),
            "mlpconfig": dict(in_ch=3, out_ch=1, ch=256, latent_dim=32),
            "ddpmconfig": dict(channels=12, sampling_timesteps=4)}},
        "data": {"domain": "occupancy"}})
    cpu = OccupancyPipeline(cfg, device="cpu", seed=5)
    perturb_zero_init(cpu, 6)
    noise = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 12, 8, 8)).astype(
        np.float32))
    z_ref = cpu.sample_latents(2, noise=noise)
    recentre_field(torch, cpu, z_ref)
    gpu = OccupancyPipeline(cfg, device=dev, seed=5)
    gpu.load_state_dict(cpu.state_dict())
    gpu.cast(torch.bfloat16)
    _, fused, _ = count_attention_blocks(
        torch, gpu.unet, torch.zeros((2, 12, 8, 8), device=dev),
        torch.zeros((2,), device=dev, dtype=torch.long))
    read = reset_launches()
    z = gpu.sample_latents(2, noise=noise.to(dev))
    launches = read()
    pts = occupancy_grid(torch, 32, "cpu").expand(2, -1, -1)
    with torch.no_grad():
        ref = cpu.decode_logits_fn(z_ref)(pts)
        got = gpu.decode_logits_fn(z)(pts.to(dev)).float().cpu()
    thr = math.log(0.2 / 0.8)
    rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
    agree = ((got > thr) == (ref > thr)).float().mean().item()

    def meshes(pipe, zz, device):
        pyr = pipe.decode_pyramids(zz)

        def fn(p):
            with torch.no_grad():
                return pipe.logits_from_pyramids(torch.from_numpy(p).to(device),
                                                 pyr).float().cpu().numpy()
        return generate_meshes_batched(fn, 2, resolution0=16, upsampling_steps=1,
                                       points_batch_size=20_000, workers=2)

    m_ref, m_got = meshes(cpu, z_ref, "cpu"), meshes(gpu, z, dev)
    mesh_checks(m_got, "occ-reference")
    cd = [chamfer_l1(torch, va, vb, dev) for (va, fa), (vb, fb) in zip(m_got, m_ref)
          if len(fa) and len(fb)]
    log(f"[occ-reference] small config, NFE 4: bf16 kernels vs fp32 plain on the CPU: logits on "
        f"32^3 mean|err| / mean|ref| {rel:.5f} (bar {OCC_REF_REL_ERR}), inside/outside "
        f"agreement {agree:.5f} (bar {OCC_REF_AGREE}); meshes (faces GPU, CPU) "
        f"{[(len(a[1]), len(b[1])) for a, b in zip(m_got, m_ref)]}, Chamfer-L1 {cd} (bar "
        f"{OCC_REF_CHAMFER * 1.1:.4f} = {OCC_REF_CHAMFER} of the box); launches {launches}")
    if not fused or launches["attn_block"] != fused * 4 or any(v for k, v in launches.items()
                                                   if k != "attn_block"):
        raise AssertionError(f"the occupancy reference's launches are off: {launches}")
    if not (rel <= OCC_REF_REL_ERR and agree >= OCC_REF_AGREE and cd
            and max(cd) <= OCC_REF_CHAMFER * 1.1):
        raise AssertionError("the GPU occupancy slice disagrees with the CPU reference")

    # the encode path at full width
    pipe = svc.pipe
    rng = np.random.default_rng(55)
    d = rng.standard_normal((3000, 3))
    cloud = (0.3 * d / np.linalg.norm(d, axis=1, keepdims=True)
             + 0.005 * rng.standard_normal((3000, 3))).astype(np.float32)[None]
    eps = [torch.from_numpy(rng.standard_normal((1, pipe.cfg.model.embed_dim, pipe.latent_res,
                                                 pipe.latent_res)).astype(np.float32))
           for _ in range(3)]
    cloud_d, eps_d = torch.from_numpy(cloud).to(dev), [e.to(dev) for e in eps]
    enc_ms = cuda_ms(lambda: pipe.encode_latents(cloud_d, eps_d), 3)
    z1 = pipe.encode_latents(cloud_d, eps_d)
    ref_pipe = OccupancyPipeline(pipe.cfg, device="cpu")
    ref_pipe.load_state_dicts(**{k: {n: v.float().cpu() for n, v in
                                     getattr(pipe, k).state_dict().items()}
                                 for k in ("pointnet", "vae", "mlp")})
    z1_ref = ref_pipe.encode_latents(torch.from_numpy(cloud), eps)
    zrel = ((z1.cpu() - z1_ref).abs().mean() / z1_ref.abs().mean()).item()
    # the full-width decode and INR3D on the same latents: bf16 against fp32
    pts = occupancy_grid(torch, 32, "cpu")
    with torch.no_grad():
        lref = ref_pipe.decode_logits_fn(z1_ref)(pts)
        lgot = pipe.decode_logits_fn(z1_ref.to(dev))(pts.to(dev)).float().cpu()
    lrel = ((lgot - lref).abs().mean() / lref.abs().mean()).item()
    lagree = ((lgot > thr) == (lref > thr)).float().mean().item()
    t0 = time.perf_counter()
    zpad = torch.cat([z1, torch.zeros((OCC_BATCH - 1,) + z1.shape[1:], device=dev)])
    meshes1 = svc._extract_meshes(zpad, 1)
    t_ext = time.perf_counter() - t0
    counts = mesh_checks(meshes1, "occ-encode")
    log(f"[occ-encode] 3000-point sphere cloud through the full-width pointnet, triplane "
        f"encoder and posterior: {enc_ms:.3f} ms; bf16 latents vs fp32 on the CPU mean|err| / "
        f"mean|ref| {zrel:.5f} (bar {OCC_REF_REL_ERR}); full-width decode + INR3D on those "
        f"latents, logits on 32^3 mean|err| / mean|ref| {lrel:.5f}, inside/outside agreement "
        f"{lagree:.5f}; decode + extraction {t_ext:.3f} s, (vertices, faces) {counts}; latents "
        f"finite {bool(torch.isfinite(z1).all())}")
    if not (bool(torch.isfinite(z1).all()) and zrel <= OCC_REF_REL_ERR
            and lrel <= OCC_REF_REL_ERR and lagree >= OCC_REF_AGREE):
        raise AssertionError("the occupancy encode path is not finite or disagrees with the CPU")


# ------------------------------------------------------------- stage 1


def stage1_config(name, **extra):
    """A configs/d2c-vae config checked to train as celebahq does (amp,
    accumulation over 5, batch 10, multiscale, the SN regulariser), with
    `extra` merged into data.extra."""
    from ddmi_tpu_torch.core.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs/d2c-vae", name))
    m = cfg.model
    lc = m.lossconfig
    if not (m.amp and lc.gradient_accumulate_every == 5 and cfg.data.batch_size == S1_BATCH
            and lc.multiscale and lc.sn_reg and m.ddconfig.resolution == 256):
        raise AssertionError(f"configs/d2c-vae/{name} no longer trains at amp, accumulation 5, "
                             f"batch {S1_BATCH}, multiscale 256^2 with the SN regulariser")
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, extra={**cfg.data.extra, **extra}))


class Batches:
    """`count` batches of SyntheticImages, made up front (at 512^2 the
    generator takes about a second a batch on the host, which would
    otherwise be what the run measures), without a length: the trainer then
    takes data.extra.steps_per_epoch as the epoch's length (a streaming
    dataset), so a short resumed run keeps the full run's schedules."""

    def __init__(self, batch, res, count, seed):
        from ddmi_tpu_torch.data.synthetic import SyntheticImages

        self.items = list(SyntheticImages(batch, res, length=count, seed=seed))

    def __iter__(self):
        return iter(self.items)


class StepTimer:
    """Wraps a pipeline's train step to synchronise the card after the
    first and the `last` micro-step, and to do nothing else: finish() ->
    the steady seconds per micro-step over micro-steps 2..last of a
    trainer's run."""

    def __init__(self, torch, pipe, method, last):
        self.torch, self.pipe, self.method, self.last = torch, pipe, method, last
        self.fn = getattr(pipe, method)
        self.n, self.times = 0, []
        setattr(pipe, method, self)

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.n += 1
        if self.n in (1, self.last):
            self.torch.cuda.synchronize()
            self.times.append(time.perf_counter())
        return out

    def finish(self):
        delattr(self.pipe, self.method)
        if self.n != self.last:
            raise AssertionError(f"the timed run took {self.n} micro-steps, not {self.last}")
        return (self.times[-1] - self.times[0]) / max(self.last - 1, 1)


class StepRecorder:
    """Wraps a pipeline's train step to record, without reading the card,
    which watched tensors changed at each micro-step (foreach copies and
    norms of the differences, read once at the end), the SN state's
    change, the metrics and the launch counters.  Its copies are device
    work of their own, so a run that it records is not timed (StepTimer
    times a run of its own)."""

    def __init__(self, torch, pipe, method, watch, read):
        self.torch, self.pipe, self.method = torch, pipe, method
        self.fn = getattr(pipe, method)
        self.watch, self.read = list(watch.values()), read
        with torch.no_grad():
            self.prev = torch._foreach_mul(self.watch, 1.0)
        self.rows = []
        setattr(pipe, method, self)

    def __call__(self, state, x, **kw):
        torch = self.torch
        sn = [u for u, _ in state.sn.values()]
        with torch.no_grad():
            disc = torch._foreach_mul(list(state.disc.values()), 1.0) if state.disc else []
        before = self.read()
        out = self.fn(state, x, **kw)
        after = self.read()
        norms = lambda a, b: torch.stack(torch._foreach_norm(torch._foreach_sub(a, b)))
        with torch.no_grad():
            row = {"params": norms(self.watch, self.prev), "metrics": out[1],
                   "launches": {k: after[k] - before[k] for k in after},
                   "sn": norms([u for u, _ in state.sn.values()], sn)}
            if disc:
                row["disc"] = norms(list(state.disc.values()), disc)
            self.prev = torch._foreach_mul(self.watch, 1.0)
        self.rows.append(row)
        return out

    def finish(self):
        delattr(self.pipe, self.method)
        return [{"params": (r["params"] > 0).tolist(),
                 "metrics": {k: float(v) for k, v in r["metrics"].items()},
                 "launches": r["launches"],
                 "sn": bool((r["sn"] > 0).any()),
                 "disc": (r["disc"] > 0).tolist() if "disc" in r else None}
                for r in self.rows]


def check_stage1_rows(rows, tag, n_params):
    """Finite loss terms; the watched parameters bit-unchanged until the
    10th micro-step and every one changed there (the first update's rate
    is 0); the SN state changed at every micro-step; no kernel of the six
    launched."""
    for i, r in enumerate(rows, 1):
        bad = [k for k, v in r["metrics"].items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{tag}: micro-step {i} has non-finite {bad}")
        changed = sum(r["params"])
        if (i < 10 and changed) or (i == 10 and changed != n_params):
            raise AssertionError(f"{tag}: micro-step {i} changed {changed} of {n_params} "
                                 f"parameter tensors: they must change at micro-step 10 only")
        if not r["sn"]:
            raise AssertionError(f"{tag}: the SN state did not change at micro-step {i}")
        if any(r["launches"].values()):
            raise AssertionError(f"{tag}: micro-step {i} launched {r['launches']}: stage-1 "
                                 f"training runs no kernel of the six")


def range_split(torch, fn, prefix, calls=1, attempts=3):
    """fn() under the profiler, host and card: for each profiler range whose
    name starts with `prefix`, per call, the host ms inside it (the
    profiler's own cost included) and the device ms of the kernels
    launched inside it from any thread (the backward's ops run on
    autograd's); -> ({range: (host ms, device ms)}, device ms of all the
    kernels per call).  A profile with no kernel in it is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        ranges = [e for e in events if e.name.startswith(prefix)]
        launches = [(e.time_range.start, sum(k.duration for k in e.kernels))
                    for e in events if e.kernels and not e.name.startswith(prefix)]
        total = sum(us for _, us in launches)
        if not total:
            log(f"[profiler] profile {attempt + 1} of {attempts} recorded no device time")
            continue
        split = {}
        for e in ranges:
            lo, hi = e.time_range.start, e.time_range.end
            dev = sum(us for t, us in launches if lo <= t <= hi)
            host, d = split.get(e.name, (0.0, 0.0))
            split[e.name] = (host + (hi - lo) / 1e3 / calls, d + dev / 1e3 / calls)
        return split, total / 1e3 / calls
    raise AssertionError("the profiler saw no device time")


def stage1_slice_phase(torch, dev, tmp):
    """Trainer.train_stage1 on configs/d2c-vae/celebahq.yaml at full width
    (seeded weights, zero-init layers perturbed, LPIPS on a random VGG):
    10 micro-steps of batch 10 (512^2 synthetic images, 256^2 targets)
    timed with their peak memory, then 10 more from a fresh state with
    the checks of check_stage1_rows and the eval hook after the epoch's
    checkpoint; then a micro-step split by the loss's profiler ranges,
    host against device time and a profile.  -> (pipe, trainer, state,
    ms per micro-step)."""
    from ddmi_tpu_torch.core.trainer import Trainer, default_stage1_eval_hook
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.evals.lpips import build_perceptual

    cfg = stage1_config("celebahq.yaml", nan_check_every=5, prefetch=2,
                        steps_per_epoch=S1_STEPS)
    t0 = time.perf_counter()
    pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed, perceptual=build_perceptual(cfg, dev))
    for i, module in enumerate((pipe.vae, pipe.mlp)):
        perturb_zero_init(module, 50 + i)
    n_vae = sum(p.numel() for p in pipe.vae.parameters())
    n_mlp = sum(p.numel() for p in pipe.mlp.parameters())
    log(f"[stage1] celebahq stage 1 at full width: VAE {n_vae} + INR {n_mlp} parameters "
        f"(fp32 masters, bf16 compute), LPIPS VGG16 {sum(p.numel() for p in pipe.perceptual.parameters())} "
        f"(random weights, frozen, bf16), set up in {time.perf_counter() - t0:.1f} s; cuts: "
        f"{S1_STEPS} micro-steps instead of 200 epochs, synthetic 512^2 images, random-init "
        f"VAE, INR and VGG (no weight files in the repository)")
    data = Batches(S1_BATCH, S1_RES, S1_STEPS, 0)
    timed_dir = os.path.join(tmp, "timed")
    torch.cuda.reset_peak_memory_stats(dev)
    timer = StepTimer(torch, pipe, "stage1_train_step", S1_STEPS)
    t0 = time.perf_counter()
    Trainer(cfg, pipe, data, save_dir=timed_dir).train_stage1(epochs=1,
                                                             eval_hook=lambda *a: None)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    steady = timer.finish()
    peak = torch.cuda.max_memory_allocated(dev)
    shutil.rmtree(timed_dir)
    log(f"[stage1] {S1_STEPS} micro-steps and a checkpoint in {t_run:.3f} s; steady over "
        f"micro-steps 2-{S1_STEPS} {1 / steady:.4f} micro-steps/s = {S1_BATCH / steady:.3f} "
        f"training samples/s ({1e3 * steady:.1f} ms per micro-step) on {nvidia_smi()}; peak "
        f"allocated {peak / 2**30:.2f} GiB")

    trainer = Trainer(cfg, pipe, data, save_dir=tmp)
    read = reset_launches()
    hook_launches = {}

    def hook(tr, st, epoch):
        before = read()
        default_stage1_eval_hook(tr, st, epoch)
        hook_launches.update({k: v - before[k] for k, v in read().items()})

    watch = {f"vae.{k}": p for k, p in pipe.vae.named_parameters()}
    watch.update({f"mlp.{k}": p for k, p in pipe.mlp.named_parameters()})
    rec = StepRecorder(torch, pipe, "stage1_train_step", watch, read)
    state = trainer.train_stage1(epochs=1, eval_hook=hook)
    rows = rec.finish()
    check_stage1_rows(rows, "stage1", len(watch))
    m = rows[-1]["metrics"]
    log(f"[stage1] {len(rows)} micro-steps, losses "
        f"{[round(r['metrics']['loss'], 3) for r in rows]}; last: " + ", ".join(
            f"{k} {v:.5g}" for k, v in m.items())
        + f"; parameters changed at {[i for i, r in enumerate(rows, 1) if any(r['params'])]} "
        f"({len(watch)} tensors at 10), SN state changed at every micro-step, launches 0")
    recs = [json.loads(line) for line in open(os.path.join(tmp, "train.jsonl"))]
    psnr = [r["eval/psnr"] for r in recs if "eval/psnr" in r]
    files = sorted(os.listdir(os.path.join(tmp, "recon")))
    failures = [r for r in recs if "s1/eval_hook_failures" in r]
    log(f"[stage1] eval hook: PSNR {psnr} dB over 4 images, files {files[:6]}, inr_decode "
        f"launches {hook_launches.get('inr_decode')}, failures {len(failures)}")
    if not (len(psnr) == 1 and math.isfinite(psnr[0]) and files and not failures
            and hook_launches.get("inr_decode") == 1):
        raise AssertionError("the stage-1 eval hook did not log PSNR and save its images")

    gen = torch.Generator(device=dev).manual_seed(60)
    host = torch.Generator().manual_seed(60)
    x = torch.from_numpy(next(iter(Batches(S1_BATCH, S1_RES, 1, 1)))).to(dev)
    step = lambda: pipe.stage1_train_step(state, x, generator=gen, host_generator=host)
    split, dev_total = range_split(torch, lambda: [step() for _ in range(5)], "stage1/", 5)
    stages = ("multiscale", "encode", "decode", "inr", "lpips", "sn", "backward", "optimizer")
    missing = [k for k in stages if "stage1/" + k not in split]
    log("[stage1-breakdown] per micro-step, 5 in a row (one of them an optimizer update), by "
        "the profiler's stage1/* ranges: " + "; ".join(
            f"{k} {split['stage1/' + k][1]:.2f} ms device / {split['stage1/' + k][0]:.2f} ms host"
            for k in stages if k not in missing)
        + f"; outside the ranges {dev_total - sum(d for _, d in split.values()):.2f} ms device; "
        f"all kernels {dev_total:.2f} ms (host times under the profiler)")
    if missing:
        raise AssertionError(f"the micro-step's profile has no range for {missing}")
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    dms = device_ms(torch, step, reps=2)
    log(f"[stage1-breakdown] one micro-step: wall {1e3 * t_wall:.1f} ms, host enqueue "
        f"{1e3 * t_enq:.1f} ms, device {dms:.1f} ms (profiler: kernels' time; the device is idle "
        f"{100 * max(0.0, 1 - dms / (1e3 * t_wall)):.1f}% of the wall time)")
    profile_top(torch, step, "stage1-profile", ("inr_decode", "flash_", "gemm_kernel",
                                                 "nerf_mlp", "group_norm_kernel"),
                inference=False)
    return pipe, trainer, state, 1e3 * steady


def stage1_checkpoint_phase(torch, dev, pipe, trainer, state, tmp):
    """Save the state after the run (and the breakdown's micro-steps) as
    the trainer saves it, scramble it, restore it and check it bit for bit;
    then a resumed trainer goes on 2 micro-steps from it with finite
    losses."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager
    from ddmi_tpu_torch.core.trainer import Trainer

    ckpt = CheckpointManager(tmp, prefix="stage1")
    gens = (torch.Generator(device=dev).manual_seed(61), torch.Generator().manual_seed(61))
    step = state.step
    t0 = time.perf_counter()
    ckpt.save(step, {"state": state.state_dict(), "generators": [g.get_state() for g in gens]})
    t_save = time.perf_counter() - t0
    saved = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in flat_state(state.state_dict()).items()}
    size = os.path.getsize(os.path.join(ckpt.root, f"{step}.pt"))
    with torch.no_grad():
        for t in list(state.params.values()) + state.opt.inner.mu + state.opt.acc:
            t.add_(1.0)
    state.step, state.opt.inner.count = -1, -1

    class Wrap:
        def load_state_dict(self, sd):
            state.load_state_dict(sd["state"])

    t0 = time.perf_counter()
    ckpt.restore(Wrap())
    t_restore = time.perf_counter() - t0
    now = flat_state(state.state_dict())
    diff = [k for k in saved if not (torch.equal(saved[k], now[k]) if torch.is_tensor(saved[k])
                                      else saved[k] == now[k])]
    log(f"[stage1-ckpt] step {step}: {size / 2**30:.2f} GiB on disk, saved in {t_save:.2f} s, "
        f"restored in {t_restore:.2f} s into a scrambled state: {len(saved)} entries, "
        f"{len(diff)} differ {diff[:3]}")
    if diff or ckpt.latest_step() != step:
        raise AssertionError("the stage-1 checkpoint does not restore bit for bit")
    resumed = Trainer(trainer.cfg, pipe, Batches(S1_BATCH, S1_RES, 2, 2), save_dir=tmp)
    read = reset_launches()
    rec = StepRecorder(torch, pipe, "stage1_train_step", {"none": state.params["mlp.torgb.bias"]},
                       read)
    st = resumed.train_stage1(epochs=1, resume=True, eval_hook=lambda *a: None)
    rows = rec.finish()
    losses = [r["metrics"]["loss"] for r in rows]
    log(f"[stage1-ckpt] resumed at {step}, {len(rows)} more micro-steps to step {st.step}: "
        f"losses {[round(v, 3) for v in losses]}, launches "
        f"{sum(sum(r['launches'].values()) for r in rows)}, checkpoints {ckpt.all_steps()}")
    if not (st.step == step + 2 and len(rows) == 2 and all(map(math.isfinite, losses))
            and not any(any(r["launches"].values()) for r in rows)):
        raise AssertionError("the resumed stage-1 run failed")


def flat_state(sd, prefix=""):
    """A nested state dict as {"/a/b/0": leaf}."""
    out = {}
    items = sd.items() if isinstance(sd, dict) else enumerate(sd)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(flat_state(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def reconstruct_phase(torch, dev, pipe):
    """reconstruct on 4 of the 512^2 images at 256^2 and at 512^2: one
    inr_decode launch per call, pixels finite in [0, 1], PSNR at 256^2;
    then the kernel against its plain version at both token counts."""
    from ddmi_tpu_torch.core.amp import method_call
    from ddmi_tpu_torch.core.coords import get_scale_injection, resize_antialias, symmetrize
    from ddmi_tpu_torch.ops import inr_decode

    x = torch.from_numpy(next(iter(Batches(S1_BATCH, S1_RES, 1, 3)))[:4]).to(dev)
    launches = {}
    for res in (256, 512):
        g = torch.Generator(device=dev).manual_seed(0)
        read = reset_launches()
        out = pipe.reconstruct(x, res, generator=g, render_seed=1)
        torch.cuda.synchronize()
        n = read()
        ms = cuda_ms(lambda: pipe.reconstruct(x, res, generator=g, render_seed=1), 3)
        ref = resize_antialias(x, res) if res != S1_RES else x
        psnr = -10 * math.log10(max(((out - ref) ** 2).mean().item(), 1e-12))
        ok = bool(torch.isfinite(out).all()) and 0 <= out.min().item() and out.max().item() <= 1
        log(f"[reconstruct] 4 x {S1_RES}^2 -> {res}^2 (scale injection "
            f"{get_scale_injection(res, pipe.anchor)}): launches {n}, pixels in "
            f"[{out.min().item():.4f}, {out.max().item():.4f}], PSNR {psnr:.2f} dB against the "
            f"input at {res}^2 (random weights after 10 micro-steps), {ms:.2f} ms per call")
        if not (ok and n["inr_decode"] == 1 and sum(n.values()) == 1):
            raise AssertionError(f"reconstruct at {res}: launches {n}, pixels ok {ok}")
        launches[res] = n["inr_decode"]

        with torch.no_grad():
            y = resize_antialias(symmetrize(x.float()), pipe.anchor).clamp(-1, 1)
            y = y.permute(0, 3, 1, 2).bfloat16().contiguous(memory_format=torch.channels_last)
            p = {k: v.bfloat16() for k, v in pipe.vae.named_parameters()}
            post = method_call(pipe.vae, p, "encode", y)
            hdbf = method_call(pipe.vae, p, "decode", post.mean)
            si = get_scale_injection(res, pipe.anchor)
            folded = inr_decode.fold_inr_image_params(pipe.mlp, si)
            toks = inr_decode.render_tokens(hdbf, res, si, pipe.mlp.cfg.in_ch)
        kern = lambda: inr_decode.inr_decode_fused(folded, *toks, 1)
        plain = lambda: inr_decode.inr_decode_plain(folded, *toks, 1)
        got, want = kern().float(), plain().float()
        err = (got - want).abs()
        rel = (err.mean() / want.abs().mean()).item()
        kms, pms = paired_ms(kern, plain, 3)
        cfg = pipe.mlp.cfg
        N, ch, in0 = toks[0].shape[0], cfg.ch, cfg.latent_dim + cfg.in_ch
        macs = (2 * in0 * ch + 2 * ch * ch + 2 * (2 * (ch + in0) * ch + 2 * ch * ch)
                + 3 * ch * ch + ch * cfg.out_ch)
        nbytes = sum(t.numel() * 2 for t in toks) + got.numel() * 2 + (
            folded.wa.numel() + folded.wb.numel()) * 2
        bms, by = bound(2 * N * macs, nbytes)
        log(f"[reconstruct] inr_decode N={N} (4 x {res}^2, noise on): max|err| "
            f"{err.max().item():.5f} mean|err|/mean|ref| {rel:.5f}; kernel {kms:.4f} ms, plain "
            f"{pms:.4f} ms, library none, bound {bms:.4f} ms ({by})")
        if not rel < INR_REL_MEAN_ERR:
            raise AssertionError(f"inr_decode at the reconstruction shape disagrees: {rel}")
        LEDGER.add("inr_decode", "reconstruct", 1, kms, pms, None, 2 * N * macs, nbytes,
                   err.max().item())
        del toks, folded, hdbf, got, want
    return {k: (launches[256] + launches[512] if k == "inr_decode" else 0) for k in KERNELS}


def stage1_gan_phase(torch, dev, tmp, plain_ms):
    """configs/d2c-vae/celebahq_gan.yaml: 5 micro-steps through the
    trainer, timed, then 5 more from a fresh state that are checked: the
    discriminator changes at every one, the VAE and INR at none (the first
    window's update has rate 0); finite losses; the extra time per
    micro-step over the plain run's."""
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.evals.lpips import build_perceptual

    cfg = stage1_config("celebahq_gan.yaml", nan_check_every=5, prefetch=2,
                        steps_per_epoch=S1_STEPS)
    if not cfg.model.lossconfig.adversarial:
        raise AssertionError("celebahq_gan.yaml is not adversarial")
    pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed, perceptual=build_perceptual(cfg, dev))
    for i, module in enumerate((pipe.vae, pipe.mlp, pipe.gan)):
        perturb_zero_init(module, 70 + i)
    data = Batches(S1_BATCH, S1_RES, S1_GAN_STEPS, 4)
    timed_dir = os.path.join(tmp, "timed")
    timer = StepTimer(torch, pipe, "stage1_train_step", S1_GAN_STEPS)
    Trainer(cfg, pipe, data, save_dir=timed_dir).train_stage1(epochs=1,
                                                             eval_hook=lambda *a: None)
    steady = timer.finish()
    shutil.rmtree(timed_dir)
    trainer = Trainer(cfg, pipe, data, save_dir=tmp)
    watch = {f"vae.{k}": p for k, p in pipe.vae.named_parameters()}
    watch.update({f"mlp.{k}": p for k, p in pipe.mlp.named_parameters()})
    read = reset_launches()
    rec = StepRecorder(torch, pipe, "stage1_train_step", watch, read)
    state = trainer.train_stage1(epochs=1, eval_hook=lambda *a: None)
    rows = rec.finish()
    check_stage1_rows(rows, "stage1-gan", len(watch))
    n_disc = len(state.disc)
    disc_ok = all(all(r["disc"]) for r in rows)
    log(f"[stage1-gan] {len(rows)} micro-steps: d_loss "
        f"{[round(r['metrics']['d_loss'], 4) for r in rows]}, g_gan "
        f"{[round(r['metrics']['g_gan'], 4) for r in rows]}; the discriminator's {n_disc} "
        f"tensors changed at every micro-step {disc_ok}; VAE and INR unchanged, launches 0; "
        f"steady {1e3 * steady:.1f} ms per micro-step, {1e3 * steady - plain_ms:.1f} ms more "
        f"than the plain run's ({plain_ms:.1f} ms) on {nvidia_smi()}")
    if not disc_ok:
        raise AssertionError("the discriminator did not change at every micro-step")


def stage2_handoff_phase(torch, dev, tmp):
    """configs/ldm/celebahq.yaml's train_stage2 on the save directory of
    the stage-1 run: the VAE and INR come from the newest stage-1
    checkpoint; 2 micro-steps, a checkpoint, then a new trainer resumes
    for 1 more; finite losses.  The UNet is cut to 2 levels of 64 channels
    (its 32^2 level keeps flash attention): the full 1.01B-parameter
    UNet's state is 18 GB a checkpoint, and phase 15 trains it at full
    width already."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.domains.image import ImagePipeline

    cfg = load_config(os.path.join(ROOT, "configs/ldm/celebahq.yaml"))
    extra = {**cfg.data.extra, "nan_check_every": 1, "prefetch": 0, "steps_per_epoch": 2}
    unet = dataclasses.replace(cfg.model.unetconfig, model_channels=64, channel_mult=(1, 2),
                               num_res_blocks=1, attention_resolutions=(2,))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, extra=extra),
        model=dataclasses.replace(cfg.model, unetconfig=unet))
    s1 = CheckpointManager(tmp, prefix="stage1")
    params = s1.restore()["state"]["params"]
    steps = []
    for count, resume in ((2, False), (1, True)):
        pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed)
        trainer = Trainer(cfg, pipe, Batches(cfg.data.batch_size, 256, count, 5 + count),
                          save_dir=tmp)
        st = trainer.train_stage2(epochs=1, resume=resume)
        torch.cuda.synchronize()
        same = all(torch.equal(v, params["vae." + k].to(dev, v.dtype))
                   for k, v in pipe.vae.state_dict().items()) and all(
            torch.equal(v, params["mlp." + k].to(dev)) for k, v in pipe.mlp.state_dict().items())
        steps.append((st.step, same))
        del pipe, trainer, st
        torch.cuda.empty_cache()
    recs = [json.loads(line) for line in open(os.path.join(tmp, "train.jsonl"))]
    losses = [r["s2/loss"] for r in recs if "s2/loss" in r]
    log(f"[stage2-handoff] stage-1 checkpoint step {s1.latest_step()} -> train_stage2: steps "
        f"{[s for s, _ in steps]}, VAE and INR equal to the checkpoint's (bf16 VAE) "
        f"{[ok for _, ok in steps]}, losses {[round(v, 5) for v in losses]}, stage-2 "
        f"checkpoints {CheckpointManager(tmp, prefix='stage2').all_steps()}")
    if not ([s for s, _ in steps] == [2, 3] and all(ok for _, ok in steps)
            and len(losses) == 3 and all(map(math.isfinite, losses))):
        raise AssertionError("the stage-1 -> stage-2 hand-off or the stage-2 resume failed")


def stage1_reference_phase(torch, dev):
    """One stage-1 loss and its gradients at a small config (anchor 64, ch
    64, INR width 64, LPIPS on a random VGG): bf16 on the card against fp32
    plain versions on the CPU, on the same weights, SN vectors and draws.
    Not ch 32: there every GroupNorm group holds one channel, which
    magnifies bf16 roundoff (gradient cosine 0.99897 between bf16 and fp32
    on the CPU, against 0.99999 at ch 64)."""
    import numpy as np

    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.image import ImagePipeline, Stage1Draws
    from ddmi_tpu_torch.evals.lpips import LPIPS

    def cfg(amp):
        return config_from_dict({"model": {"amp": amp, "lr": 1e-3, "embed_dim": 4, "params": {
            "lossconfig": dict(gradient_accumulate_every=5, epochs=2, warmup_epochs=1),
            "ddconfig": dict(z_channels=8, resolution=64, out_ch=16, ch=64, ch_mult=[1, 1, 2],
                             num_res_blocks=1, hdbf_resolutions=[16, 32]),
            "mlpconfig": dict(ch=64, latent_dim=16),
            "unetconfig": dict(image_size=16, in_channels=4, model_channels=32,
                               out_channels=4, attention_resolutions=[], num_res_blocks=1,
                               channel_mult=[1])}}, "data": {"domain": "image"}})

    torch.manual_seed(0)
    vgg = LPIPS().state_dict()
    out = {}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 128, 128, 3)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    noise = [torch.from_numpy(rng.standard_normal((2, 64 * 64, 1)).astype(np.float32))
             for _ in range(12)]
    sn = None
    read = reset_launches()
    for tag, where, amp in (("cpu", "cpu", False), ("card", dev, True)):
        lp = LPIPS(torch.bfloat16 if amp else torch.float32)
        lp.load_state_dict(vgg)
        pipe = ImagePipeline(cfg(amp), device=where, seed=3, perceptual=lp.to(where))
        perturb_zero_init(pipe.mlp, 80)
        st = pipe.init_stage1(10)
        if sn is None:
            sn, weights = st.sn, (pipe.vae.state_dict(), pipe.mlp.state_dict())
        else:
            pipe.load_state_dicts(vae=weights[0], mlp=weights[1])
            st.sn = {k: (u.to(where), v.to(where)) for k, (u, v) in sn.items()}
        draws = Stage1Draws((0.7, 5, 20, 0, 0), eps.to(where), iter(noise))
        loss, m, _, _ = pipe.stage1_loss(x.to(where), 3, draws, st.sn)
        loss.backward()
        g = torch.cat([p.grad.float().cpu().flatten() for p in st.params.values()])
        out[tag] = (loss.item(), {k: float(v) for k, v in m.items()}, g)
    torch.cuda.synchronize()
    launches = read()
    (lc, mc, gc), (lg, mg, gg) = out["cpu"], out["card"]
    cos = torch.nn.functional.cosine_similarity(gg, gc, dim=0).item()
    rel = abs(lg - lc) / abs(lc)
    terms = {k: abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("recon", "kl", "lpips", "sn")}
    log(f"[stage1-reference] small config, one micro-step: bf16 on the card loss {lg:.5f} vs fp32 "
        f"on the CPU {lc:.5f} (relative {rel:.5f}); terms relative " + ", ".join(
            f"{k} {v:.5f} ({mg[k]:.5g} vs {mc[k]:.5g})" for k, v in terms.items())
        + f"; gradient cosine {cos:.6f}; launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"the stage-1 reference launched kernels: {launches}")
    if not (rel <= S1_REF_LOSS_REL and cos >= S1_REF_MIN_COS
            and all(v <= S1_REF_TERM_REL for v in terms.values())):
        raise AssertionError("the GPU stage-1 step disagrees with the CPU reference")


def build_report(name, ptxas) -> None:
    """Registers, spills and dynamic shared memory of each kernel of a
    library built in this run, from the ptxas report and the libraries' own
    sizes, and any ptxas warning (wgmma serialisation, setmaxnreg)."""
    import ctypes
    import re

    from ddmi_tpu_torch.ops import build

    def entry(lib_name, fn, *args):
        f = getattr(build.load(lib_name), fn)
        f.argtypes, f.restype = [ctypes.c_int] * len(args), ctypes.c_int
        return f(*args)

    def smem(kernel, hd):
        if kernel.startswith("flash_"):
            return entry("flash", "ddmi_flash_smem_bytes", int("bwd" in kernel), hd)
        if kernel == "gemm_kernel":
            return entry("attn_block", "ddmi_attn_block_gemm_smem")
        if kernel == "nerf_mlp_kernel":  # at the srn_cars widths: bytes * 8 + ring stages
            v = entry("nerf_mlp", "ddmi_nerf_mlp_smem", 159, 27)
            return f"{v // 8} ({v % 8}-stage ring)"
        if kernel == "inr_decode_kernel":  # at celebahq's out_ch 3: bytes * 8 + ring stages
            v = entry("inr_decode", "ddmi_inr_decode_smem", 3)
            return f"{v // 8} ({v % 8}-stage ring at out_ch 3)"
        return "static only"

    label, spills = None, ""
    for line in ptxas:
        found = re.search(r"Compiling entry function '\w*?(flash_\w+?_kernel|gemm_kernel|"
                          r"group_norm_kernel|nerf_mlp_kernel|inr_decode_kernel)"
                          r"(?:IL[ib](\d+)E)?", line)
        if found:
            kernel, arg = found.group(1), found.group(2)
            label = (f"{kernel}{'<' + arg + '>' if arg else ''} (dynamic shared memory "
                     f"{smem(kernel, int(arg or 0))} bytes)")
        elif "spill" in line and label:
            spills = line
        elif "registers" in line and label:
            log(f"[build]   {name}: {label}: {line.split(':', 1)[-1].strip()}; {spills}")
            label = None
        elif "Compiling entry" not in line and "registers" not in line:
            log(f"[build]   {name} ptxas: {line}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 3
    if not os.path.isdir(os.path.join(ROOT, "ddmi_tpu_torch")):
        print("chip_smoke: ddmi_tpu_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # fp32 comparisons are full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"[device] {kind}, {count} device(s); nvidia-smi: {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    from ddmi_tpu_torch.ops import build

    t0 = time.perf_counter()
    names = build.LIBRARIES
    build.build_all(names)
    log(f"[build] {len(names)} libraries, one nvcc each in parallel: "
        f"{time.perf_counter() - t0:.2f} s wall")
    for name in names:
        info = build.BUILD_LOG.get(name)
        if info is None:
            log(f"[build] {name}: library already built")
            continue
        log(f"[build] {name}: nvcc sm_90a {info['seconds']:.2f} s")
        build_report(name, info["ptxas"])
        if name == "flash":
            log("[build]   flash: mha_vmem runs the flash_fwd_kernel instances above, in their "
                "q pre-scale mode")

    image_kernel_phase(torch, dev)
    image = image_slice_phase(torch, dev)
    image_breakdown_phase(torch, dev)
    image_reference_phase(torch, dev)
    video, svc = video_slice_phase(torch, dev)
    try:
        shapes = video_breakdown_phase(torch, dev, svc.pipe)
    finally:
        svc.close()
    del svc
    torch.cuda.empty_cache()
    video_kernel_phase(torch, dev, shapes)
    video_reference_phase(torch, dev)
    torch.cuda.empty_cache()
    nerf_kernel_phase(torch, dev)
    nerf, svc = nerf_slice_phase(torch, dev)
    try:
        nerf_breakdown_phase(torch, dev, svc.pipe)
    finally:
        svc.close()
    del svc
    torch.cuda.empty_cache()
    nerf_reference_phase(torch, dev)
    torch.cuda.empty_cache()
    train_kernel_phase(torch, dev)
    train = train_slice_phase(torch, dev)
    torch.cuda.empty_cache()
    train_reference_phase(torch, dev)
    torch.cuda.empty_cache()
    occ, svc = occupancy_slice_phase(torch, dev)
    try:
        occupancy_breakdown_phase(torch, dev, svc)
        occupancy_reference_phase(torch, dev, svc)
    finally:
        svc.close()
    del svc
    torch.cuda.empty_cache()
    import tempfile

    tmp = tempfile.mkdtemp(prefix="stage1_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        pipe, trainer, state, plain_ms = stage1_slice_phase(torch, dev, tmp)
        stage1_checkpoint_phase(torch, dev, pipe, trainer, state, tmp)
        recon = reconstruct_phase(torch, dev, pipe)
        del pipe, trainer, state
        torch.cuda.empty_cache()
        stage1_gan_phase(torch, dev, os.path.join(tmp, "gan"), plain_ms)
        torch.cuda.empty_cache()
        stage2_handoff_phase(torch, dev, tmp)
        torch.cuda.empty_cache()
        stage1_reference_phase(torch, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [LEDGER.entry(name, image[name] + video[name] + nerf[name] + train[name]
                            + occ[name] + recon[name]) for name in KERNELS]
    log(f"[device] {nvidia_smi()}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
