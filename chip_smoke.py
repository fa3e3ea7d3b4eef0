#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ddmi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:
  1. device: name, count, `nvidia-smi` name and power limit; no CUDA device
     means exit 3 (there is no CPU fallback);
  2. build: both CUDA kernels from ddmi_tpu_torch/csrc with nvcc (sm_90a),
     with the ptxas register / shared-memory report;
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes, with seeded inputs, and timed against it with CUDA events;
  4. slice: the image SamplerService on configs/ldm/celebahq.yaml at full
     width (seeded weights, zero-init layers perturbed, bf16, batch 8,
     256^2, NFE 100) answers concurrent requests that coalesce into one
     batch plus a repeat of a seed; the kernels' launch counters show the
     batches went through both kernels;
  5. reference: the same slice code at a small config, bf16 with the kernels
     on the GPU against fp32 plain versions on the CPU, same weights/noise.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Nothing in this run imports JAX or the JAX
package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
NFE = 100
BATCH = 8
RESOLUTION = 256
# kernel 1 against its fp32 plain version (the JAX bf16 bar)
ATTN_MAX_ERR, ATTN_MIN_CORR = 0.031, 0.99999
# kernel 2: bf16 activations between 13 matmuls
INR_REL_MEAN_ERR = 0.02
# step 5: bf16 + kernels vs fp32 plain, 4 DDIM steps, pixels in [0, 1]
REF_MEAN_ERR, REF_MAX_ERR = 0.02, 0.25
# celebahq attention blocks per UNet forward by (H, C, heads): 5 at 32x32,
# 5 at 16x16, 6 at 8x8
ATTN_SHAPES = [((32, 512, 16), 5), ((16, 1024, 32), 5), ((8, 2048, 64), 6)]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel, plain, reps: int):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def kernel_phase(torch, dev):
    from ddmi_tpu_torch.core.config import MLPConfig
    from ddmi_tpu_torch.nn.inr import INRImage
    from ddmi_tpu_torch.ops import attn_block, inr_decode

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)

    worst, k_fwd, p_fwd = 0.0, 0.0, 0.0
    for (H, C, nh), per_forward in ATTN_SHAPES:
        x = rnd(BATCH, H, H, C).bfloat16()
        gs, gb = 1 + 0.1 * rnd(C), 0.1 * rnd(C)
        wq, bq = (rnd(C, 3 * C) / C**0.5).bfloat16(), 0.1 * rnd(3 * C)
        wp, bp = (rnd(C, C) / C**0.5).bfloat16(), 0.1 * rnd(C)
        kern = lambda: attn_block.fused_attention_block(x, gs, gb, wq, bq, wp, bp, nh, 32**-0.5)
        plain = lambda: attn_block.attention_block_plain(
            x.float(), gs, gb, wq.float(), bq, wp.float(), bp, nh, 32**-0.5)
        out = kern().float()
        ref = plain()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1].item()
        kms, pms = paired_ms(kern, plain, 20)
        log(f"[kernel] attn_block B={BATCH} n={H * H} C={C} heads={nh}: max|err| {err:.6f} "
            f"corr {corr:.8f}; kernel {kms:.4f} ms, plain fp32 {pms:.4f} ms")
        if not (err <= ATTN_MAX_ERR and corr >= ATTN_MIN_CORR):
            raise AssertionError(f"attn_block disagrees at n={H * H}: err {err}, corr {corr}")
        worst = max(worst, err)
        k_fwd += per_forward * kms
        p_fwd += per_forward * pms
    log(f"[kernel] attn_block, 16 blocks of one UNet forward: kernel {k_fwd:.4f} ms, "
        f"plain {p_fwd:.4f} ms")
    attn = {"max_abs_err": worst, "ms": k_fwd, "plain_ms": p_fwd}

    torch.manual_seed(1)
    mlp = INRImage(MLPConfig(ch=256, latent_dim=64, in_ch=2, out_ch=3)).to(dev)
    perturb_zero_init(mlp, 2, noise=False)
    planes = [rnd(BATCH, 64, r, r).bfloat16() for r in (64, 128, 256)]
    folded = inr_decode.fold_inr_image_params(mlp, 1.0)
    toks = inr_decode.render_tokens(planes, RESOLUTION, 1.0, 2)
    kern = lambda: inr_decode.inr_decode_fused(folded, *toks, 0)
    plain = lambda: inr_decode.inr_decode_plain(folded, *toks, 0)
    out, ref = kern().float(), plain().float()
    torch.cuda.synchronize()
    err = (out - ref).abs()
    rel = (err.mean() / ref.abs().mean()).item()
    kms, pms = paired_ms(kern, plain, 5)
    log(f"[kernel] inr_decode N={toks[0].shape[0]} noise 0: max|err| {err.max().item():.6f} "
        f"mean|err|/mean|ref| {rel:.6f}; kernel {kms:.4f} ms, plain {pms:.4f} ms")
    if not rel < INR_REL_MEAN_ERR:
        raise AssertionError(f"inr_decode disagrees: relative mean error {rel}")
    inr = {"max_abs_err": err.max().item(), "ms": kms, "plain_ms": pms}

    with torch.no_grad():
        folded.noise_w.fill_(0.3)
    folded.has_noise = True
    a, b, c = kern(), kern(), inr_decode.inr_decode_fused(folded, *toks, 1)
    torch.cuda.synchronize()
    finite, same, differs = (bool(torch.isfinite(a.float()).all()), torch.equal(a, b),
                             not torch.equal(a, c))
    log(f"[kernel] inr_decode with noise: finite {finite}, same seed identical {same}, "
        f"other seed differs {differs}")
    if not (finite and same and differs):
        raise AssertionError("inr_decode noise path failed its checks")
    return attn, inr


def slice_phase(torch, dev):
    import dataclasses

    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.ops import attn_block, inr_decode
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
    try:
        t0 = time.perf_counter()
        svc.warmup()
        log(f"[slice] warm-up batch {time.perf_counter() - t0:.3f} s")

        batches = []
        run = svc.pipe.sample_images

        def recording(*args, **kw):
            out = run(*args, **kw)
            batches.append((kw["render_seed"], bool(torch.isfinite(out).all())))
            return out

        svc.pipe.sample_images = recording
        requests = [(3, 101), (3, 102), (2, 103)]
        results, errors = {}, []

        def ask(n, seed):
            try:
                results[seed] = svc.generate(n, seed=seed, timeout=600)
            except Exception as e:  # re-raised below, in the main thread
                errors.append(e)

        attn_block.fused_attention_block.launches = 0
        inr_decode.inr_decode_fused.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=r) for r in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        t_batch = time.perf_counter() - t0
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise TimeoutError("requests did not finish")
        first = batches[0][0]
        n_first = dict((s, n) for n, s in requests)[first]
        t0 = time.perf_counter()
        repeat = svc.generate(n_first, seed=first, timeout=600)
        t_repeat = time.perf_counter() - t0
        launches = {
            "attn_block": attn_block.fused_attention_block.launches,
            "inr_decode": inr_decode.inr_decode_fused.launches,
        }
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        svc.close()

    log(f"[slice] batches run: {len(batches)} (render seed, finite): {batches}")
    for n, seed in requests:
        r = results[seed]
        log(f"[slice] request seed={seed} n={n}: {r.shape} {r.dtype} mean {r.mean():.3f}")
        if r.shape != (n, RESOLUTION, RESOLUTION, 3) or r.dtype.name != "uint8":
            raise AssertionError(f"bad result for seed {seed}: {r.shape} {r.dtype}")
    same = bool((repeat == results[first]).all())
    log(f"[slice] repeat of seed {first} identical: {same}")
    if len(batches) != 2 or not all(f for _, f in batches) or not same:
        raise AssertionError("slice checks failed (coalescing, finiteness or repeat)")
    expect = 16 * NFE * len(batches)
    log(f"[slice] launches over {len(batches)} batches: {launches} (attn_block expected "
        f"{expect}, inr_decode >= {len(batches)})")
    if launches["attn_block"] != expect or launches["inr_decode"] < len(batches):
        raise AssertionError(f"the slice did not go through both kernels: {launches}")
    log(f"[slice] coalesced batch of {BATCH} at {RESOLUTION}^2, NFE {NFE}: "
        f"{t_batch:.3f} s = {BATCH / t_batch:.4f} samples/s; repeat request "
        f"{t_repeat:.3f} s; peak allocated {peak / 2**30:.2f} GiB")
    return launches


def breakdown_phase(torch, dev):
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

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe.unet(x, t)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1000) for e in prof.key_averages()
                   if e.device_time_total > 0), key=lambda r: -r[1])
    total = sum(ms for _, ms in rows)
    if not total:
        log("[breakdown] profiler saw no device time: kernel shares not measured")
        return
    ours = sum(ms for k, ms in rows if "gemm_kernel" in k or "attention_kernel" in k)
    log(f"[breakdown] one UNet forward, device time {total:.3f} ms; attention-block "
        f"kernels {ours:.3f} ms ({100 * ours / total:.1f}%); top kernels:")
    for key, ms in rows[:10]:
        log(f"[breakdown]   {ms:8.3f} ms {100 * ms / total:5.1f}%  {key[:90]}")


def reference_phase(torch, dev):
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

    for name in ("attn_block", "inr_decode"):
        build.load(name)
        info = build.BUILD_LOG.get(name)
        if info is None:
            log(f"[build] {name}: library already built")
            continue
        log(f"[build] {name}: nvcc sm_90a {info['seconds']:.2f} s")
        for line in info["ptxas"]:
            log(f"[build]   {line}")

    attn, inr = kernel_phase(torch, dev)
    launches = slice_phase(torch, dev)
    breakdown_phase(torch, dev)
    reference_phase(torch, dev)

    kernels = [
        {"name": "attn_block", "route": "cuda", "source": "ddmi_tpu_torch/csrc/attn_block.cu",
         "replaces": "ddmi_tpu/ops/pallas/attn_block.py:199",
         "launches": launches["attn_block"], **attn},
        {"name": "inr_decode", "route": "cuda", "source": "ddmi_tpu_torch/csrc/inr_decode.cu",
         "replaces": "ddmi_tpu/ops/pallas/inr_decode.py:307",
         "launches": launches["inr_decode"], **inr},
    ]
    log(f"[device] {nvidia_smi()}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
