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
     against the bf16 INRNeRF module (a chain of cuBLAS GEMMs), and at 603
     xyz + 27 dir inputs (11 panels: the kernel's streamed instance);
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
     kernels on the GPU against fp32 plain versions on the CPU; again with
     the decoder's out_ch at 180, so that the render's MLP takes 603 + 27
     inputs through the streamed instance (its launches count in the
     `kernels` line);
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
     the eval hook after the epoch's checkpoint logs the PSNR of a 256^2
     test batch, saves its images and launches inr_decode once; micro-steps/s, samples/s, peak memory,
     a micro-step split (multiscale, encode, decode, INR, LPIPS, SN,
     backward, optimizer), host against device time and a profile;
 21. stage-1 checkpoint: the state saved as the trainer saves it restores
     bit for bit into a scrambled state, and a resumed trainer goes on 2
     micro-steps with finite losses;
 22. reconstruction: ImagePipeline.reconstruct of 4 of the 512^2 images at
     256^2 and at 512^2, one inr_decode launch per call, pixels finite in
     [0, 1], PSNR logged; inr_decode against its plain version at both
     token counts;
 23. adversarial stage 1 (configs/d2c-vae/celebahq_gan.yaml, 3
     micro-steps): the discriminator changes at every micro-step, the VAE
     and INR at none, finite losses, the extra time per micro-step;
 24. the stage-1 -> stage-2 hand-off: configs/ldm/celebahq.yaml's
     train_stage2 takes the VAE and INR from the stage-1 checkpoint, runs 2
     micro-steps and saves, and a new trainer resumes for 1 more;
 25. stage-1 reference: one loss and its gradients at a small config, bf16
     on the GPU against fp32 on the CPU (loss within 2%, each term within
     5%, gradient cosine >= 0.999);
 26. video stage 1: Trainer.train_stage1 on configs/d2c-vae/skytimelapse.yaml
     at full width (batch 2 of 16 x 256^2 synthetic clips, fp32 masters with
     bf16 compute, accumulation over 5, LPIPS on a random VGG16, the SN
     regulariser; 10 micro-steps): one flash forward with LSE and one
     backward per micro-step (the decoder's n = 20,480 cross-plane
     attention; the n = 73,728 one trains through the MEA) and no other
     launch, every loss term finite, the parameters bit-unchanged through
     micro-step 9 and all changed at 10, the SN state changed at every
     micro-step, the flash shapes recorded; the eval hook's PSNR of 2
     reconstructed clips (2 flash launches); then a timed run of 2
     micro-steps (micro-steps/s, clips/s, peak memory), a split by the
     stage1/* ranges, host against device time and a profile;
 27. video checkpoint and reconstruction: the state restored bit for bit
     into a scrambled one and a resumed micro-step; reconstruct
     of 2 clips (2 flash launches, pixels in [0, 1], PSNR);
 28. adversarial video stage 1 (configs/d2c-vae/skytimelapse_gan.yaml, 2
     checked micro-steps after 2 timed): the 2D and 3D discriminators
     change at every micro-step, the VAE and INR at none;
 29. video stage 2: Trainer.train_stage2 on configs/ldm/skytimelapse.yaml
     at full width on the stage-1 checkpoint (batch 2, 6 micro-steps): the
     flash forward and backward counts per micro-step against the calls
     recorded in the run, finite losses, the parameters moving at every
     micro-step and the EMA at micro-steps 1 and 6 (copies before step
     100); at a cut TriplaneUNet (channel_mult (1, 2), one res block: the
     full-width state is 10 GB a checkpoint) the state saved, restored bit
     for bit into a scrambled one and resumed for a micro-step; a timed run, a micro-step split (encode / forward / backward /
     optimizer+EMA), a profile, and the stage-2 eval hook's EMA video
     sample (at NFE 50; phase 6 samples at the config's 200) with the
     sampling path's exact counts;
 30. video train kernels: the flash forward with LSE and the backward
     against their plain versions at every shape phases 26 and 29 recorded,
     timed beside the plain versions, torch's SDPA forward and backward
     and the bound; the ptxas registers and spills of the hd-128 dk/dv
     instance;
 31. video train reference: one stage-1 and one stage-2 micro-step at a
     small config (64^2, 8 frames; the decoder's 64^2 attention through
     flash), bf16 on the GPU against fp32 on the CPU (loss within 2%,
     gradient cosine >= 0.999);
 32. srn_cars training: Trainer.train_stage1 on configs/d2c-vae/srn_cars.yaml
     at full width (batch 1 of a 3000 x 6 cloud and a 128^2 view, 5000 rays
     x 256 perturbed samples a micro-step, amp, accumulation over 10 with a
     warm-up from rate 0; 20 micro-steps): every launch counter 0 (the
     render trains through the INRNeRF module, never nerf_mlp), finite
     losses, the parameters bit-unchanged through micro-step 19 and all
     changed at 20, the SN state changed at every one, the eval hook silent;
     a timed run of 5 (micro-steps/s, scenes/s, peak memory), a split by the
     stage1/* ranges (encode, decode, render, sn, backward, optimizer), the
     idle share and a profile; then configs/ldm/srn_cars.yaml's
     train_stage2 on that checkpoint (10 micro-steps: every counter 0, the
     parameters moving at each, the EMA on its schedule), its checkpoint
     restored bit for bit into a scrambled state and resumed, a timed run;
 33. shapenet training: configs/d2c-vae/shapenet.yaml's stage 1 at full
     width (batch 12, 3000-point clouds, 2048 query points, accumulation
     over 5; 10 micro-steps, checked as in 32), its eval hook's IoU, a timed
     run, split and profile; configs/ldm/shapenet.yaml's stage 2 on that
     checkpoint as in 32, then the stage-2 eval hook: one EMA latent at NFE
     200 with attn_block at exactly 2200 launches and nothing else, a 32^3
     mesh written as ep0.off;
 34. 3D reference: one stage-1 loss and its gradients of each domain at a
     small config, amp on the GPU against fp32 on the CPU (each term within
     5%, float64 gradient cosine >= 0.99, no launch);
 35. metric networks: InceptionV3 (FID) and I3D (FVD) on random He-normal
     weights against the same networks on the CPU (rel err <= 1e-3), their
     images/s at 299^2 and clips/s at 16 x 224^2, and the Chamfer matrix of
     64 x 64 clouds of 2048 points timed (against the CPU on a corner), the
     protocol's 1355 x 1355 extrapolated;
 36. FID-n at full width: configs/ldm/celebahq.yaml (bf16) samples 16
     images at 256^2 through evals/fid.py::test_fid_n, attn_block and
     inr_decode at exact counts, sampling, features and the host's
     statistics timed apart; seconds per 1000 samples, FID-10k
     extrapolated;
 37. the CLI at full width on srn_cars: `ddmi_tpu_torch.cli.main` trains
     both stages for an epoch of 4 micro-steps (the checkpoints written by
     the trainer), then gen (attn_block 2200, nerf_mlp 32), eval --exp ldm
     (generate(n=1), the same) and eval --exp d2c-vae (PSNR of 4 scenes,
     nerf_mlp 16), exact; and on celebahq with its stage 1 at full width
     and the UNet cut to 2 levels of 64 channels: gen, eval --exp ldm
     (FID-n at eval_samples 16) and eval --exp d2c-vae (rFID), attn_block
     and inr_decode exact; views, images and eval.json on disk, finite
     metrics;
 38. small configs through the CLI on the card, train -> gen -> eval in
     both exps: video (FVD through the full I3D; attn_block, mha_vmem and
     flash launch), occupancy (MMD / COV / 1-NNA of 3 meshes on 32^3 grids
     in lockstep groups of 2; attn_block), NeRF (PSNR, generate; attn_block
     and nerf_mlp);
 39. HTTP serving at full width on celebahq (inside phase 4, on its
     service): /healthz and a 404; 8 concurrent POST /generate (npy, n 1,
     distinct seeds) coalesce into one batch (attn_block 1600, inr_decode
     1, exact) and each body equals in-process `generate` of its seed in
     the same batch, bit for bit; png (when PIL imports) and a gif refused
     with 400; then a --turbo 2 service of the same weights (attn_block
     50 x 16 + 50 x 10 = 1300, inr_decode 1), its samples' mean difference
     from the exact ones; request latency, batch wall times and the HTTP
     path's overhead over in-process generate;
 40. cli/serve.py's service restored from disk (inside phase 37, from the
     checkpoints its trainer wrote; no new checkpoint): srn_cars at full
     width, one scene a batch, gif (when PIL imports) and npy over HTTP with
     attn_block 2200 and nerf_mlp 32 per batch exactly, the npy body equal
     to that of a service given the files' weights; restore seconds and
     scenes/s;
 41. the converter, then serving: for each domain at a small config (image:
     celebahq with a cut UNet; video, occupancy, NeRF: phase 38's) a
     synthetic reference ldm file, cli/convert_reference_ckpt.py, then
     cli/serve.py --turbo 2 over HTTP: the reference step, the file's EMA,
     each request's launches exactly an exact batch's less 2 x (a full
     forward's - a cached forward's), every format of the domain
     (occupancy obj and npz, npy refused with 400);
 42. MDTv2 (model.DiT) generation at full width: the image SamplerService
     on configs/ldm/celebahq.yaml with DiTConfig's widths (1024 tokens,
     hidden 768, depth 12, 12 heads; served bf16, which promotes to fp32
     on the fp32 latent as flax does), batch 8 at 256^2, NFE 50:
     concurrent requests coalesce, a repeated seed is bit-identical,
     inr_decode 1 a batch and no other launch; samples/s, one forward's
     time;
 43. MDTv2 masked stage-2 training at full width (mask ratio 0.3, batch 5,
     amp, accumulation over 5, 10 micro-steps, no checkpoint): no launch,
     finite losses, parameters moving at micro-steps 5 and 10 only; ms a
     micro-step, peak memory; at a cut width 2 micro-steps, a checkpoint,
     the eval hook's 2 EMA images (inr_decode 1) and a resumed micro-step;
 44. the converter's DiT branch on a small config (a reference file with
     maskedtransformer.py's keys), then cli/serve.py over HTTP: the step,
     the file's EMA, one request with inr_decode 1; --turbo refused; gen
     through the CLI;
 45. the UNet's options at celebahq's width, bf16: scale-shift norm with
     1000 class labels (attn_block exactly 16 a forward, its output
     against the plain block's), and the spatial transformer with a
     77 x 512 context through 4 classifier-free-guided DDIM steps (no
     attention kernel: its attention is plain PyTorch, as in JAX);
 46. the standalone ConvONet at full width: configs/convocc/pointcloud/
     shapenet_3plane.yaml's model block through the port's convocc reader
     (pointnet_local_pool, hidden 256, 7 blocks, three 64^2 planes, c_dim
     32; LocalDecoder at hidden 256, 5 blocks), fp32 with TF32 off, batches
     of 32 synthetic shapes (3000-point clouds, noise 0.005, 2048 query
     points): the loss falls over 20 Adam steps on a repeated batch, a
     timed run of 10 (steps/s, peak memory), eval_iou, and one mesh through
     MeshGenerator at the config's generation block (64 -> 256^3): encode
     ms, decode ms per MISE round, host extraction seconds; no launch (JAX
     runs the ConvONet outside any Pallas kernel);
 47. the voxel variant at full width: LocalVoxelEncoder (c_dim 32, planes
     at 64, the plane UNet at depth 4 and 32 filters, 'grid' through the
     UNet3D at f_maps 32 and 3 levels) on batches of 32 32^3 grids, 5
     ConvONet steps: ms a step, peak memory, no launch;
 48. PointNet++ forward at batch 32 x 3000 points: ms, no launch;
 49. each new module and op on the card against the port's fp32 CPU run at
     cut widths: the ConvONet's logits, two steps' losses and parameters,
     the voxel variant, PointNet++'s indices (equal) and features, and
     upfirdn, the resampling StyleGAN blocks, the zeros-padded resample and
     grid_sample_3d (max|err| <= 1e-4 x max(1, max|ref|) for the ops,
     1e-3 for the models);
 50. distribution (ddmi_tpu_torch/parallel): a subprocess started by
     torchrun (`python -m torch.distributed.run --standalone
     --nproc_per_node=1 chip_smoke.py --dist-child ...`: world size 1,
     NCCL on the one card) runs stage-2 training through cli/main.py
     --exp ldm on configs/ldm/celebahq.yaml at full width with its depth
     cut (channel_mult [1, 2, 4], one res block a level: the full state is
     18 GB a checkpoint) and synthetic data: its mesh {data: 4, fsdp: 2}
     falls back to data = 1 with one warning, the UNet goes through
     FSDP2 (parallel/mesh.py::shard_module, mixed precision), 10
     micro-steps with finite losses, the flash forward and backward counts
     exactly the plain one-process run's per micro-step times 10, the
     eval hook's 2 EMA images through the split UNet (attn_block once per
     fused block per forward, inr_decode 1) and a checkpoint; then, in the
     same process group, one micro-step of
     the state wrapped by shard_module over a one-rank shard mesh against
     the unwrapped step's (the parameters within Adam's first-step bar),
     and the plain and the wrapped micro-step timed in turns (the
     wrapper's overhead; the plain one's launches per micro-step are what
     the CLI run's must read).  Back in this process: the checkpoint
     restored by a plain Trainer bit for bit (a SHA-1 of every tensor of
     the state).  Two ranks cannot share one card under NCCL, so only
     world size 1 runs here.

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
# inputs past the NeRF MLP kernel's 8 resident panels: 603 xyz columns (the
# decoder's 3 x 180 plane features and the embedding's 63) and 27 dir ones,
# streamed through its input buffer (phases 10 and 13)
NERF_WIDE_OUT_CH, NERF_WIDE_IN = 180, (3 * 180 + 63, 27)
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
# accumulation over 5, 10 micro-steps; the adversarial config 3
S1_BATCH, S1_RES, S1_STEPS, S1_GAN_STEPS = 10, 512, 10, 3
# one stage-1 micro-step at a small config, bf16 on the GPU against fp32 on
# the CPU: the loss, each term (recon, KL, LPIPS, SN), the gradient cosine
S1_REF_LOSS_REL, S1_REF_TERM_REL, S1_REF_MIN_COS = 0.02, 0.05, 0.999
# video training (configs/d2c-vae/skytimelapse.yaml, then configs/ldm/
# skytimelapse.yaml on its checkpoint): batches of 2 synthetic clips of 16 x
# 256^2; stage 1 accumulates over 5, 10 micro-steps checked and 2 timed (the
# steady window, micro-step 2), the adversarial config 2; per stage-1
# micro-step one flash forward with LSE and one backward (the decoder's
# n = 20,480 cross-plane attention at hd 128; the n = 73,728 one trains
# through the MEA above FLASH_TRAIN_MAX_TOKENS); stage 2 steps every
# micro-step, 6 of them (the EMA at 1 and 6)
V_BATCH, V1_STEPS, V1_TIMED, V1_GAN_STEPS, V2_STEPS = 2, 10, 2, 2, 6
# the video stage-2 eval hook samples at NFE 50 (the config's 200 runs in phase 6)
V2_HOOK_NFE = 50
V1_LAUNCHES = {"flash_attention": V1_STEPS, "flash_attention_bwd": V1_STEPS}
# reconstructing 2 clips (the stage-1 eval hook, reconstruct): the decoder's
# n = 20,480 and n = 73,728 cross-plane attentions through the flash forward
V_RECON_LAUNCHES = {"flash_attention": 2}
# srn_cars and shapenet training (configs/d2c-vae/{srn_cars,shapenet}.yaml,
# then configs/ldm/ on their checkpoints), synthetic data at the real
# shapes: srn_cars stage 1 at batch 1 accumulates over 10 and warms up from
# rate 0, so its parameters move at micro-step 20 (the update at 10 has rate
# 0); shapenet stage 1 at batch 12 accumulates over 5, 10 micro-steps; both
# stage 2s take 10 micro-steps; each stage 1 also a timed run
N1_STEPS, N1_TIMED, O_BATCH, O1_STEPS, O1_TIMED, T2_STEPS = 20, 5, 12, 10, 5, 10
# the occupancy stage-2 eval hook samples one latent at NFE 200 through the
# shapenet UNet's 11 fused attention blocks per forward
O2_HOOK_LAUNCHES = {"attn_block": 11 * OCC_NFE}
# a 3D stage-1 micro-step at a small config, amp on the card against fp32 on
# the CPU: each loss term, the float64 gradient cosine
T3_REF_TERM_REL, T3_REF_MIN_COS = 0.05, 0.99
# the metric networks on the card against the CPU (fp32 both, TF32 off):
# max|err| / max|ref| of InceptionV3's pool features and logits and I3D's
# logits (convolution algorithms sum in other orders)
METRIC_REL_ERR = 1e-3
# the Chamfer matrix timed at 64 x 64 clouds of 2048 points; the 3D
# protocol's is 1355 x 1355
CHAMFER_CLOUDS, CHAMFER_POINTS, CHAMFER_PROTOCOL = 64, 2048, 1355
# FID-n at full width (celebahq): generated samples, in batches of the
# config's test_batch_size; the CLI's eval_samples at celebahq
FID_SAMPLES, CLI_EVAL_SAMPLES = 16, 16
# distribution: celebahq stage 2 at full width, depth cut (the state of the
# full depth is 18 GB a checkpoint), two accumulation windows of 5 through
# the CLI under torchrun, then timed runs of 6 wrapped and unwrapped
DIST_UNET = {"channel_mult": [1, 2, 4], "num_res_blocks": 1}
DIST_STEPS, DIST_TIMED = 10, 6
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
    about 0.15 s), after two warm-up calls."""
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not reps:
        start.record()
        fn()
        end.record()
        end.synchronize()
        reps = int(min(50, max(2, 150.0 / max(start.elapsed_time(end), 1e-3))))
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
                "per": "service batch of each sampling path; the 10 micro-steps of each "
                       "train path; one call of each reconstruction",
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


def events_ms(torch, fn, reps: int) -> float:
    """Mean time of fn() over `reps` calls between two CUDA events, with no
    warm-up: the stand-in where the profiler records no device time."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_PAD = 64


def device_ms(torch, fn, reps: int = 20, attempts: int = 3, alike: bool = True) -> float:
    """Device time of one fn() from the profiler over `reps` calls (after a
    warm-up), per call.  Unlike CUDA events around a small call it leaves
    out the host's enqueue.  A process whose profiles have held many kernel
    records loses a few records at the start of every later profile (more
    as the process goes on), and now and then all of them, while the
    per-record means stay right.  So each profile starts with
    `PROFILE_PAD` spin kernels, left out of the sum, to be lost in place of
    fn's.  Where the calls are `alike` (each launches the same kernels), a
    kernel's launches per call are its records over `reps`, rounded, and
    the time per call is the sum of each kernel's mean record times its
    launches per call; a profile that lost more than a quarter of some
    kernel's records, or all of them, is taken again, up to `attempts`
    times in all, and then the time between two CUDA events (enqueue gaps
    included) stands in, and the log says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
        if not alike and kernels:
            return sum(e.device_time_total for e in kernels) / 1000 / reps
        per_call = {e.key: round(e.count / reps) for e in kernels}
        short = [e.key for e in kernels
                 if not per_call[e.key] or e.count < 0.75 * per_call[e.key] * reps]
        if kernels and not short:
            lost = sum(per_call[e.key] * reps - e.count for e in kernels)
            if lost:
                log(f"[profiler] the profile lost {lost} of "
                    f"{sum(per_call.values()) * reps} kernel records: the next 'device' time "
                    f"is the kernels' mean record times their launches per call")
            return sum(e.device_time_total / e.count * per_call[e.key] for e in kernels) / 1000
        log(f"[profiler] profile {attempt + 1} of {attempts} recorded "
            + (f"{len(short)} kernel(s) fewer than 3/4 of {reps} times a launch per call"
               if kernels else "no device time"))
    ms = events_ms(torch, fn, reps)
    log(f"[profiler] no usable profile in {attempts}: the next 'device' time is CUDA events' "
        f"({ms:.4f} ms a call, enqueue gaps included), not the profiler's")
    return ms


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
        http = http_image_phase(torch, dev, svc, cfg)
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
    return {k: launches[k] + http.get(k, 0) for k in launches}


def start_http(svc):
    """The service's HTTP front end on a free local port, served by a
    thread; -> (server, base url)."""
    from ddmi_tpu_torch.serve.server import make_http_server

    httpd = make_http_server(svc, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_http(httpd) -> None:
    httpd.shutdown()
    httpd.server_close()


def http_call(url, path, payload=None):
    """A GET (payload None) or a POST of JSON -> (status, content type,
    body, seconds to the last byte)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(url + path, data=data),
                                    timeout=900) as r:
            out = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        out = e.code, e.headers["Content-Type"], e.read()
    return (*out, time.perf_counter() - t0)


def have_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def npy(body):
    import io

    import numpy as np

    return np.load(io.BytesIO(body))


def timed_batches(svc):
    """Wrap svc._run_batch to record each batch's (request seeds in batch
    order, seconds from its start to the results on the host); -> the
    record and a function restoring _run_batch."""
    record, run = [], svc._run_batch

    def timed(take, count):
        t0 = time.perf_counter()
        run(take, count)
        record.append(([r.seed for r in take], time.perf_counter() - t0))

    svc._run_batch = timed
    return record, lambda: setattr(svc, "_run_batch", run)


def staggered(fn, seeds, gap=0.1):
    """fn(seed) for each seed from its own thread, started `gap` s apart so
    that the requests reach the service in this order; -> {seed: (result,
    seconds)} once all have returned."""
    out, errors = {}, []

    def one(seed):
        t0 = time.perf_counter()
        try:
            out[seed] = (fn(seed), time.perf_counter() - t0)
        except Exception as e:  # raised again below, in the calling thread
            errors.append(e)

    threads = []
    for seed in seeds:
        threads.append(threading.Thread(target=one, args=(seed,)))
        threads[-1].start()
        time.sleep(gap)
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError("requests did not finish")
    return out


HEALTH_KEYS = ["domain", "initialized", "ok", "resolution", "service_batch", "step"]


def http_image_phase(torch, dev, svc, cfg):
    """Phase 39: the full-width celebahq service of phase 4 behind its HTTP
    front end.  /healthz's keys, 404 for an unknown path; 8 concurrent
    POST /generate (n 1, distinct seeds, npy) coalesce into one batch
    (attn_block 16 x NFE, inr_decode 1, exact) and each body equals the
    in-process `generate` of its seed in the same batch, bit for bit; PNG
    (when PIL imports) beside a GIF request refused with 400 in one batch;
    then a --turbo 2 service of the same weights: 8 requests, attn_block
    16 x NFE/2 + 10 x NFE/2 exact, finite samples, their mean absolute
    difference from the exact ones and the batch times.  -> launches."""
    import dataclasses

    import numpy as np

    from ddmi_tpu_torch.serve.server import SamplerService

    total = collections.Counter()
    seeds = list(range(401, 401 + BATCH))
    svc._linger = 5.0  # the staggered requests all reach the batch
    batches, restore = timed_batches(svc)
    httpd, url = start_http(svc)
    try:
        status, _, body, _ = http_call(url, "/healthz")
        health = json.loads(body)
        log(f"[http] GET /healthz: {status} {health}")
        if status != 200 or sorted(health) != HEALTH_KEYS or health["service_batch"] != BATCH:
            raise AssertionError(f"/healthz answered {status} {health}")
        for payload in (None, {}):
            status, _, body, _ = http_call(url, "/nope", payload)
            if status != 404 or json.loads(body) != {"error": "not found"}:
                raise AssertionError(f"an unknown path answered {status} {body[:200]}")
        read = reset_launches()
        got = staggered(lambda s: http_call(url, "/generate",
                                            {"n": 1, "seed": s, "format": "npy"}), seeds)
        launches = read()
        total.update(launches)
        expect = {k: 0 for k in KERNELS}
        expect.update(attn_block=16 * NFE, inr_decode=1)
        bad = [s for s, (r, _) in got.items() if r[:2] != (200, "application/octet-stream")]
        log(f"[http] 8 concurrent POST /generate (npy): batches {[b for b, _ in batches]}, "
            f"launches {launches} (expected {expect}); statuses {[got[s][0][0] for s in seeds]}")
        if bad or launches != expect or [b for b, _ in batches] != [seeds]:
            raise AssertionError("the HTTP requests did not coalesce into one batch through "
                                 "both kernels")
        t_http_batch = batches[-1][1]
        read = reset_launches()  # the in-process batch and the format batch
        inproc = staggered(lambda s: svc.generate(1, seed=s, timeout=900), seeds)
        if [b for b, _ in batches] != [seeds] * 2:
            raise AssertionError(f"the in-process requests ran as batches {batches}")
        same = all(np.array_equal(npy(got[s][0][2]), inproc[s][0]) for s in seeds)
        lat_http = [got[s][1] for s in seeds]
        lat_in = [inproc[s][1] for s in seeds]
        t_in_batch = batches[-1][1]
        # outside the batch: the last request's latency less the batch it triggered
        over_http, over_in = lat_http[-1] - t_http_batch, lat_in[-1] - t_in_batch
        log(f"[http] bodies equal to in-process generate, bit for bit: {same}; request latency "
            f"(s, in send order, 0.1 s apart): HTTP {[round(x, 4) for x in lat_http]}, "
            f"in-process {[round(x, 4) for x in lat_in]}; batch wall {t_http_batch:.4f} s "
            f"(HTTP) = {BATCH / t_http_batch:.4f} samples/s, {t_in_batch:.4f} s (in-process); "
            f"the last request (the batch's trigger) spends {over_http:.4f} s outside its batch "
            f"over HTTP and {over_in:.4f} s in-process: HTTP overhead {over_http - over_in:.4f} "
            f"s a request ({len(got[seeds[0]][0][2])} bytes of npy a sample)")
        if not same:
            raise AssertionError("an HTTP body differs from in-process generate")
        fmts = ["png", "gif"] if have_pil() else ["gif"]
        answers = staggered(lambda f: http_call(url, "/generate",
                                                {"n": 1, "seed": 7, "format": f}), fmts)
        refused = json.loads(answers["gif"][0][2])
        log(f"[http] formats run: npy, {', '.join(fmts)} (PIL "
            f"{'imports' if have_pil() else 'does not import'}): "
            f"{ {f: answers[f][0][:2] for f in fmts} }; gif refused with {refused}")
        if answers["gif"][0][0] != 400 or refused != {"error": (
                "format 'gif' not valid for domain 'image' (image: png|npy, video: gif|npy, "
                "nerf: gif|npy)")}:
            raise AssertionError("a bad format was not refused with 400")
        if "png" in fmts and (answers["png"][0][:2] != (200, "image/png")
                              or not answers["png"][0][2].startswith(b"\x89PNG")):
            raise AssertionError(f"png answered {answers['png'][0][:2]}")
        total.update(read())
    finally:
        stop_http(httpd)
        restore()
    exact = {s: npy(got[s][0][2]) for s in seeds}

    # --turbo 2: a second service of the same weights
    ddpm = dataclasses.replace(cfg.model.ddpmconfig,
                               extra={**cfg.model.ddpmconfig.extra, "encoder_reuse": 2})
    tcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, ddpmconfig=ddpm))
    p = svc.pipe
    sds = {"unet": p.unet.state_dict(), "vae": p.vae.state_dict(), "mlp": p.mlp.state_dict(),
           "mixing_logit": p.mixing_logit.detach()}
    t0 = time.perf_counter()
    turbo = SamplerService(tcfg, service_batch=BATCH, resolution=RESOLUTION, linger_ms=5000,
                           device=dev, state_dicts=sds)
    t_setup = time.perf_counter() - t0
    tbatches, _ = timed_batches(turbo)
    httpd, url = start_http(turbo)
    try:
        read = reset_launches()
        tgot = staggered(lambda s: http_call(url, "/generate",
                                             {"n": 1, "seed": s, "format": "npy"}), seeds)
        tl = read()
        read = reset_launches()
        timing = turbo_timing(torch, dev, svc, turbo)
        total.update(read())
    finally:
        stop_http(httpd)
        turbo.close()
    total.update(tl)
    half = NFE // 2
    texpect = {k: 0 for k in KERNELS}
    texpect.update(attn_block=16 * half + 10 * (NFE - half), inr_decode=1)
    ok = all(tgot[s][0][:2] == (200, "application/octet-stream") for s in seeds)
    samples = {s: npy(tgot[s][0][2]) for s in seeds} if ok else {}
    diff = (np.mean([np.abs(samples[s].astype(np.float64) - exact[s]).mean() for s in seeds])
            / 255.0 if ok else float("nan"))
    t_turbo = tbatches[-1][1] if tbatches else float("nan")
    med = {k: sorted(v)[1] for k, v in timing.items() if k.endswith("_batch_s")}
    log(f"[http-turbo] in turns, one initial latent: exact batches "
        f"{[round(x, 4) for x in timing['exact_batch_s']]} s, turbo "
        f"{[round(x, 4) for x in timing['turbo_batch_s']]} s: medians {med['exact_batch_s']:.4f} "
        f"and {med['turbo_batch_s']:.4f} s ({med['turbo_batch_s'] / med['exact_batch_s']:.4f}x; "
        f"{BATCH / med['exact_batch_s']:.4f} and {BATCH / med['turbo_batch_s']:.4f} "
        f"samples/s); one UNet forward at batch {BATCH}: full {timing['full_forward_host_ms']:.3f} "
        f"ms host / {timing['full_forward_device_ms']:.3f} ms device, on the cache "
        f"{timing['cached_forward_host_ms']:.3f} / {timing['cached_forward_device_ms']:.3f} ms")
    log(f"[http-turbo] --turbo 2 service of the same weights set up in {t_setup:.2f} s: "
        f"batches {[b for b, _ in tbatches]}, launches {tl} (expected {texpect}); batch wall "
        f"{t_turbo:.4f} s against the exact {t_http_batch:.4f} s ({t_turbo / t_http_batch:.4f}x) "
        f"= {BATCH / t_turbo:.4f} samples/s; the last request {tgot[seeds[-1]][1]:.4f} s; mean "
        f"|turbo - exact| {diff:.5f} of the pixel range; on {nvidia_smi()}")
    if not ok or tl != texpect or [b for b, _ in tbatches] != [seeds] or not diff > 0:
        raise AssertionError("the turbo service failed its checks")
    return dict(total)


def profile_top(torch, fn, tag, ours, what="the port's kernels", inference=True):
    """Device time of one fn() by kernel name; the share of names in `ours`."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode, profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    log_top(prof, tag, ours, what)


def log_top(prof, tag, ours, what="the port's kernels"):
    """A profile's device time by kernel name; the share of names in `ours`."""
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
    del x

    # inputs the kernel streams: NERF_WIDE_IN at the render's chunk of points
    in_xyz, in_dir = NERF_WIDE_IN
    torch.manual_seed(34)
    wide = INRNeRF(6, 256, in_xyz, in_dir, (2, 4)).to(dev)
    perturb_zero_init(wide, 35)
    fw = nerf_mlp.fold_nerf_params(wide)
    N = 4096 * 256
    x = torch.randn((N, in_xyz + in_dir), generator=g, device=dev).bfloat16()
    kern = lambda: nerf_mlp.nerf_mlp_fused(fw, x)
    plain = lambda: nerf_mlp.nerf_mlp_plain(fw, x)
    before = nerf_mlp.nerf_mlp_fused.launches
    out, again = kern(), kern()
    launched = nerf_mlp.nerf_mlp_fused.launches - before
    ref = plain()
    torch.cuda.synchronize()
    rgb_err = (out[:, :3] - ref[:, :3]).abs().max().item()
    sig_err = (out[:, 3] - ref[:, 3]).abs().max().item()
    sig_max = ref[:, 3].abs().max().item()
    same = torch.equal(out, again)
    with torch.inference_mode():
        kms, pms = paired_ms(kern, plain, 5)
    flops = 2 * N * nerf_mlp_macs(fw)
    nbytes = x.numel() * 2 + N * 4 * 4 + 2 * nerf_mlp_macs(fw)
    bms, by = bound(flops, nbytes)
    log(f"[nerf-kernel] nerf_mlp at {in_xyz} xyz + {in_dir} dir inputs (streamed), N={N}: rgb "
        f"max|err| {rgb_err:.6f}, sigma max|err| {sig_err:.6f} (max|sigma| {sig_max:.4f}); "
        f"repeat identical {same}, launches {launched}/2; kernel {kms:.4f} ms, plain fp32 "
        f"{pms:.4f} ms, bound {bms:.4f} ms ({by}); {flops / kms / 1e9:.1f} TFLOP/s = "
        f"{100 * flops / (kms / 1e3) / PEAK_FLOPS:.1f}% of the bf16 peak")
    if not (rgb_err <= NERF_RGB_ERR and sig_err <= NERF_SIGMA_REL_ERR * max(1.0, sig_max)
            and bool(torch.isfinite(out).all()) and same and launched == 2):
        raise AssertionError(f"nerf_mlp fails at {in_xyz} + {in_dir} inputs")
    LEDGER.add("nerf_mlp", f"nerf-wide ({in_xyz} + {in_dir} inputs, one call)", 1, kms, pms,
               None, flops, nbytes, max(rgb_err, sig_err))


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


def nerf_reference_phase(torch, dev, out_ch=32):
    """bf16 + kernels on the GPU against fp32 plain versions on the CPU, at a
    small config whose MLP width (256) the kernel takes and whose UNet
    attention (C 128, 4 heads at 4x4) the fused block takes; NFE 4, 2 views
    at 16^2.  The MLP's xyz input is the decoder's 3 x out_ch plane
    features and the 63 of the embedding: out_ch 180 gives 603 xyz and 27
    dir columns, 11 panels, which the kernel streams through its input
    buffer.  -> the launches."""
    import numpy as np

    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline

    cfg = config_from_dict({
        "model": {"embed_dim": 4, "params": {
            "unetconfig": dict(in_channels=12, model_channels=64, out_channels=12,
                               num_res_blocks=1, attention_resolutions=[2],
                               channel_mult=[1, 2], num_head_channels=32),
            "ddconfig": dict(z_channels=16, resolution=32, out_ch=out_ch, ch=32,
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
    mlp = gpu.mlp
    log(f"[nerf-reference] small config (MLP inputs {mlp.in_channels_xyz} xyz + "
        f"{mlp.in_channels_dir} dir), NFE 4, 2 views at 16^2: bf16 kernels vs fp32 plain "
        f"on the CPU: mean|diff| {d.mean().item():.6f}, max|diff| {d.max().item():.6f}, pixel "
        f"std {ref.std().item():.4f}; launches {launches}")
    if not (launches["nerf_mlp"] == 2 * 2 and launches["attn_block"] > 0):
        raise AssertionError(f"the NeRF reference missed a kernel: {launches}")
    if not ref.clamp(0, 1).std().item() >= NERF_REF_MIN_STD:
        raise AssertionError("the NeRF reference render is too flat to compare")
    if not (d.mean().item() <= NERF_REF_MEAN_ERR and d.max().item() <= NERF_REF_MAX_ERR):
        raise AssertionError("the GPU NeRF slice disagrees with the CPU reference")
    return launches


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


def check_stage1_rows(rows, tag, n_params, move_at=10):
    """Finite loss terms; the watched parameters bit-unchanged until micro-step
    `move_at` and every one changed there (the first update's rate is 0,
    so with accumulation over k they move at the second update, 2k); the
    SN state changed at every micro-step; no kernel of the six launched."""
    for i, r in enumerate(rows, 1):
        bad = [k for k, v in r["metrics"].items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{tag}: micro-step {i} has non-finite {bad}")
        changed = sum(r["params"])
        if (i < move_at and changed) or (i == move_at and changed != n_params):
            raise AssertionError(f"{tag}: micro-step {i} changed {changed} of {n_params} "
                                 f"parameter tensors: they must change at micro-step "
                                 f"{move_at} only")
        if not r["sn"]:
            raise AssertionError(f"{tag}: the SN state did not change at micro-step {i}")
        if any(r["launches"].values()):
            raise AssertionError(f"{tag}: micro-step {i} launched {r['launches']}: stage-1 "
                                 f"training runs no kernel of the six")


def range_split(torch, fn, prefix, calls=1, attempts=3, top=None):
    """fn() under the profiler, host and card: for each profiler range whose
    name starts with `prefix`, per call, the host ms inside it (the
    profiler's own cost included) and the device ms of the kernels
    launched inside it from any thread (the backward's ops run on
    autograd's); -> ({range: (host ms, device ms)}, device ms of all the
    kernels per call).  With `top` = (tag, names) the same profile's top
    kernels are logged (`log_top`).  Each profile starts with
    `PROFILE_PAD` spin kernels, as `device_ms`'s do: CUPTI loses a late
    profile's first records, and they are lost in place of fn's.  A
    profile with no kernel of fn in it, or that lost every pad record (so
    perhaps some of fn's too), is taken again; if none of `attempts` is
    whole, the host times stand and every device time is NaN (not
    measured), and the log says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        recorded = prof.events()
        # the pad's kernels are device events of no host op
        pad = sum(1 for e in recorded
                  if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name)
        events = [e for e in recorded if e.device_type == DeviceType.CPU]
        ranges = [e for e in events if e.name.startswith(prefix)]
        launches = [(e.time_range.start, sum(k.duration for k in e.kernels))
                    for e in events if e.kernels and not e.name.startswith(prefix)]
        total = sum(us for _, us in launches)
        if not total or not pad:
            log(f"[profiler] profile {attempt + 1} of {attempts} recorded "
                + ("no device time" if not total else
                   f"none of its {PROFILE_PAD} pad kernels (fn's first records may be lost)"))
            continue
        if pad < PROFILE_PAD:
            log(f"[profiler] the split's profile lost {PROFILE_PAD - pad} of its {PROFILE_PAD} "
                f"pad records, none of fn's")
        split = {}
        for e in ranges:
            lo, hi = e.time_range.start, e.time_range.end
            dev = sum(us for t, us in launches if lo <= t <= hi)
            host, d = split.get(e.name, (0.0, 0.0))
            split[e.name] = (host + (hi - lo) / 1e3 / calls, d + dev / 1e3 / calls)
        if top is not None:
            log_top(prof, *top)
        return split, total / 1e3 / calls
    log(f"[profiler] no whole profile in {attempts}: the split's device times are not "
        f"measured (NaN), its host times stand")
    nan = float("nan")
    split = {}
    for e in ranges:
        host, _ = split.get(e.name, (0.0, nan))
        split[e.name] = (host + (e.time_range.end - e.time_range.start) / 1e3 / calls, nan)
    return split, nan


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

    # the eval hook reads the first test batch: 4 images at the anchor, the
    # reconstructions' size (on a 512^2 training batch it logs NaN, as JAX)
    trainer = Trainer(cfg, pipe, data, test_dataset=Batches(4, 256, 1, 3), save_dir=tmp)
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
    dms = device_ms(torch, step, reps=2, alike=False)
    log(f"[stage1-breakdown] one micro-step: wall {1e3 * t_wall:.1f} ms, host enqueue "
        f"{1e3 * t_enq:.1f} ms, device {dms:.1f} ms (profiler: kernels' time; the device is idle "
        f"{100 * max(0.0, 1 - dms / (1e3 * t_wall)):.1f}% of the wall time)")
    profile_top(torch, step, "stage1-profile", ("inr_decode", "flash_", "gemm_kernel",
                                                 "nerf_mlp", "group_norm_kernel"),
                inference=False)
    return pipe, trainer, state, 1e3 * steady


def stage1_checkpoint_phase(torch, dev, pipe, trainer, state, tmp, data=None,
                            watch="mlp.torgb.bias", per_step=None, tag="stage1-ckpt"):
    """Save the state after the run (and the breakdown's micro-steps) as
    the trainer saves it, scramble it, restore it and check it bit for bit;
    then a resumed trainer goes on from it for each batch of `data` (2 of
    512^2 images when None) with finite losses and `per_step` launches each
    (none when None)."""
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
    log(f"[{tag}] step {step}: {size / 2**30:.2f} GiB on disk, saved in {t_save:.2f} s, "
        f"restored in {t_restore:.2f} s into a scrambled state: {len(saved)} entries, "
        f"{len(diff)} differ {diff[:3]}")
    if diff or ckpt.latest_step() != step:
        raise AssertionError(f"{tag}: the checkpoint does not restore bit for bit")
    resumed = Trainer(trainer.cfg, pipe, data or Batches(S1_BATCH, S1_RES, 2, 2), save_dir=tmp)
    read = reset_launches()
    rec = StepRecorder(torch, pipe, "stage1_train_step", {"none": state.params[watch]}, read)
    want = {k: (per_step or {}).get(k, 0) for k in KERNELS}
    st = resumed.train_stage1(epochs=1, resume=True, eval_hook=lambda *a: None)
    rows = rec.finish()
    losses = [r["metrics"]["loss"] for r in rows]
    log(f"[{tag}] resumed at {step}, {len(rows)} more micro-steps to step {st.step}: "
        f"losses {[round(v, 3) for v in losses]}, launches "
        f"{[{k: v for k, v in r['launches'].items() if v} for r in rows]}, checkpoints "
        f"{ckpt.all_steps()}")
    more = len(resumed.data.items)
    if not (st.step == step + more and len(rows) == more and all(map(math.isfinite, losses))
            and all(r["launches"] == want for r in rows)):
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
    """configs/d2c-vae/celebahq_gan.yaml: S1_GAN_STEPS (3) micro-steps
    through the trainer, timed, then 3 more from a fresh state that are
    checked: the
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
    for 1 more; finite losses.  After each save the stage-2 eval hook
    samples 2 EMA images (DDIM, then the fused render): no failure logged,
    both images saved, NFE UNet forwards, and its launches exact (attn_block
    once per AttentionBlock call the fused block takes, inr_decode 1, the
    rest 0).  The UNet is cut
    to 2 levels of 64 channels (its 32^2 level keeps flash attention): the
    full 1.01B-parameter UNet's state is 18 GB a checkpoint, and phase 15
    trains it at full width already."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import Trainer, default_stage2_eval_hook
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.nn.unet import AttentionBlock
    from ddmi_tpu_torch.ops import attn_block

    cfg = load_config(os.path.join(ROOT, "configs/ldm/celebahq.yaml"))
    extra = {**cfg.data.extra, "nan_check_every": 1, "prefetch": 0, "steps_per_epoch": 2}
    unet = dataclasses.replace(cfg.model.unetconfig, model_channels=64, channel_mult=(1, 2),
                               num_res_blocks=1, attention_resolutions=(2,))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, extra=extra),
        model=dataclasses.replace(cfg.model, unetconfig=unet))
    s1 = CheckpointManager(tmp, prefix="stage1")
    params = s1.restore()["state"]["params"]
    nfe = cfg.model.ddpmconfig.sampling_timesteps
    read = reset_launches()
    steps, hooks = [], []

    def hook(tr, st, epoch):
        unet = tr.pipe.unet
        forwards, fused = [], []
        handles = [unet.register_forward_hook(lambda *a: forwards.append(1))] + [
            m.register_forward_pre_hook(lambda mod, args: fused.append(attn_block.jax_supported(
                args[0].shape[2] * args[0].shape[3], args[0].shape[1], mod.num_heads)))
            for m in unet.modules() if isinstance(m, AttentionBlock)]
        before = read()
        try:
            default_stage2_eval_hook(tr, st, epoch)
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        launches = {k: v - before[k] for k, v in read().items()}
        want = {k: 0 for k in launches}
        want.update(attn_block=sum(fused), inr_decode=1)
        files = sorted(f for f in os.listdir(os.path.join(tmp, "samples"))
                       if f.startswith(f"ep{epoch}_"))
        hooks.append((len(forwards), launches, want, files))

    for count, resume in ((2, False), (1, True)):
        pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed)
        trainer = Trainer(cfg, pipe, Batches(cfg.data.batch_size, 256, count, 5 + count),
                          save_dir=tmp)
        st = trainer.train_stage2(epochs=1, resume=resume, eval_hook=hook)
        torch.cuda.synchronize()
        same = all(torch.equal(v, params["vae." + k].to(dev, v.dtype))
                   for k, v in pipe.vae.state_dict().items()) and all(
            torch.equal(v, params["mlp." + k].to(dev)) for k, v in pipe.mlp.state_dict().items())
        steps.append((st.step, same))
        del pipe, trainer, st
        torch.cuda.empty_cache()
    recs = [json.loads(line) for line in open(os.path.join(tmp, "train.jsonl"))]
    losses = [r["s2/loss"] for r in recs if "s2/loss" in r]
    failures = [r for r in recs if "s2/eval_hook_failures" in r]
    log(f"[stage2-handoff] stage-1 checkpoint step {s1.latest_step()} -> train_stage2: steps "
        f"{[s for s, _ in steps]}, VAE and INR equal to the checkpoint's (bf16 VAE) "
        f"{[ok for _, ok in steps]}, losses {[round(v, 5) for v in losses]}, stage-2 "
        f"checkpoints {CheckpointManager(tmp, prefix='stage2').all_steps()}")
    for fwd, launches, want, files in hooks:
        log(f"[stage2-handoff] eval hook: 2 EMA images, {fwd} UNet forwards (NFE {nfe}), files "
            f"{files}, launches { {k: v for k, v in launches.items() if v} } (expected "
            f"{ {k: v for k, v in want.items() if v} })")
    log(f"[stage2-handoff] eval hook failures logged: {len(failures)}")
    if not ([s for s, _ in steps] == [2, 3] and all(ok for _, ok in steps)
            and len(losses) == 3 and all(map(math.isfinite, losses))):
        raise AssertionError("the stage-1 -> stage-2 hand-off or the stage-2 resume failed")
    if failures or len(hooks) != 2 or not all(
            fwd == nfe and launches == want and len(files) == 2
            for fwd, launches, want, files in hooks):
        raise AssertionError("the image stage-2 eval hook did not sample through the kernels")


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


def video_train_config(path, **extra):
    """A video config checked to train as the skytimelapse configs do (amp,
    batch 2 of 16 x 256^2 clips), with `extra` merged into data.extra."""
    from ddmi_tpu_torch.core.config import load_config

    cfg = load_config(os.path.join(ROOT, path))
    m, d = cfg.model, cfg.data
    if not (m.amp and d.batch_size == V_BATCH and d.frames == 16 and d.domain == "video"
            and m.ddconfig.resolution == 256):
        raise AssertionError(f"{path} no longer trains 2 clips of 16 x 256^2 with amp")
    return dataclasses.replace(cfg, data=dataclasses.replace(d, extra={**d.extra, **extra}))


class Clips:
    """`count` batches of SyntheticVideos (2 clips of 16 x 256^2), made up
    front, without a length (the trainer then reads
    data.extra.steps_per_epoch)."""

    def __init__(self, count, seed):
        from ddmi_tpu_torch.data.video import SyntheticVideos

        self.items = list(SyntheticVideos(V_BATCH, 16, 256, length=count, seed=seed))

    def __iter__(self):
        return iter(self.items)


class ShapeRecorder:
    """Inside the block, the calls of the flash forward by operand shape (B,
    nh, n, hd) and whether they keep the LSE (under autograd).  It wraps
    flash_attention_fwd, whose caller counts launches on its own name, so
    the launch counters run on."""

    def __init__(self, torch):
        from ddmi_tpu_torch.ops import flash_attention

        self.mod = flash_attention
        self.shapes = collections.Counter()

    def __enter__(self):
        fn = self.fn = self.mod.flash_attention_fwd

        def call(q, k, v, sm_scale, with_lse):
            self.shapes[(tuple(q.shape), bool(with_lse))] += 1
            return fn(q, k, v, sm_scale, with_lse)

        self.mod.flash_attention_fwd = call
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention_fwd = self.fn


def video_stage1_phase(torch, dev, tmp):
    """Trainer.train_stage1 on configs/d2c-vae/skytimelapse.yaml at full
    width (seeded weights, zero-init layers perturbed, LPIPS on a random
    VGG16): 10 micro-steps of 2 synthetic clips of 16 x 256^2, checked (the
    launch counters of each micro-step, finite losses, the parameters
    bit-unchanged through micro-step 9 and all changed at 10, the SN state
    changed at every one, the flash shapes recorded), with the eval hook
    (PSNR of 2 reconstructed clips) after the epoch's checkpoint; then a
    separate timed run, a split by the stage1/* ranges, the idle share and
    a profile.  -> (pipe, trainer, state, ms per micro-step, flash shapes
    {shape: calls per micro-step})."""
    from ddmi_tpu_torch.core.trainer import Trainer, default_stage1_eval_hook
    from ddmi_tpu_torch.domains.video import VideoPipeline
    from ddmi_tpu_torch.evals.lpips import build_perceptual

    cfg = video_train_config("configs/d2c-vae/skytimelapse.yaml", nan_check_every=5,
                             prefetch=2, steps_per_epoch=V1_STEPS)
    lc = cfg.model.lossconfig
    if not (lc.gradient_accumulate_every == 5 and lc.sn_reg and lc.lr_scheduler):
        raise AssertionError("skytimelapse.yaml no longer accumulates over 5 with the SN "
                             "regulariser and the warm-up schedule")
    t0 = time.perf_counter()
    pipe = VideoPipeline(cfg, device=dev, seed=cfg.seed, perceptual=build_perceptual(cfg, dev))
    for i, module in enumerate((pipe.vae, pipe.mlp)):
        perturb_zero_init(module, 90 + i)
    n_enc = sum(p.numel() for k, p in pipe.vae.named_parameters() if not k.startswith(
        ("decoder.", "post_")))
    n_vae = sum(p.numel() for p in pipe.vae.parameters())
    n_mlp = sum(p.numel() for p in pipe.mlp.parameters())
    log(f"[v-stage1] skytimelapse stage 1 at full width: VAE {n_vae} parameters ({n_enc} in "
        f"the encode half: TimeSformer depth 8, width {cfg.model.ddconfig.timesformer_channels}) "
        f"+ INR {n_mlp} (fp32 masters, bf16 compute), LPIPS VGG16 random and frozen; set up in "
        f"{time.perf_counter() - t0:.1f} s; cuts: {V1_STEPS} micro-steps instead of 200 epochs, "
        f"synthetic clips, random-init VAE, INR and VGG (no weight files in the repository)")
    data = Clips(V1_STEPS, 0)
    trainer = Trainer(cfg, pipe, data, save_dir=tmp)
    read = reset_launches()
    hook_launches, psnr_seen = {}, []

    def hook(tr, st, epoch):
        before = read()
        default_stage1_eval_hook(tr, st, epoch)
        torch.cuda.synchronize()
        hook_launches.update({k: v - before[k] for k, v in read().items()})

    watch = pipe.stage1_params()
    rec = StepRecorder(torch, pipe, "stage1_train_step", watch, read)
    torch.cuda.reset_peak_memory_stats(dev)
    with ShapeRecorder(torch) as shapes:
        state = trainer.train_stage1(epochs=1, eval_hook=hook)
    rows = rec.finish()
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = {k: V1_LAUNCHES[k] // V1_STEPS for k in V1_LAUNCHES}
    bad = [(i, r["launches"]) for i, r in enumerate(rows, 1)
           if r["launches"] != {k: per_step.get(k, 0) for k in r["launches"]}]
    for r in rows:
        r["launches"] = {}
    check_stage1_rows(rows, "v-stage1", len(watch))
    m = rows[-1]["metrics"]
    train_shapes = {s: c // V1_STEPS for (s, g), c in shapes.shapes.items() if g}
    log(f"[v-stage1] {len(rows)} micro-steps, losses "
        f"{[round(r['metrics']['loss'], 2) for r in rows]}; last: " + ", ".join(
            f"{k} {v:.5g}" for k, v in m.items())
        + f"; parameters changed at {[i for i, r in enumerate(rows, 1) if any(r['params'])]} "
        f"({len(watch)} tensors at 10), SN state changed at every micro-step; launches per "
        f"micro-step {per_step} (the others 0) at every one: {not bad}; flash calls by shape "
        f"(shape, under autograd): {dict(shapes.shapes)}; peak allocated {peak / 2**30:.2f} GiB "
        f"(the checked run)")
    if bad:
        raise AssertionError(f"v-stage1: launch counts off at {bad[:3]}")
    if sum(train_shapes.values()) != per_step["flash_attention"]:
        raise AssertionError(f"v-stage1: flash calls under autograd {train_shapes}")
    recs = [json.loads(line) for line in open(os.path.join(tmp, "train.jsonl"))]
    psnr = [r["eval/psnr"] for r in recs if "eval/psnr" in r]
    failures = [r for r in recs if "s1/eval_hook_failures" in r]
    log(f"[v-stage1] eval hook: PSNR {psnr} dB over 2 reconstructed clips, launches "
        f"{ {k: v for k, v in hook_launches.items() if v} }, failures {len(failures)}")
    if not (len(psnr) == 1 and math.isfinite(psnr[0]) and not failures
            and {k: v for k, v in hook_launches.items() if v} == V_RECON_LAUNCHES):
        raise AssertionError("the video stage-1 eval hook did not reconstruct through flash "
                             "and log PSNR")

    timed_dir = os.path.join(tmp, "timed")
    torch.cuda.reset_peak_memory_stats(dev)
    timer = StepTimer(torch, pipe, "stage1_train_step", V1_TIMED)
    timed_cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, extra={**cfg.data.extra, "steps_per_epoch": V1_TIMED}))
    t0 = time.perf_counter()
    Trainer(timed_cfg, pipe, Clips(V1_TIMED, 1), save_dir=timed_dir).train_stage1(
        epochs=1, eval_hook=lambda *a: None)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    steady = timer.finish()
    peak = torch.cuda.max_memory_allocated(dev)
    shutil.rmtree(timed_dir)
    log(f"[v-stage1] timed run: {V1_TIMED} micro-steps and a checkpoint in {t_run:.3f} s; "
        f"steady over micro-steps 2-{V1_TIMED} "
        f"{1 / steady:.4f} micro-steps/s = {V_BATCH / steady:.4f} training clips/s "
        f"({1e3 * steady:.1f} ms per micro-step) on {nvidia_smi()}; peak allocated "
        f"{peak / 2**30:.2f} GiB")

    gen = torch.Generator(device=dev).manual_seed(95)
    x = torch.from_numpy(Clips(1, 2).items[0]).to(dev)
    step = lambda: pipe.stage1_train_step(state, x, generator=gen)
    split, dev_total = range_split(torch, step, "stage1/", top=(
        "v-stage1-profile", ("flash_fwd_kernel", "flash_bwd_")))
    stages = ("encode", "decode", "inr", "lpips", "sn", "backward", "optimizer")
    missing = [k for k in stages if "stage1/" + k not in split]
    log("[v-stage1-breakdown] one micro-step (after a warm-up one) by the profiler's stage1/* "
        "ranges: " + "; ".join(f"{k} {split['stage1/' + k][1]:.2f} ms device / "
                               f"{split['stage1/' + k][0]:.2f} ms host"
                               for k in stages if k not in missing)
        + f"; outside the ranges {dev_total - sum(d for _, d in split.values()):.2f} ms device; "
        f"all kernels {dev_total:.2f} ms (host times under the profiler)")
    if missing:
        raise AssertionError(f"the video micro-step's profile has no range for {missing}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    # the split's profile is padded against lost records
    dms = dev_total
    log(f"[v-stage1-breakdown] one micro-step: wall {1e3 * t_wall:.1f} ms, host enqueue "
        f"{1e3 * t_enq:.1f} ms, device {dms:.1f} ms (profiler: kernels' time; the device is idle "
        f"{100 * max(0.0, 1 - dms / (1e3 * t_wall)):.1f}% of the wall time)")
    return pipe, trainer, state, 1e3 * steady, train_shapes


def video_reconstruct_phase(torch, dev, pipe):
    """reconstruct of 2 clips: the decoder's two long attentions through the
    flash kernel (2 launches, nothing else), pixels finite in [0, 1], the
    PSNR; -> launches."""
    x = torch.from_numpy(Clips(1, 3).items[0]).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    read = reset_launches()
    with ShapeRecorder(torch) as shapes:
        out = pipe.reconstruct(x, generator=g)
        torch.cuda.synchronize()
    n = read()
    ms = cuda_ms(lambda: pipe.reconstruct(x, generator=g), 2)
    psnr = -10 * math.log10(max(((out - x) ** 2).mean().item(), 1e-12))
    ok = bool(torch.isfinite(out).all()) and 0 <= out.min().item() and out.max().item() <= 1
    log(f"[v-reconstruct] 2 clips of 16 x 256^2: launches { {k: v for k, v in n.items() if v} } "
        f"at {dict(shapes.shapes)}, pixels in [{out.min().item():.4f}, {out.max().item():.4f}], "
        f"PSNR {psnr:.2f} dB (random weights after 10 micro-steps), {ms:.1f} ms per call")
    if not (ok and {k: v for k, v in n.items() if v} == V_RECON_LAUNCHES):
        raise AssertionError(f"video reconstruct: launches {n}, pixels ok {ok}")
    return n


def video_stage1_gan_phase(torch, dev, tmp, plain_ms):
    """configs/d2c-vae/skytimelapse_gan.yaml: 2 micro-steps timed, then
    V1_GAN_STEPS (2) from a fresh state checked: the 2D and 3D discriminators change at
    every micro-step, the VAE and INR at none (the first window's update
    has rate 0), finite losses, flash launches as the plain config's."""
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.domains.video import VideoPipeline
    from ddmi_tpu_torch.evals.lpips import build_perceptual

    cfg = video_train_config("configs/d2c-vae/skytimelapse_gan.yaml", nan_check_every=5,
                             prefetch=2, steps_per_epoch=V1_STEPS)
    if not cfg.model.lossconfig.adversarial:
        raise AssertionError("skytimelapse_gan.yaml is not adversarial")
    pipe = VideoPipeline(cfg, device=dev, seed=cfg.seed, perceptual=build_perceptual(cfg, dev))
    for i, module in enumerate((pipe.vae, pipe.mlp, pipe.gan)):
        perturb_zero_init(module, 96 + i)
    timed_dir = os.path.join(tmp, "timed")
    timer = StepTimer(torch, pipe, "stage1_train_step", 2)
    Trainer(cfg, pipe, Clips(2, 4), save_dir=timed_dir).train_stage1(
        epochs=1, eval_hook=lambda *a: None)
    steady = timer.finish()
    shutil.rmtree(timed_dir)
    trainer = Trainer(cfg, pipe, Clips(V1_GAN_STEPS, 5), save_dir=tmp)
    watch = pipe.stage1_params()
    read = reset_launches()
    rec = StepRecorder(torch, pipe, "stage1_train_step", watch, read)
    state = trainer.train_stage1(epochs=1, eval_hook=lambda *a: None)
    rows = rec.finish()
    bad = [r["launches"] for r in rows if r["launches"] != {
        k: V1_LAUNCHES.get(k, 0) // V1_STEPS for k in r["launches"]}]
    for r in rows:
        r["launches"] = {}
    check_stage1_rows(rows, "v-stage1-gan", len(watch))
    disc_ok = all(all(r["disc"]) for r in rows)
    n3d = sum(1 for k in state.disc if k.startswith("disc3d."))
    log(f"[v-stage1-gan] {len(rows)} micro-steps: d_loss "
        f"{[round(r['metrics']['d_loss'], 4) for r in rows]}, g_gan "
        f"{[round(r['metrics']['g_gan'], 4) for r in rows]}; the discriminators' "
        f"{len(state.disc)} tensors ({n3d} of the 3D one) changed at every micro-step {disc_ok}; "
        f"VAE and INR unchanged; flash launches as the plain run's {not bad}; steady "
        f"{1e3 * steady:.1f} ms per micro-step (micro-step 2), {1e3 * steady - plain_ms:.1f} "
        f"ms more than the plain run's ({plain_ms:.1f} ms) on {nvidia_smi()}")
    if not disc_ok or bad:
        raise AssertionError(f"video GAN: discriminators changed {disc_ok}, launches {bad[:2]}")


def cut_state_checkpoint(torch, dev, cfg, tmp):
    """The video stage-2 state saved as the trainer saves it, restored bit
    for bit into a scrambled one and resumed for a micro-step, at a cut
    TriplaneUNet (channel_mult (1, 2), one res block a level: the
    full-width state is 10 GB a checkpoint, which the call's write budget
    leaves no room for): one micro-step trained, the checkpoint, then the
    resumed micro-step's loss finite and its flash forward and backward
    launches equal (the inference kernels 0)."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.domains.video import VideoPipeline

    unet = dataclasses.replace(cfg.model.unetconfig, channel_mult=(1, 2), num_res_blocks=1)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, unetconfig=unet),
        data=dataclasses.replace(cfg.data, extra={**cfg.data.extra, "steps_per_epoch": 1}))
    pipe = VideoPipeline(cfg, device=dev, seed=cfg.seed)
    perturb_zero_init(pipe.unet, 97)
    state = Trainer(cfg, pipe, Clips(1, 9), save_dir=tmp).train_stage2(epochs=1, save=False)
    ckpt = CheckpointManager(tmp, prefix="stage2")
    step = state.step
    gen = torch.Generator(device=dev).manual_seed(99)
    t0 = time.perf_counter()
    ckpt.save(step, {"state": state.state_dict(), "generators": [gen.get_state()]})
    t_save = time.perf_counter() - t0
    saved = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in flat_state(state.state_dict()).items()}
    size = os.path.getsize(os.path.join(ckpt.root, f"{step}.pt"))
    with torch.no_grad():
        for t in list(state.params.values()) + list(state.ema.values()) + state.opt.mu:
            t.add_(1.0)
    state.step, state.opt.count = -1, -1

    class Wrap:
        def load_state_dict(self, sd):
            state.load_state_dict(sd["state"])

    t0 = time.perf_counter()
    ckpt.restore(Wrap())
    t_restore = time.perf_counter() - t0
    now = flat_state(state.state_dict())
    diff = [k for k in saved if not (torch.equal(saved[k], now[k]) if torch.is_tensor(saved[k])
                                      else saved[k] == now[k])]
    del saved, now
    losses, step_fn = [], pipe.stage2_train_step

    def recording(st, x, **kw):
        out = step_fn(st, x, **kw)
        losses.append(float(out[1]["loss"]))
        return out

    pipe.stage2_train_step = recording
    read = reset_launches()
    resumed = Trainer(cfg, pipe, Clips(1, 10), save_dir=tmp).train_stage2(epochs=1, resume=True,
                                                                           save=False)
    launches = read()
    del pipe.stage2_train_step
    n = sum(p.numel() for p in pipe.unet.parameters())
    log(f"[v-stage2-ckpt] cut TriplaneUNet ({n} parameters) at step {step}: {size / 2**30:.3f} "
        f"GiB on disk, saved in {t_save:.2f} s, restored in {t_restore:.2f} s into a scrambled "
        f"state: {len(diff)} entries differ {diff[:3]}; resumed to step {resumed.step}, loss "
        f"{losses}, launches { {k: v for k, v in launches.items() if v} }")
    flash = launches["flash_attention"]
    if (diff or resumed.step != step + 1 or len(losses) != 1 or not math.isfinite(losses[0])
            or not flash or launches != {k: flash if k.startswith("flash") else 0
                                         for k in launches}):
        raise AssertionError("the video stage-2 checkpoint does not restore bit for bit and resume")


def video_stage2_phase(torch, dev, tmp):
    """Trainer.train_stage2 on configs/ldm/skytimelapse.yaml at full width
    (the UNet seeded, zero-init layers perturbed) with the VAE and INR of
    the stage-1 checkpoint in `tmp`: 6 micro-steps of 2 clips, saving no
    checkpoint of their own; the flash counts per micro-step against the
    calls recorded in the run, finite losses, the parameters changing at
    every micro-step and the EMA at the schedule's (every 5th from 0, a
    copy before step 100); then `cut_state_checkpoint`; a timed run, a
    micro-step split and the stage-2 eval hook's video sample.  -> (launches of the checked run, flash shapes {shape: calls
    per micro-step})."""
    from ddmi_tpu_torch.core.amp import amp_denoiser
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import Trainer, default_stage2_eval_hook
    from ddmi_tpu_torch.diffusion.process import diffusion_loss
    from ddmi_tpu_torch.domains.video import VideoPipeline

    cfg = video_train_config("configs/ldm/skytimelapse.yaml", nan_check_every=5, prefetch=2,
                             steps_per_epoch=V2_STEPS)
    s1 = load_config(os.path.join(ROOT, "configs/d2c-vae/skytimelapse.yaml"))
    if cfg.model.ddconfig != s1.model.ddconfig or cfg.model.mlpconfig != s1.model.mlpconfig:
        raise AssertionError("the ldm and d2c-vae skytimelapse configs no longer share a VAE")
    lc = cfg.model.lossconfig
    if not (lc.gradient_accumulate_every == 1 and lc.ema_update_every == 5):
        raise AssertionError("configs/ldm/skytimelapse.yaml no longer steps every micro-step "
                             "with EMA every 5")
    pipe = VideoPipeline(cfg, device=dev, seed=cfg.seed)
    perturb_zero_init(pipe.unet, 97)
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    trainer = Trainer(cfg, pipe, Clips(V2_STEPS, 6), save_dir=tmp)
    read = reset_launches()
    rows, step_fn = [], pipe.stage2_train_step
    watch = ["unet.input_blocks.0.0.weight", "unet.mid_attn.q.weight", "unet.out.2.weight",
             "mixing_logit"]

    def recording(state, x, **kw):
        with torch.no_grad():
            p0 = torch._foreach_mul([state.params[k] for k in watch], 1.0)
            e0 = torch._foreach_mul(list(state.ema.values()), 1.0)
        before = read()
        out = step_fn(state, x, **kw)
        after = read()
        with torch.no_grad():
            dp = torch.stack(torch._foreach_norm(torch._foreach_sub(
                [state.params[k] for k in watch], p0)))
            de = torch.stack(torch._foreach_norm(torch._foreach_sub(
                list(state.ema.values()), e0)))
            same = all(torch.equal(e, p) for e, p in zip(state.ema.values(),
                                                         state.params.values()))
        rows.append((dp > 0, de > 0, same, out[1]["loss"],
                     {k: after[k] - before[k] for k in after}))
        return out

    pipe.stage2_train_step = recording
    torch.cuda.reset_peak_memory_stats(dev)
    with ShapeRecorder(torch) as shapes:
        state = trainer.train_stage2(epochs=1, save=False)
    torch.cuda.synchronize()
    del pipe.stage2_train_step
    peak = torch.cuda.max_memory_allocated(dev)
    train_shapes = {s: c // V2_STEPS for (s, g), c in shapes.shapes.items() if g}
    per_step = sum(train_shapes.values())
    expect = {k: (per_step if k in ("flash_attention", "flash_attention_bwd") else 0)
              for k in KERNELS}
    n = len(state.params)
    checks = []
    for i, (dp, de, same, loss, launches) in enumerate(rows, 1):
        ema_step = (i - 1) % lc.ema_update_every == 0
        checks.append(bool(dp.all()) and (bool(de.any()) == ema_step)
                      and (not ema_step or same) and math.isfinite(float(loss))
                      and launches == expect)
    log(f"[v-stage2] skytimelapse stage 2 at full width: TriplaneUNet {n_unet} parameters "
        f"(fp32 masters, bf16 compute) on the stage-1 checkpoint's VAE and INR; "
        f"{len(rows)} micro-steps, losses {[round(float(r[3]), 5) for r in rows]}; the watched "
        f"{watch} changed at {[i for i, r in enumerate(rows, 1) if r[0].all()]}; the "
        f"EMA ({n} tensors) changed at {[i for i, r in enumerate(rows, 1) if r[1].any()]} "
        f"(a copy of the parameters there); flash calls by shape (shape, under autograd): "
        f"{dict(shapes.shapes)}; launches per micro-step {rows[0][4]} (expected {expect}); "
        f"every check per micro-step {checks}; peak allocated {peak / 2**30:.2f} GiB")
    if len(rows) != V2_STEPS or not all(checks):
        raise AssertionError("the video stage-2 run failed its checks")

    cut_state_checkpoint(torch, dev, cfg, os.path.join(tmp, "cut"))

    timer = StepTimer(torch, pipe, "stage2_train_step", V2_STEPS)
    t0 = time.perf_counter()
    Trainer(cfg, pipe, Clips(V2_STEPS, 7), save_dir=os.path.join(tmp, "timed")).train_stage2(
        epochs=1, save=False)
    torch.cuda.synchronize()
    steady = timer.finish()
    log(f"[v-stage2] timed run: {V2_STEPS} micro-steps in {time.perf_counter() - t0:.3f} s (the "
        f"stage-1 checkpoint's load included); steady {1 / steady:.4f} micro-steps/s = "
        f"{V_BATCH / steady:.4f} training clips/s ({1e3 * steady:.1f} ms per micro-step) on "
        f"{nvidia_smi()}")

    g = torch.Generator(device=dev).manual_seed(98)
    x = torch.from_numpy(Clips(1, 8).items[0]).to(dev)
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
    log("[v-stage2-breakdown] one micro-step (host clock with sync, 5 in a row, one an EMA "
        "update): " + "; ".join(f"{k} {sum(v) / len(v):.3f} ms mean "
                                f"({', '.join(f'{t:.1f}' for t in v)})" for k, v in split.items()))
    profile_top(torch, lambda: pipe.stage2_train_step(state, x, generator=g), "v-stage2-profile",
                ("flash_fwd_kernel", "flash_bwd_"), inference=False)

    # the hook samples at NFE V2_HOOK_NFE (the config's 200 is phase 6's)
    pipe.gd = dataclasses.replace(pipe.gd, sampling_timesteps=V2_HOOK_NFE)
    before = read()
    t0 = time.perf_counter()
    default_stage2_eval_hook(trainer, state, 0)
    torch.cuda.synchronize()
    hook = {k: v - before[k] for k, v in read().items()}
    files = sorted(f for f in os.listdir(os.path.join(tmp, "samples")) if f.startswith("ep0_video"))
    recs = [json.loads(line) for line in open(os.path.join(tmp, "train.jsonl"))]
    failures = [r for r in recs if "s2/eval_hook_failures" in r]
    want = {k: v // VIDEO_NFE * V2_HOOK_NFE + (2 if k == "flash_attention" else 0)
            for k, v in VIDEO_LAUNCHES.items()}
    log(f"[v-stage2] eval hook: one EMA video sample (NFE {V2_HOOK_NFE}) in "
        f"{time.perf_counter() - t0:.1f} s, {len(files)} frame files {files[:3]}, launches "
        f"{ {k: v for k, v in hook.items() if v} } (expected {want}), failures {len(failures)}")
    if failures or len(files) != 16 or {k: v for k, v in hook.items() if v} != want:
        raise AssertionError("the stage-2 eval hook did not sample a video through the kernels")
    return {k: V2_STEPS * v for k, v in expect.items()}, train_shapes


def video_train_kernel_phase(torch, dev, shapes):
    """The flash forward (with LSE) and backward against flash_plain /
    flash_bwd_plain at every shape the video training path called them at
    ({(B, nh, n, hd): (path, calls per micro-step)}), each timed beside the
    plain versions, SDPA's forward and backward, and the bound; then the
    hd-128 dk/dv instance's registers and spills from the build report."""
    import re

    import torch.nn.functional as F

    from ddmi_tpu_torch.ops import build
    from ddmi_tpu_torch.ops import flash_attention as fa

    for i, ((B, nh, n, hd), (path, calls)) in enumerate(sorted(shapes.items())):
        g = torch.Generator(device=dev).manual_seed(700 + i)
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
        for a, r in [(out, ref_out)] + list(zip(got, ref)):
            a, r = a.float(), r.float()
            err = (a - r).abs().max().item()
            corr = torch.corrcoef(torch.stack([a.flatten(), r.flatten()]))[0, 1].item()
            stats.append((err, err / r.abs().max().item(), corr))
        del got, ref, ref_out
        fwd = lambda: fa.flash_attention_fwd(q, k, v, s, with_lse=True)
        fwd_plain = lambda: fa.flash_plain(q, k, v, s, with_lse=True)
        fms, fpms = paired_ms(fwd, fwd_plain, 3)
        flms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=s), 3)
        bwd = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, s)
        bwd_plain = lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, s)
        bms_k, bpms = paired_ms(bwd, bwd_plain, 3)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o2 = F.scaled_dot_product_attention(*leaves, scale=s)
        blms = cuda_ms(lambda: torch.autograd.grad(o2, leaves, do, retain_graph=True), 3)
        fflops, fbytes = 4 * B * nh * n * n * hd, 4 * q.numel() * 2 + lse.numel() * 4
        bflops, bbytes = 10 * B * nh * n * n * hd, 8 * q.numel() * 2 + 2 * lse.numel() * 4
        fb, fby = bound(fflops, fbytes)
        bb, bby = bound(bflops, bbytes)
        log(f"[v-train-kernel] {path} B={B} heads={nh} n={n} hd={hd} ({calls} per micro-step): "
            + ", ".join(f"{c} max|err| {e:.6f} (/max|ref| {r:.5f}) corr {c2:.6f}"
                        for c, (e, r, c2) in zip(("out", "dq", "dk", "dv"), stats))
            + f"; LSE max|err| {lse_err:.2e}; forward with LSE {fms:.4f} ms (plain fp32 "
            f"{fpms:.4f}, library sdpa {flms:.4f}, bound {fb:.4f} ms {fby}); backward "
            f"{bms_k:.4f} ms (plain fp32 {bpms:.4f}, library sdpa backward {blms:.4f}, bound "
            f"{bb:.4f} ms {bby}) on {nvidia_smi()}")
        if not all(r <= FLASH_BWD_REL_ERR and c2 >= FLASH_BWD_MIN_CORR for _, r, c2 in stats):
            raise AssertionError(f"flash disagrees at the video shape {(B, nh, n, hd)}: {stats}")
        if not lse_err <= LSE_MAX_ERR:
            raise AssertionError(f"flash LSE off by {lse_err} at {(B, nh, n, hd)}")
        n10 = calls * V1_STEPS
        LEDGER.add("flash_attention", path, n10, fms, fpms, flms, fflops, fbytes, stats[0][0])
        LEDGER.add("flash_attention_bwd", path, n10, bms_k, bpms, blms, bflops, bbytes,
                   max(e for e, _, _ in stats[1:]))
        del q, k, v, do, out, lse, leaves, o2
        torch.cuda.empty_cache()
    info = build.BUILD_LOG.get("flash")
    if info is None:
        log("[v-train-kernel] hd-128 dk/dv instance: the flash library was built before this "
            "run, so its ptxas report is not here")
        return
    lines, found = info["ptxas"], None
    for j, line in enumerate(lines):
        if re.search(r"flash_bwd_dkv_kernelILi128E", line):
            found = j
    if found is None:
        raise AssertionError("no ptxas report for the hd-128 dk/dv instance")
    report = [ln.strip() for ln in lines[found + 1 : found + 4]
              if "spill" in ln or "registers" in ln]
    log(f"[v-train-kernel] hd-128 dk/dv instance (flash_bwd_dkv_kernel<128>), ptxas: "
        + "; ".join(report))


def video_small_config(amp):
    """A small video config whose decoder takes the flash route under
    autograd at its 16^2 and 64^2 levels (n = 512 at hd 128, n = 5,120 at
    hd 64; the others take the MEA): resolution 64, 8 frames, ch 64."""
    from ddmi_tpu_torch.core.config import config_from_dict

    return config_from_dict({"seed": 3, "model": {
        "amp": amp, "use_fp16": amp, "lr": 1e-3, "embed_dim": 4, "params": {
            "lossconfig": dict(gradient_accumulate_every=5, epochs=2, warmup_epochs=1),
            "ddconfig": dict(double_z=True, timesformer_channels=64, splits=1, patch_size=8,
                             resolution=64, z_channels=8, in_channels=3, out_ch=8, ch=64,
                             ch_mult=[1, 1, 2, 2], num_res_blocks=1, attn_resolutions=[],
                             hdbf_resolutions=[16, 32], inter_attn_resolutions=[8, 16, 32, 64],
                             attn_type="vanilla-multihead"),
            "mlpconfig": dict(in_ch=2, out_ch=3, ch=64, latent_dim=8),
            "unetconfig": dict(triplane=True, in_channels=4, model_channels=64, out_channels=4,
                               attention_resolutions=[1, 2], num_res_blocks=1,
                               channel_mult=[1, 2], num_head_channels=32),
            "ddpmconfig": dict(image_size=8, channels=4)}},
        "data": {"domain": "video", "batch_size": 1, "frames": 8}})


def video_reference_train_phase(torch, dev):
    """One stage-1 micro-step's loss and gradients, then one stage-2
    micro-step's, at a small config: bf16 on the card against fp32 plain
    versions on the CPU, on the same weights, SN vectors and draws (loss
    within 2%, each stage-1 term (recon, KL, LPIPS, SN) within 5%, gradient
    cosines in float64 >= 0.999).  The decoder's 16^2 and 64^2
    cross-plane attentions go through the flash forward and backward; at
    this size the TriplaneUNet's attentions (n = 192) are below the flash
    tier.  The pre_* moments layers are scaled by 0.1 so that the
    posterior's logvar stays near 0, as after training: at the random init
    it reaches +-11, where one bf16 rounding of it moves the std by up to 3%."""
    import numpy as np

    from ddmi_tpu_torch.domains.video import VideoDraws, VideoPipeline
    from ddmi_tpu_torch.evals.lpips import LPIPS

    torch.manual_seed(0)
    vgg = LPIPS().state_dict()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((1, 8, 64, 64, 3)).astype(np.float32))
    eps = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((1, 4, 8, 8), (1, 4, 8, 8), (1, 4, 8, 8))]
    t = torch.tensor([417])
    noise = torch.from_numpy(rng.standard_normal((1, 64 + 2 * 8 * 8, 4)).astype(np.float32))
    out, weights, sn = {}, None, None
    read = reset_launches()
    launches = {}
    for tag, where, amp in (("cpu", "cpu", False), ("card", dev, True)):
        lp = LPIPS(torch.bfloat16 if amp else torch.float32)
        lp.load_state_dict(vgg)
        pipe = VideoPipeline(video_small_config(amp), device=where, seed=3,
                             perceptual=lp.to(where))
        if weights is None:
            perturb_zero_init(pipe, 81)
            with torch.no_grad():
                for plane in ("xy", "xt", "yt"):
                    for p in getattr(pipe.vae, f"pre_{plane}").parameters():
                        p.mul_(0.1)
            weights = {k: v.clone() for k, v in pipe.state_dict().items()}
        else:
            pipe.load_state_dict({k: v.to(where) for k, v in weights.items()})
        st = pipe.init_stage1(10)
        if sn is None:
            sn = st.sn
        else:
            st.sn = {k: (u.to(where), v.to(where)) for k, (u, v) in sn.items()}
        draws = VideoDraws(tuple(e.to(where) for e in eps), torch.tensor([5]).to(where))
        before = read()
        loss, m, _, _ = pipe.stage1_loss(x.to(where), 3, draws, st.sn)
        loss.backward()
        g1 = torch.cat([p.grad.float().cpu().flatten() for p in st.params.values()])
        pipe.vae.zero_grad(set_to_none=True)
        pipe.mlp.zero_grad(set_to_none=True)
        st2 = pipe.init_stage2()
        loss2, _ = pipe.stage2_loss(x.to(where), t=t.to(where), noise=noise.to(where),
                                    eps=[e.to(where) for e in eps])
        loss2.backward()
        g2 = torch.cat([p.grad.float().cpu().flatten() for p in st2.params.values()])
        if where != "cpu":
            torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in read().items()}
        out[tag] = (loss.item(), {k: float(v) for k, v in m.items()}, g1, loss2.item(), g2)
        del pipe
    (l1c, mc, g1c, l2c, g2c), (l1g, mg, g1g, l2g, g2g) = out["cpu"], out["card"]
    cos1 = torch.nn.functional.cosine_similarity(g1g.double(), g1c.double(), dim=0).item()
    cos2 = torch.nn.functional.cosine_similarity(g2g.double(), g2c.double(), dim=0).item()
    rel1, rel2 = abs(l1g - l1c) / abs(l1c), abs(l2g - l2c) / abs(l2c)
    terms = {k: abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("recon", "kl", "lpips", "sn")}
    log(f"[v-reference] small config (64^2, 8 frames), one micro-step each: stage 1 bf16 on the "
        f"card loss {l1g:.5f} vs fp32 on the CPU {l1c:.5f} (relative {rel1:.5f}; terms "
        + ", ".join(f"{k} {mg[k]:.5g} vs {mc[k]:.5g} (relative {v:.5f})"
                    for k, v in terms.items())
        + f"), gradient cosine {cos1:.6f}; stage 2 loss {l2g:.6f} vs {l2c:.6f} (relative "
        f"{rel2:.5f}), gradient cosine {cos2:.6f}; launches on the card "
        f"{ {k: v for k, v in launches.items() if v} }")
    if not (launches.get("flash_attention", 0) >= 1
            and launches.get("flash_attention_bwd", 0) >= 1):
        raise AssertionError(f"the video reference missed the flash kernels: {launches}")
    if not (rel1 <= S1_REF_LOSS_REL and cos1 >= S1_REF_MIN_COS and rel2 <= TRAIN_REF_LOSS_REL
            and cos2 >= TRAIN_REF_MIN_COS and all(v <= S1_REF_TERM_REL for v in terms.values())):
        raise AssertionError("the GPU video train steps disagree with the CPU reference")


def threed_config(path, **extra):
    """A 3D config (configs/{d2c-vae,ldm}/{srn_cars,shapenet}.yaml) with its
    data.conv_config made absolute and `extra` merged into data.extra."""
    from ddmi_tpu_torch.core.config import load_config

    cfg = load_config(os.path.join(ROOT, path))
    d = cfg.data
    d = dataclasses.replace(d, conv_config=os.path.join(ROOT, d.conv_config),
                            extra={**d.extra, **extra})
    return dataclasses.replace(cfg, data=d)


class Items:
    """Batches made up front by a synthetic loader, without a length (the
    trainer then reads data.extra.steps_per_epoch)."""

    def __init__(self, loader):
        self.items = list(loader)

    def __iter__(self):
        return iter(self.items)


def nerf_data(count, seed):
    """`count` srn_cars-shaped batches: 1 scene, a 3000 x 6 cloud, one
    128^2 view and its pose."""
    from ddmi_tpu_torch.data.nerf import SyntheticNeRF

    return Items(SyntheticNeRF(1, 3000, 128, length=count, seed=seed))


def occ_data(count, seed):
    """`count` shapenet-shaped batches: 12 shapes, 3000-point clouds, 2048
    query points with their occupancies."""
    from ddmi_tpu_torch.data.shapenet import SyntheticOccupancy

    return Items(SyntheticOccupancy(O_BATCH, 2048, 3000, length=count, seed=seed))


def on_device(torch, batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def threed_stage1_phase(torch, dev, tmp, tag, cfg, pipe, data_fn, steps, timed, per_step,
                        stages):
    """Trainer.train_stage1 at full width: `steps` micro-steps checked
    (check_stage1_rows: the parameters move at the last, every launch
    counter 0, the SN state changed at every one), the default eval hook
    after the epoch's checkpoint; then a separate timed run of `timed`
    micro-steps (micro-steps/s, `per_step` samples per micro-step, peak
    memory), a split by the stage1/* ranges, host against device time and
    a profile.  -> (trainer, state, ms per micro-step, records of the
    checked run)."""
    from ddmi_tpu_torch.core.trainer import Trainer

    trainer = Trainer(cfg, pipe, data_fn(steps, 0), save_dir=tmp)
    read = reset_launches()
    watch = pipe.stage1_params()
    rec = StepRecorder(torch, pipe, "stage1_train_step", watch, read)
    torch.cuda.reset_peak_memory_stats(dev)
    state = trainer.train_stage1(epochs=1)
    torch.cuda.synchronize()
    rows = rec.finish()
    peak = torch.cuda.max_memory_allocated(dev)
    check_stage1_rows(rows, tag, len(watch), move_at=steps)
    m = rows[-1]["metrics"]
    log(f"[{tag}] {len(rows)} micro-steps, losses {[round(r['metrics']['loss'], 3) for r in rows]}"
        f"; last: " + ", ".join(f"{k} {v:.6g}" for k, v in m.items())
        + f"; parameters changed at {[i for i, r in enumerate(rows, 1) if any(r['params'])]} "
        f"({len(watch)} tensors at {steps}), SN state changed at every micro-step, every launch "
        f"counter 0 (nerf_mlp and flash included); peak allocated {peak / 2**30:.2f} GiB (the "
        f"checked run)")
    recs = [json.loads(line) for line in open(os.path.join(tmp, "train.jsonl"))]

    timed_dir = os.path.join(tmp, "timed")
    timed_cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, extra={**cfg.data.extra, "steps_per_epoch": timed}))
    torch.cuda.reset_peak_memory_stats(dev)
    timer = StepTimer(torch, pipe, "stage1_train_step", timed)
    t0 = time.perf_counter()
    Trainer(timed_cfg, pipe, data_fn(timed, 1), save_dir=timed_dir).train_stage1(
        epochs=1, eval_hook=lambda *a: None)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    steady = timer.finish()
    peak = torch.cuda.max_memory_allocated(dev)
    shutil.rmtree(timed_dir)
    log(f"[{tag}] timed run: {timed} micro-steps and a checkpoint in {t_run:.3f} s; steady over "
        f"micro-steps 2-{timed} {1 / steady:.4f} micro-steps/s = {per_step / steady:.4f} "
        f"training samples/s ({1e3 * steady:.1f} ms per micro-step) on {nvidia_smi()}; peak "
        f"allocated {peak / 2**30:.2f} GiB")

    gen = torch.Generator(device=dev).manual_seed(120)
    batch = on_device(torch, data_fn(1, 2).items[0], dev)
    step = lambda: pipe.stage1_train_step(state, batch, generator=gen)
    split, dev_total = range_split(torch, step, "stage1/")
    missing = [k for k in stages if "stage1/" + k not in split]
    log(f"[{tag}-breakdown] one micro-step (after a warm-up one) by the profiler's stage1/* "
        "ranges: " + "; ".join(f"{k} {split['stage1/' + k][1]:.2f} ms device / "
                               f"{split['stage1/' + k][0]:.2f} ms host"
                               for k in stages if k not in missing)
        + f"; outside the ranges {dev_total - sum(d for _, d in split.values()):.2f} ms device; "
        f"all kernels {dev_total:.2f} ms (host times under the profiler)")
    if missing:
        raise AssertionError(f"{tag}: the micro-step's profile has no range for {missing}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    dms = device_ms(torch, step, reps=2, alike=False)
    log(f"[{tag}-breakdown] one micro-step: wall {1e3 * t_wall:.1f} ms, host enqueue "
        f"{1e3 * t_enq:.1f} ms, device {dms:.1f} ms (profiler: kernels' time; the device is idle "
        f"{100 * max(0.0, 1 - dms / (1e3 * t_wall)):.1f}% of the wall time)")
    profile_top(torch, step, f"{tag}-profile", ("nerf_mlp", "flash_", "gemm_kernel",
                                                 "group_norm_kernel"), inference=False)
    return trainer, state, 1e3 * steady, recs


def threed_stage2_phase(torch, dev, tmp, tag, cfg, pipe, data_fn, per_step):
    """Trainer.train_stage2 at full width on the stage-1 checkpoint in `tmp`:
    `T2_STEPS` micro-steps saving no checkpoint of their own, each with
    finite loss, every launch counter 0 (the UNet's attentions train
    through the plain block, n <= 64 is below the flash tier), the watched
    parameters changed (no accumulation) and the EMA at the schedule's
    micro-steps (a copy of the parameters before step 100); the state saved
    as the trainer saves it, restored bit for bit into a scrambled one and
    resumed for a micro-step; a timed run.  -> (trainer, state, ms per
    micro-step)."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager
    from ddmi_tpu_torch.core.trainer import Trainer

    lc = cfg.model.lossconfig
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    trainer = Trainer(cfg, pipe, data_fn(T2_STEPS, 6), save_dir=tmp)
    read = reset_launches()
    rows, step_fn = [], pipe.stage2_train_step
    watch = ["unet.input_blocks.0.0.weight", "unet.out.2.weight", "mixing_logit"]

    def recording(state, x, **kw):
        with torch.no_grad():
            p0 = torch._foreach_mul([state.params[k] for k in watch], 1.0)
            e0 = torch._foreach_mul(list(state.ema.values()), 1.0)
        before = read()
        out = step_fn(state, x, **kw)
        after = read()
        with torch.no_grad():
            dp = torch.stack(torch._foreach_norm(torch._foreach_sub(
                [state.params[k] for k in watch], p0)))
            de = torch.stack(torch._foreach_norm(torch._foreach_sub(
                list(state.ema.values()), e0)))
            same = all(torch.equal(e, p) for e, p in zip(state.ema.values(),
                                                         state.params.values()))
        rows.append((dp > 0, de > 0, same, out[1]["loss"],
                     {k: after[k] - before[k] for k in after}))
        return out

    pipe.stage2_train_step = recording
    torch.cuda.reset_peak_memory_stats(dev)
    state = trainer.train_stage2(epochs=1, save=False)
    torch.cuda.synchronize()
    del pipe.stage2_train_step
    peak = torch.cuda.max_memory_allocated(dev)
    zero = {k: 0 for k in KERNELS}
    checks = []
    for i, (dp, de, same, loss, launches) in enumerate(rows, 1):
        ema_step = (i - 1) % lc.ema_update_every == 0
        checks.append(bool(dp.all()) and (bool(de.any()) == ema_step)
                      and (not ema_step or same) and math.isfinite(float(loss))
                      and launches == zero)
    log(f"[{tag}] stage 2 at full width: UNet {n_unet} parameters (fp32 masters, bf16 "
        f"compute) on the stage-1 checkpoint's pointnet, VAE and INR (the pointnet and VAE "
        f"frozen in bf16); {len(rows)} micro-steps, losses "
        f"{[round(float(r[3]), 5) for r in rows]}; the EMA changed at "
        f"{[i for i, r in enumerate(rows, 1) if r[1].any()]}; launches per micro-step "
        f"{ {k: v for k, v in rows[0][4].items() if v} } (all 0 expected); every check per "
        f"micro-step {checks}; peak allocated {peak / 2**30:.2f} GiB")
    if len(rows) != T2_STEPS or not all(checks):
        raise AssertionError(f"{tag}: the stage-2 run failed its checks")

    ckpt = CheckpointManager(tmp, prefix="stage2")
    step = state.step
    gen = torch.Generator(device=dev).manual_seed(99)
    t0 = time.perf_counter()
    ckpt.save(step, {"state": state.state_dict(), "generators": [gen.get_state()]})
    t_save = time.perf_counter() - t0
    saved = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in flat_state(state.state_dict()).items()}
    size = os.path.getsize(os.path.join(ckpt.root, f"{step}.pt"))
    with torch.no_grad():
        for t in list(state.params.values()) + list(state.ema.values()) + state.opt.mu:
            t.add_(1.0)
    state.step, state.opt.count = -1, -1

    class Wrap:
        def load_state_dict(self, sd):
            state.load_state_dict(sd["state"])

    ckpt.restore(Wrap())
    now = flat_state(state.state_dict())
    diff = [k for k in saved if not (torch.equal(saved[k], now[k]) if torch.is_tensor(saved[k])
                                      else saved[k] == now[k])]
    del saved, now
    rows.clear()
    pipe.stage2_train_step = recording
    resumed = Trainer(cfg, pipe, data_fn(1, 10), save_dir=tmp).train_stage2(
        epochs=1, resume=True, save=False)
    del pipe.stage2_train_step
    log(f"[{tag}-ckpt] step {step}: {size / 2**30:.3f} GiB on disk, saved in {t_save:.2f} s, "
        f"restored into a scrambled state: {len(diff)} entries differ {diff[:3]}; resumed to "
        f"step {resumed.step}, loss {float(rows[0][3]):.5f}, launches "
        f"{ {k: v for k, v in rows[0][4].items() if v} }")
    if diff or resumed.step != step + 1 or not math.isfinite(float(rows[0][3])) or (
            rows[0][4] != zero):
        raise AssertionError(f"{tag}: the stage-2 checkpoint does not restore bit for bit and "
                             f"resume")

    timer = StepTimer(torch, pipe, "stage2_train_step", T2_STEPS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    Trainer(cfg, pipe, data_fn(T2_STEPS, 7), save_dir=os.path.join(tmp, "timed")).train_stage2(
        epochs=1, save=False)
    torch.cuda.synchronize()
    steady = timer.finish()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[{tag}] timed run: {T2_STEPS} micro-steps in {time.perf_counter() - t0:.3f} s (the "
        f"stage-1 checkpoint's load included); steady {1 / steady:.4f} micro-steps/s = "
        f"{per_step / steady:.4f} training samples/s ({1e3 * steady:.1f} ms per micro-step) on "
        f"{nvidia_smi()}; peak allocated {peak / 2**30:.2f} GiB")
    batch = on_device(torch, data_fn(1, 8).items[0], dev)
    g = torch.Generator(device=dev).manual_seed(98)
    step_once = lambda: pipe.stage2_train_step(resumed, batch, generator=g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_once()
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    dms = device_ms(torch, step_once, reps=2, alike=False)
    log(f"[{tag}-breakdown] one micro-step: wall {1e3 * t_wall:.1f} ms, host enqueue "
        f"{1e3 * t_enq:.1f} ms, device {dms:.1f} ms (the device is idle "
        f"{100 * max(0.0, 1 - dms / (1e3 * t_wall)):.1f}% of the wall time)")
    return trainer, resumed, 1e3 * steady


def nerf_train_phase(torch, dev, tmp):
    """srn_cars training at full width: configs/d2c-vae/srn_cars.yaml's stage
    1 (batch 1, accumulation over 10 with the warm-up from rate 0, so the
    parameters move at micro-step 20; 5000 rays of 256 perturbed samples
    per micro-step through the INRNeRF module, never the MLP kernel), then
    configs/ldm/srn_cars.yaml's stage 2 on its checkpoint; the NeRF eval
    hooks log nothing and fail nothing.  -> ms per micro-step (stage 1,
    stage 2)."""
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline

    cfg = threed_config("configs/d2c-vae/srn_cars.yaml", nan_check_every=5, prefetch=2,
                        steps_per_epoch=N1_STEPS)
    m, lc = cfg.model, cfg.model.lossconfig
    if not (m.amp and cfg.data.batch_size == 1 and lc.gradient_accumulate_every == 10
            and lc.sn_reg and lc.lr_scheduler and not lc.kl_anneal):
        raise AssertionError("configs/d2c-vae/srn_cars.yaml no longer trains batch 1 at amp with "
                             "accumulation over 10, the warm-up schedule and SN")
    t0 = time.perf_counter()
    pipe = NeRFPipeline(cfg, device=dev, seed=cfg.seed)
    got = (pipe.n_rand, pipe.n_samples, pipe.perturb, pipe.pointnet.fc_pos.in_features)
    if got != (5000, 256, 1.0, 6):
        raise AssertionError(f"srn_cars renders (N_rand, N_samples, perturb, cloud width) {got}")
    for i, module in enumerate((pipe.pointnet, pipe.vae, pipe.mlp)):
        perturb_zero_init(module, 100 + i)
    n = {k: sum(p.numel() for p in getattr(pipe, k).parameters())
         for k in ("pointnet", "vae", "mlp")}
    log(f"[n-stage1] srn_cars stage 1 at full width: pointnet {n['pointnet']} + triplane VAE "
        f"{n['vae']} + INRNeRF {n['mlp']} parameters (fp32 masters; VAE and INRNeRF bf16 "
        f"compute), set up in {time.perf_counter() - t0:.1f} s; 5000 rays x 256 samples = "
        f"1.28 M MLP points per micro-step; cuts: {N1_STEPS} micro-steps instead of 4000 "
        f"epochs, synthetic scenes (a 3000-point coloured sphere, a 128^2 view), random-init "
        f"weights (no data or weight files in the repository)")
    trainer, state, ms1, recs = threed_stage1_phase(
        torch, dev, tmp, "n-stage1", cfg, pipe, nerf_data, N1_STEPS, N1_TIMED, 1,
        ("encode", "decode", "render", "sn", "backward", "optimizer"))
    if [r for r in recs if any(k.startswith("eval/") or "failures" in k for k in r)]:
        raise AssertionError("the NeRF stage-1 eval hook logged something")
    del trainer, state
    pipe.cpu()
    del pipe
    torch.cuda.empty_cache()

    cfg2 = threed_config("configs/ldm/srn_cars.yaml", nan_check_every=5, prefetch=2,
                         steps_per_epoch=T2_STEPS)
    s1 = load_config(os.path.join(ROOT, "configs/d2c-vae/srn_cars.yaml"))
    if (cfg2.model.ddconfig, cfg2.model.mlpconfig, cfg2.model.embed_dim) != (
            s1.model.ddconfig, s1.model.mlpconfig, s1.model.embed_dim):
        raise AssertionError("srn_cars' stage-1 blocks differ between the ldm and d2c-vae configs")
    pipe = NeRFPipeline(cfg2, device=dev, seed=cfg2.seed)
    perturb_zero_init(pipe.unet, 110)
    trainer, state, ms2 = threed_stage2_phase(torch, dev, tmp, "n-stage2", cfg2, pipe, nerf_data,
                                              1)
    from ddmi_tpu_torch.core.trainer import default_stage2_eval_hook

    read = reset_launches()
    default_stage2_eval_hook(trainer, state, 0)
    hook = {k: v for k, v in read().items() if v}
    if hook or os.path.exists(os.path.join(tmp, "samples")):
        raise AssertionError(f"the NeRF stage-2 eval hook did something: {hook}")
    return ms1, ms2


def occ_train_phase(torch, dev, tmp):
    """shapenet training at full width: configs/d2c-vae/shapenet.yaml's stage
    1 (batch 12, accumulation over 5, 2048 query points, the eval hook's
    IoU), then configs/ldm/shapenet.yaml's stage 2 on its checkpoint and
    the stage-2 eval hook (one EMA latent at NFE 200, a 32^3 mesh without
    MISE refinement, written as ep0.off) with its attn_block launches
    exact.  -> (ms per micro-step (stage 1, stage 2), the hook's
    launches)."""
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import default_stage2_eval_hook, ema_weights
    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline

    cfg = threed_config("configs/d2c-vae/shapenet.yaml", nan_check_every=5, prefetch=2,
                        steps_per_epoch=O1_STEPS)
    m, lc = cfg.model, cfg.model.lossconfig
    if not (m.amp and cfg.data.batch_size == O_BATCH and lc.gradient_accumulate_every == 5
            and lc.sn_reg and lc.lr_scheduler and lc.kl_anneal
            and lc.sn_reg_weight_decay_anneal):
        raise AssertionError("configs/d2c-vae/shapenet.yaml no longer trains batch 12 at amp "
                             "with accumulation over 5, the warm-up, the KL and SN anneals")
    t0 = time.perf_counter()
    pipe = OccupancyPipeline(cfg, device=dev, seed=cfg.seed)
    for i, module in enumerate((pipe.pointnet, pipe.vae, pipe.mlp)):
        perturb_zero_init(module, 130 + i)
    n = {k: sum(p.numel() for p in getattr(pipe, k).parameters())
         for k in ("pointnet", "vae", "mlp")}
    log(f"[o-stage1] shapenet stage 1 at full width: pointnet {n['pointnet']} + triplane VAE "
        f"{n['vae']} + INR3D {n['mlp']} parameters (fp32 masters; VAE bf16, INR3D fp32 on bf16 "
        f"weights), set up in {time.perf_counter() - t0:.1f} s; cuts: {O1_STEPS} micro-steps "
        f"instead of 300 epochs, synthetic ellipsoids (3000-point clouds, 2048 query points), "
        f"random-init weights")
    trainer, state, ms1, recs = threed_stage1_phase(
        torch, dev, tmp, "o-stage1", cfg, pipe, occ_data, O1_STEPS, O1_TIMED, O_BATCH,
        ("encode", "decode", "inr", "sn", "backward", "optimizer"))
    iou = [r["eval/iou"] for r in recs if "eval/iou" in r]
    failures = [r for r in recs if "s1/eval_hook_failures" in r]
    log(f"[o-stage1] eval hook: IoU {iou} of the first test shape's 2048 query points, failures "
        f"{len(failures)}")
    if len(iou) != 1 or not 0.0 <= iou[0] <= 1.0 or failures:
        raise AssertionError("the occupancy stage-1 eval hook did not log its IoU")
    del trainer, state
    pipe.cpu()
    del pipe
    torch.cuda.empty_cache()

    cfg2 = threed_config("configs/ldm/shapenet.yaml", nan_check_every=5, prefetch=2,
                         steps_per_epoch=T2_STEPS)
    s1 = load_config(os.path.join(ROOT, "configs/d2c-vae/shapenet.yaml"))
    if (cfg2.model.ddconfig, cfg2.model.mlpconfig, cfg2.model.embed_dim) != (
            s1.model.ddconfig, s1.model.mlpconfig, s1.model.embed_dim):
        raise AssertionError("shapenet's stage-1 blocks differ between the ldm and d2c-vae "
                             "configs")
    pipe = OccupancyPipeline(cfg2, device=dev, seed=cfg2.seed)
    perturb_zero_init(pipe.unet, 140)
    trainer, state, ms2 = threed_stage2_phase(torch, dev, tmp, "o-stage2", cfg2, pipe, occ_data,
                                              O_BATCH)
    with ema_weights(pipe, state), torch.no_grad():
        z = pipe.sample_latents(1, generator=torch.Generator(device=dev).manual_seed(
            cfg2.seed + 100))
        shift = recentre_field(torch, pipe, z)
    read = reset_launches()
    t0 = time.perf_counter()
    default_stage2_eval_hook(trainer, state, 0)
    torch.cuda.synchronize()
    t_hook = time.perf_counter() - t0
    hook = {k: v for k, v in read().items() if v}
    path = os.path.join(tmp, "samples", "ep0.off")
    with open(path) as f:
        head = [f.readline().strip() for _ in range(2)]
    nv, nf, _ = map(int, head[1].split())
    recs = [json.loads(line) for line in open(os.path.join(tmp, "train.jsonl"))]
    failures = [r for r in recs if "s2/eval_hook_failures" in r]
    log(f"[o-stage2] eval hook: one EMA latent (NFE {OCC_NFE}), a 32^3 grid, no MISE "
        f"refinement, in {t_hook:.2f} s: {path.rsplit(os.sep, 1)[-1]} with {nv} vertices and "
        f"{nf} faces (INR3D's output bias shifted by {shift:.3f} so that {OCC_INSIDE:.0%} of the "
        f"box lies inside); launches {hook} (expected {O2_HOOK_LAUNCHES}); failures "
        f"{len(failures)}")
    if head[0] != "OFF" or failures or hook != O2_HOOK_LAUNCHES or not nf:
        raise AssertionError("the occupancy stage-2 eval hook did not write its mesh through the "
                             "fused attention block")
    return ms1, ms2, hook


def threed_small_configs(domain, amp):
    """Small stage-1 configs of the two 3D domains (the JAX tests' tiny
    widths)."""
    from ddmi_tpu_torch.core.config import config_from_dict

    dd = dict(double_z=True, z_channels=32, in_channels=8, out_ch=8, ch=32,
              num_res_blocks=1, attn_resolutions=[], attn_type="vanilla")
    lc = dict(epochs=2, warmup_epochs=1, gradient_accumulate_every=2, sn_reg=True)
    if domain == "nerf":
        dd.update(resolution=16, ch_mult=[1, 2], hdbf_resolutions=[], inter_attn_resolutions=[16])
        mlp = dict(in_ch=3, out_ch=4, ch=64, latent_dim=8, D=6, W=64, skips=[2, 4], multires=4,
                   multires_views=2, N_samples=32, N_rand=256)
        pn = {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 16, "n_blocks": 3}
    else:
        dd.update(resolution=32, ch_mult=[1, 2, 4], hdbf_resolutions=[8, 16],
                  inter_attn_resolutions=[32, 16])
        mlp = dict(in_ch=3, out_ch=1, ch=64, latent_dim=8)
        pn = {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 32, "n_blocks": 3}
    return config_from_dict({"seed": 3, "model": {
        "amp": amp, "use_fp16": amp, "lr": 1e-4, "embed_dim": 8, "pointnet": pn, "params": {
            "lossconfig": lc, "ddconfig": dd, "mlpconfig": mlp,
            "unetconfig": dict(image_size=8, in_channels=24, model_channels=32, out_channels=24,
                               num_res_blocks=1, attention_resolutions=[2], channel_mult=[1, 2],
                               num_head_channels=16),
            "ddpmconfig": dict(image_size=8, channels=24)}},
        "data": {"domain": domain, "batch_size": 2}})


def threed_reference_phase(torch, dev):
    """One stage-1 loss and its gradients of each 3D domain at a small
    config: amp on the card against fp32 on the CPU, on the same weights,
    SN vectors, batch and draws: each loss term within 5%, the float64
    cosine of all gradients >= 0.99 (bf16 roundings, and the sign of an L1
    term that flips under them: the JAX package's own amp gradients at the
    tests' widths have cosines down to 0.9974 with its fp32 ones), no
    kernel launched."""
    import numpy as np

    from ddmi_tpu_torch.data.nerf import SyntheticNeRF
    from ddmi_tpu_torch.data.shapenet import SyntheticOccupancy
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline
    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline
    from ddmi_tpu_torch.domains.triplane import TriplaneDraws

    cases = (("nerf", NeRFPipeline, next(iter(SyntheticNeRF(2, 300, 24, length=1, seed=4)))),
             ("occupancy", OccupancyPipeline,
              next(iter(SyntheticOccupancy(2, 512, 600, length=1, seed=4)))))
    for domain, Pipe, batch in cases:
        out, weights, sn, draws = {}, None, None, None
        read = reset_launches()
        for tag, where, amp in (("cpu", "cpu", False), ("card", dev, True)):
            pipe = Pipe(threed_small_configs(domain, amp), device=where, seed=3)
            if weights is None:
                perturb_zero_init(pipe, 150)
                weights = {k: v.clone() for k, v in pipe.state_dict().items()}
            else:
                pipe.load_state_dict({k: v.to(where) for k, v in weights.items()})
            st = pipe.init_stage1(10)
            if sn is None:
                sn = st.sn
                draws = pipe.draw_stage1(batch if domain == "occupancy" else
                                         {k: torch.from_numpy(v) for k, v in batch.items()},
                                         torch.Generator().manual_seed(5))
            st.sn = {k: (u.to(where), v.to(where)) for k, (u, v) in sn.items()}
            d = TriplaneDraws(tuple(e.to(where) for e in draws.eps),
                              None if draws.pixels is None else draws.pixels.to(where),
                              None if draws.uniforms is None else draws.uniforms.to(where))
            before = read()
            loss, m, _ = pipe.stage1_loss(on_device(torch, batch, where), 3, d, st.sn)
            loss.backward()
            if where != "cpu":
                torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in read().items() if v - before[k]}
            g = torch.cat([p.grad.double().cpu().flatten() for p in st.params.values()])
            out[tag] = ({k: float(v) for k, v in m.items()}, g, launches)
            del pipe
        (mc, gc, _), (mg, gg, launches) = out["cpu"], out["card"]
        cos = torch.nn.functional.cosine_similarity(gg, gc, dim=0).item()
        terms = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc if k != "kl_coeff"}
        log(f"[3d-reference] {domain}, one stage-1 micro-step at a small config: amp on the card "
            f"against fp32 on the CPU: " + ", ".join(f"{k} {mg[k]:.6g} vs {mc[k]:.6g} (relative "
                                                    f"{v:.5f})" for k, v in terms.items())
            + f"; float64 gradient cosine {cos:.6f}; launches on the card {launches}")
        if launches or cos < T3_REF_MIN_COS or any(v > T3_REF_TERM_REL for v in terms.values()):
            raise AssertionError(f"the {domain} stage-1 step on the card disagrees with the CPU")


# ----------------------------------------------- the CLI, generation, evals


def cli_yaml(tmp, src, name, data=None, params=None, model=None):
    """configs/<src> with its data block, model block and model.params
    blocks updated (each a dict merged into the block), data.conv_config
    made absolute and save_pth set to tmp, written as tmp/<name>; -> the
    path.  `src` may also be a dict (a whole config)."""
    import yaml

    if isinstance(src, dict):
        raw = json.loads(json.dumps(src))
    else:
        with open(os.path.join(ROOT, src)) as f:
            raw = yaml.safe_load(f)
    d = raw.setdefault("data", {})
    if d.get("conv_config") and not os.path.isabs(d["conv_config"]):
        d["conv_config"] = os.path.join(ROOT, d["conv_config"])
    d.update({"save_pth": tmp, **(data or {})})
    raw.setdefault("model", {}).update(model or {})
    for block, kw in (params or {}).items():
        raw["model"].setdefault("params", {}).setdefault(block, {}).update(kw)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def run_cli(torch, tag, exp, path, dev):
    """ddmi_tpu_torch.cli.main on `path` with the counters at 0 just before;
    -> (launches, seconds)."""
    from ddmi_tpu_torch.cli.main import main as cli

    read = reset_launches()
    t0 = time.perf_counter()
    cli(["--exp", exp, "--configs", path, "--device", str(dev)])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k: v for k, v in read().items() if v}
    log(f"[{tag}] cli --exp {exp} ({os.path.basename(path)}): {sec:.2f} s, launches {launches}")
    return launches, sec


def write_bytes() -> str:
    """The bytes this process has passed to write() so far (/proc/self/io's
    wchar: checkpoints, logs and images), for the call's write limit."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
        return f"{int(io['wchar']) / 2**30:.2f} GiB"
    except (OSError, KeyError, ValueError):
        return "not readable"


def generated(tmp, prefix):
    """The files under tmp whose names start with prefix (PNGs, or .npy
    without PIL)."""
    out = []
    for dp, _, fs in os.walk(tmp):
        out += [os.path.relpath(os.path.join(dp, f), tmp) for f in fs
                if os.path.relpath(os.path.join(dp, f), tmp).startswith(prefix)]
    return sorted(out)


def eval_json(tmp):
    with open(os.path.join(tmp, "eval.json")) as f:
        return json.load(f)


def metric_nets_phase(torch, dev):
    """InceptionV3 and I3D (random He-normal weights, seed 0; no weight file
    is in the repository) on the card against the same networks on the
    CPU, fp32 both, TF32 off; their throughput; the Chamfer matrix of 64 x
    64 clouds of 2048 points on the card against the CPU's on a corner,
    timed, with the protocol's 1355 x 1355 extrapolated.  -> a dict of the
    numbers."""
    from ddmi_tpu_torch.evals.i3d import I3D
    from ddmi_tpu_torch.evals.inception import InceptionV3
    from ddmi_tpu_torch.evals.metrics_3d import chamfer_matrix

    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-12))
    out = {}
    g = torch.Generator().manual_seed(35)
    with torch.random.fork_rng(devices=[]), torch.inference_mode():
        torch.manual_seed(0)
        net = InceptionV3()
        x = torch.rand((2, 256, 256, 3), generator=g)
        ref = net(x)
        net.to(dev)
        got = net(x.to(dev))
        errs = [rel(a, b) for a, b in zip(got, ref)]
        xb = torch.rand((64, 299, 299, 3), generator=g).to(dev)
        ms = cuda_ms(lambda: net(xb), 5)
        x256 = torch.rand((64, 256, 256, 3), generator=g).to(dev)
        ms256 = cuda_ms(lambda: net(x256), 5)
    log(f"[metrics] InceptionV3 (FID) on the card against the CPU: pool rel err {errs[0]:.2e}, "
        f"logits {errs[1]:.2e} (bar {METRIC_REL_ERR}); {64e3 / ms:.1f} images/s at 299^2 "
        f"(batch 64, {ms:.2f} ms), {64e3 / ms256:.1f} images/s from 256^2 with the resize on the "
        f"card; fp32, TF32 off, on {nvidia_smi()}")
    if max(errs) > METRIC_REL_ERR:
        raise AssertionError(f"InceptionV3 on the card disagrees with the CPU: {errs}")
    out["inception_images_per_s"], out["inception_images_per_s_256"] = 64e3 / ms, 64e3 / ms256
    del net, xb, x256
    with torch.random.fork_rng(devices=[]), torch.inference_mode():
        torch.manual_seed(0)
        net = I3D()
        v = torch.rand((1, 16, 224, 224, 3), generator=g) * 2 - 1
        ref = net(v)
        net.to(dev)
        err = rel(net(v.to(dev)), ref)
        vb = (torch.rand((8, 16, 224, 224, 3), generator=g) * 2 - 1).to(dev)
        ms = cuda_ms(lambda: net(vb), 5)
    log(f"[metrics] I3D (FVD) on the card against the CPU: logits rel err {err:.2e} (bar "
        f"{METRIC_REL_ERR}); {8e3 / ms:.2f} clips/s at 16 x 224^2 (batch 8, {ms:.2f} ms); fp32, "
        f"TF32 off")
    if err > METRIC_REL_ERR:
        raise AssertionError(f"I3D on the card disagrees with the CPU: {err}")
    out["i3d_clips_per_s"] = 8e3 / ms
    del net, vb
    rng = torch.Generator().manual_seed(36)
    a = torch.rand((CHAMFER_CLOUDS, CHAMFER_POINTS, 3), generator=rng).numpy()
    b = torch.rand((CHAMFER_CLOUDS, CHAMFER_POINTS, 3), generator=rng).numpy()
    chamfer_matrix(a[:2], b[:2], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = chamfer_matrix(a, b, device=dev)
    sec = time.perf_counter() - t0
    ref = chamfer_matrix(a[:3, :512], b[:3, :512], device="cpu")
    err = float(abs(chamfer_matrix(a[:3, :512], b[:3, :512], device=dev) - ref).max()
                / abs(ref).max())
    scale = (CHAMFER_PROTOCOL / CHAMFER_CLOUDS) ** 2
    log(f"[metrics] chamfer_matrix {CHAMFER_CLOUDS} x {CHAMFER_CLOUDS} clouds of "
        f"{CHAMFER_POINTS} points on the card: {sec:.3f} s ({1e3 * sec / d.size:.3f} ms a pair); "
        f"the protocol's {CHAMFER_PROTOCOL} x {CHAMFER_PROTOCOL} extrapolated {sec * scale:.1f} s "
        f"a matrix, {3 * sec * scale:.1f} s for MMD / COV / 1-NNA's three; against the CPU on a "
        f"3 x 3 corner of 512 points: rel err {err:.2e}")
    if not np_finite(d) or err > 1e-5:
        raise AssertionError(f"chamfer_matrix on the card: finite {np_finite(d)}, err {err}")
    out["chamfer_s"], out["chamfer_protocol_s"] = sec, 3 * sec * scale
    return out


def np_finite(a) -> bool:
    import numpy as np

    return bool(np.isfinite(a).all())


def fid_timing_phase(torch, dev, nets):
    """FID-n at full width: configs/ldm/celebahq.yaml's pipeline (bf16 on the
    card, seeded weights, zero-init layers perturbed) samples
    FID_SAMPLES images at 256^2 through evals/fid.py::test_fid_n, batches of
    test_batch_size, with the counters exact (attn_block 16 per forward at
    the config's NFE, inr_decode one per batch); sampling, features and the
    statistics with the square root timed apart; seconds per 1000 samples
    and FID-10k extrapolated.  -> the launches."""
    import numpy as np

    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.evals import fid as fid_mod
    from ddmi_tpu_torch.evals.inception import InceptionV3

    cfg = load_config(os.path.join(ROOT, "configs/ldm/celebahq.yaml"))
    nfe, bs = cfg.model.ddpmconfig.sampling_timesteps, cfg.data.test_batch_size
    pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed)
    perturb_zero_init(pipe, 37)
    pipe.cast(torch.bfloat16)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        scorer = fid_mod.FIDScorer(InceptionV3(), device=dev)
    t = {"sample": 0.0, "features": 0.0}

    def timed(key, fn):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            t[key] += time.perf_counter() - t0
            return r
        return run

    scorer.features = timed("features", scorer.features)
    reals = [np.random.default_rng(i).random((bs, 256, 256, 3), np.float32) for i in range(3)]
    read = reset_launches()
    t0 = time.perf_counter()
    fid = fid_mod.test_fid_n(
        scorer, timed("sample", lambda g: pipe.sample_images(bs, resolution=256, generator=g)),
        reals, n_samples=FID_SAMPLES, batch=bs,
        generator=torch.Generator(device=dev).manual_seed(0))
    total = time.perf_counter() - t0
    launches = {k: v for k, v in read().items() if v}
    calls = -(-FID_SAMPLES // bs)
    expect = {"attn_block": 16 * nfe * calls, "inr_decode": calls}
    n = calls * bs
    stats = total - t["sample"] - t["features"]
    per_k = {"sampling": 1e3 * t["sample"] / n,
             "features": 1e3 * t["features"] / (n + 3 * bs)}
    log(f"[fid] FID-{n} at full width (celebahq, NFE {nfe}, batches of {bs} at 256^2): FID "
        f"{fid:.4g} (random weights); {total:.2f} s = sampling {t['sample']:.2f} + features "
        f"{t['features']:.2f} (of {n} generated and {3 * bs} real) + statistics and the 2048^2 "
        f"square root on the host {stats:.2f}; per 1000 samples: sampling "
        f"{per_k['sampling']:.1f} s, features {per_k['features']:.2f} s; FID-10k extrapolated "
        f"{10 * (per_k['sampling'] + per_k['features']) + stats:.0f} s (the real set's features "
        f"and a precomputed-statistics file not counted); launches {launches} (expected "
        f"{expect}); on {nvidia_smi()}")
    if launches != expect or not math.isfinite(fid):
        raise AssertionError(f"FID-n at full width: launches {launches}, FID {fid}")
    nets.update(fid_sampling_s_per_1000=per_k["sampling"],
                fid_features_s_per_1000=per_k["features"], fid_host_s=stats)
    return launches


def cli_nerf_phase(torch, dev, tmp):
    """The CLI at full width on srn_cars (configs/ldm/srn_cars.yaml for
    every mode; synthetic scenes with 128^2 views; random weights): stage
    1 and stage 2 trained for one epoch of 4 micro-steps each through
    `cli.main` (their checkpoints written by the trainer, the stage-2
    state 3.36 GiB), then gen (one scene, 8 views at 128^2: attn_block
    11 x NFE 200 and nerf_mlp 8 x 4 chunks, exact), eval --exp ldm
    (generate(n=1): the same counts) and eval --exp d2c-vae (PSNR of one
    view of each of 4 scenes: nerf_mlp 4 x 4); views on disk, a finite
    PSNR.  -> the gen and eval launches."""
    src = "configs/ldm/srn_cars.yaml"
    data = {"dataset": "synthetic", "test_resolution": 128, "mode": "train"}
    lc = {"epochs": 1, "warmup_epochs": 0, "save_and_sample_every": 1}
    total = collections.Counter()
    for exp in ("d2c-vae", "ldm"):
        run_cli(torch, "cli-nerf", exp, cli_yaml(tmp, src, f"train_{exp}.yaml", data,
                                                 {"lossconfig": lc}), dev)
        torch.cuda.empty_cache()
    sizes = {p: os.path.getsize(os.path.join(tmp, p, f)) / 2**30
             for p in ("stage1", "stage2") for f in os.listdir(os.path.join(tmp, p))}
    log(f"[cli-nerf] checkpoints written by the trainer: {', '.join(f'{k} {v:.2f} GiB' for k, v in sizes.items())}; "
        f"this process has written {write_bytes()} so far")
    per_scene = {"attn_block": NERF_LAUNCHES["attn_block"], "nerf_mlp": NERF_VIEWS * (NERF_RES ** 2 // 4096)}
    for mode, exp, expect in (("gen", "ldm", per_scene), ("eval", "ldm", per_scene),
                              ("eval", "d2c-vae", {"nerf_mlp": 4 * (128 ** 2 // 4096)})):
        path = cli_yaml(tmp, src, f"{mode}_{exp}.yaml", {**data, "mode": mode},
                        {"lossconfig": lc})
        launches, _ = run_cli(torch, "cli-nerf", exp, path, dev)
        if launches != expect:
            raise AssertionError(f"cli {mode} --exp {exp} on srn_cars: launches {launches}, "
                                 f"expected {expect}")
        total.update(launches)
        torch.cuda.empty_cache()
        if mode == "eval":
            res = eval_json(tmp)
            log(f"[cli-nerf] eval --exp {exp}: {res}")
            key = "generated" if exp == "ldm" else "psnr"
            if not math.isfinite(res.get(key, float("nan"))):
                raise AssertionError(f"eval --exp {exp} on srn_cars wrote {res}")
    views = generated(tmp, os.path.join("generation", "nerf_0"))
    log(f"[cli-nerf] gen wrote {len(views)} file(s): {views[:3]}...")
    if len(views) not in (1, NERF_VIEWS):  # one .npy without PIL, else a PNG a view
        raise AssertionError(f"gen on srn_cars wrote {views}")
    total.update(serve_from_disk_phase(torch, dev, tmp,
                                       os.path.join(tmp, "gen_ldm.yaml"), per_scene))
    return dict(total)


def serve_from_disk_phase(torch, dev, tmp, path, per_scene):
    """Phase 40: `cli/serve.py`'s service (its build_service) restored
    from the checkpoints phase 37's trainer wrote under `tmp` (EMA on; no
    new checkpoint), one scene a batch (8 views at 128^2) over HTTP: a gif
    (when PIL imports) and an npy body, each batch's launches exactly
    `per_scene`; the npy body equals, bit for bit, that of a service given
    the same weights as state_dicts read from the files; restore seconds
    and scenes/s.  -> launches."""
    import glob

    from ddmi_tpu_torch.cli.serve import build_service, parse_args
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.serve.server import SamplerService

    args = ["--configs", path, "--batch", "1", "--resolution", str(NERF_RES), "--n-views",
            str(NERF_VIEWS), "--linger-ms", "0", "--device", str(dev)]
    t0 = time.perf_counter()
    svc = build_service(parse_args(args))
    t_restore = time.perf_counter() - t0
    total = collections.Counter()
    fmts = (["gif"] if have_pil() else []) + ["npy"]
    batches, _ = timed_batches(svc)
    httpd, url = start_http(svc)
    try:
        health = json.loads(http_call(url, "/healthz")[2])
        answers = {}
        for fmt in fmts:
            read = reset_launches()
            answers[fmt] = http_call(url, "/generate", {"n": 1, "seed": 7, "format": fmt})
            launches = {k: v for k, v in read().items() if v}
            total.update(launches)
            log(f"[serve-disk] POST /generate {fmt}: {answers[fmt][:2]}, "
                f"{len(answers[fmt][2])} bytes in {answers[fmt][3]:.3f} s, launches {launches} "
                f"(expected {per_scene})")
            if answers[fmt][0] != 200 or launches != per_scene:
                raise AssertionError(f"the restored srn_cars service answered {fmt} with "
                                     f"{answers[fmt][:2]}, launches {launches}")
    finally:
        stop_http(httpd)
        svc.close()
    body = npy(answers["npy"][2])
    t_batch = batches[-1][1]
    s1, s2 = (torch.load(sorted(glob.glob(os.path.join(tmp, prefix, "*.pt")))[-1],
                         map_location="cpu", weights_only=True)["state"]
              for prefix in ("stage1", "stage2"))
    sds = {name: {k[len(name) + 1:]: v for k, v in s1["params"].items()
                  if k.startswith(name + ".")} for name in ("pointnet", "vae", "mlp")}
    sds["unet"] = {k[len("unet."):]: v for k, v in s2["ema"].items() if k.startswith("unet.")}
    sds["mixing_logit"] = s2["ema"]["mixing_logit"]
    ref = SamplerService(load_config(path), service_batch=1, resolution=NERF_RES,
                         n_views=NERF_VIEWS, linger_ms=0, device=dev, state_dicts=sds)
    try:
        read = reset_launches()
        want = ref.generate(1, seed=7, timeout=900)
        total.update({k: v for k, v in read().items() if v})
    finally:
        ref.close()
    same = body.shape == want.shape and bool((body == want).all())
    log(f"[serve-disk] srn_cars restored by cli/serve.py's build_service in {t_restore:.2f} s "
        f"(step {health['step']}, EMA; /healthz {health}); formats run: {', '.join(fmts)}; "
        f"npy {body.shape} equal to a service given the files' weights as state_dicts: {same}; "
        f"the npy batch {t_batch:.3f} s = {1 / t_batch:.4f} scenes/s on {nvidia_smi()}")
    if not same or health["step"] != s2["step"] or health["initialized"]:
        raise AssertionError("the service restored from disk failed its checks")
    return dict(total)


def cli_image_phase(torch, dev, tmp):
    """The CLI on celebahq with its stage 1 (VAE and INR) at full width and
    the UNet cut to 2 levels of 64 channels (the full state is 18 GB a
    checkpoint, which the call's disk budget leaves no room to write
    twice): a stage-1 and a stage-2 checkpoint written by the trainer (one
    micro-step each on synthetic images), then gen (test_batch_size 6 at
    test_resolution 512^2), eval --exp ldm (FID-n at eval_samples 16) and
    eval --exp d2c-vae (rFID of reconstructions), each with exact counts:
    attn_block once per fused block per forward, inr_decode once per
    sample or reconstruct call.  -> the launches."""
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.data.synthetic import SyntheticImages
    from ddmi_tpu_torch.domains.image import ImagePipeline

    cut = {"model_channels": 64, "channel_mult": [1, 2], "attention_resolutions": [2],
           "num_res_blocks": 1}
    extra = {"eval_samples": CLI_EVAL_SAMPLES, "steps_per_epoch": 1}
    data = {"dataset": "synthetic", "mode": "train", "extra": extra}
    params = {"unetconfig": cut,
              "lossconfig": {"epochs": 1, "warmup_epochs": 0, "save_and_sample_every": 1}}
    path = cli_yaml(tmp, "configs/ldm/celebahq.yaml", "train.yaml", data, params)
    cfg = load_config(path, exp="ldm")
    pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed)
    perturb_zero_init(pipe, 38)
    Trainer(cfg, pipe, Items(SyntheticImages(2, 512, length=1, seed=3))).train_stage1()
    Trainer(cfg, pipe, Items(SyntheticImages(2, 256, length=1, seed=4))).train_stage2()
    nfe, bs = cfg.model.ddpmconfig.sampling_timesteps, cfg.data.test_batch_size
    r, c = cfg.model.unetconfig.image_size, cfg.model.ddpmconfig.channels
    x = torch.zeros((1, c, r, r), device=dev)
    _, fused, blocks = count_attention_blocks(torch, pipe.unet.to(torch.bfloat16), x,
                                              torch.zeros((1,), device=dev, dtype=torch.long))
    del pipe
    torch.cuda.empty_cache()
    log(f"[cli-image] celebahq, UNet cut to {cut}: {fused} fused attention blocks a forward "
        f"({blocks} in the tree); stage-1 and stage-2 checkpoints written; this process has "
        f"written {write_bytes()} so far")
    if not fused or fused != blocks:
        raise AssertionError(f"the cut UNet has {blocks} attention blocks, {fused} fused")
    fid_calls = -(-CLI_EVAL_SAMPLES // bs)
    rfid_calls = max(1, CLI_EVAL_SAMPLES // cfg.data.batch_size)
    total = collections.Counter()
    for mode, exp, expect in (
            ("gen", "ldm", {"attn_block": fused * nfe, "inr_decode": 1}),
            ("eval", "ldm", {"attn_block": fused * nfe * fid_calls, "inr_decode": fid_calls}),
            ("eval", "d2c-vae", {"inr_decode": rfid_calls})):
        path = cli_yaml(tmp, "configs/ldm/celebahq.yaml", f"{mode}_{exp}.yaml",
                        {**data, "mode": mode}, params)
        launches, _ = run_cli(torch, "cli-image", exp, path, dev)
        if launches != expect:
            raise AssertionError(f"cli {mode} --exp {exp} on celebahq: launches {launches}, "
                                 f"expected {expect}")
        total.update(launches)
        torch.cuda.empty_cache()
        if mode == "eval":
            res = eval_json(tmp)
            key = "fid" if exp == "ldm" else "rfid"
            log(f"[cli-image] eval --exp {exp}: {res}")
            if not math.isfinite(res.get(key, float("nan"))):
                raise AssertionError(f"eval --exp {exp} on celebahq wrote {res}")
    imgs = generated(tmp, "generation")
    log(f"[cli-image] gen wrote {imgs}")
    if not (imgs == ["generation.npy"] or len(imgs) == bs):
        raise AssertionError(f"gen on celebahq wrote {imgs}")
    return dict(total)


def cli_small_configs():
    """Small configs of video (16 frames at 64^2, so that the I3D takes the
    clips), occupancy (a 32^3 grid without MISE refinement, through a
    convocc file written beside it) and NeRF (a width-256 MLP, which the
    kernel takes), amp on, synthetic data."""
    lc = {"epochs": 1, "warmup_epochs": 0, "save_and_sample_every": 1,
          "gradient_accumulate_every": 1, "multiscale": False}
    ddpm = {"timesteps": 20, "sampling_timesteps": 4, "mixed_init": -6.0}
    # 128 channels at the attention level: the fused block's predicate
    unet = {"model_channels": 64, "num_res_blocks": 1, "attention_resolutions": [2],
            "channel_mult": [1, 2], "num_head_channels": 16}
    base = {"amp": True, "use_fp16": True, "lr": 1e-4, "embed_dim": 8}
    # the video reference's widths (phase 9: attn_block, mha_vmem and flash
    # all on the sampling path) at 16 frames of 64^2
    video = {"model": {**base, "embed_dim": 16, "params": {
        "lossconfig": lc, "ddpmconfig": {**ddpm, "channels": 16},
        "unetconfig": dict(triplane=True, in_channels=16, model_channels=256, out_channels=16,
                           num_res_blocks=1, attention_resolutions=[2], channel_mult=[1, 2],
                           num_head_channels=64),
        "ddconfig": dict(double_z=True, timesformer_channels=64, patch_size=8, splits=1,
                         resolution=64, z_channels=32, in_channels=3, out_ch=16, ch=32,
                         ch_mult=[1, 1, 2, 2], num_res_blocks=1, attn_resolutions=[],
                         hdbf_resolutions=[16, 32], inter_attn_resolutions=[8, 32, 64],
                         attn_type="vanilla-multihead"),
        "mlpconfig": dict(in_ch=3, out_ch=3, ch=256, latent_dim=16)}},
        "data": {"domain": "video", "frames": 16, "batch_size": 1, "test_batch_size": 1,
                 "test_resolution": 64}}
    dd3 = dict(double_z=True, z_channels=32, in_channels=8, out_ch=8, ch=32, num_res_blocks=1,
               attn_resolutions=[], attn_type="vanilla")
    threed = lambda domain, dd, mlp, pn: {"model": {**base, "pointnet": pn, "params": {
        "lossconfig": lc, "ddconfig": {**dd3, **dd}, "mlpconfig": mlp,
        "unetconfig": {**unet, "image_size": 8, "in_channels": 24, "out_channels": 24},
        "ddpmconfig": {**ddpm, "image_size": 8, "channels": 24}}},
        "data": {"domain": domain, "batch_size": 2, "test_batch_size": 2, "test_resolution": 32}}
    occ = threed("occupancy", dict(resolution=32, ch_mult=[1, 2, 4], hdbf_resolutions=[8, 16],
                                   inter_attn_resolutions=[32, 16]),
                 dict(in_ch=3, out_ch=1, ch=64, latent_dim=8),
                 {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 32, "n_blocks": 3})
    nerf = threed("nerf", dict(resolution=16, ch_mult=[1, 2], hdbf_resolutions=[],
                               inter_attn_resolutions=[16]),
                  dict(in_ch=3, out_ch=4, ch=64, latent_dim=8, D=6, W=256, skips=[2, 4],
                       multires=4, multires_views=2, N_samples=32, N_rand=256),
                  {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 16, "n_blocks": 3})
    nerf["data"].update(batch_size=1, test_batch_size=1)
    return {"video": video, "occupancy": occ, "nerf": nerf}


SMALL_CONVOCC = {"model": {"c_dim": 8, "encoder_kwargs": {
    "hidden_dim": 32, "plane_resolution": 32, "n_blocks": 3}},
    "generation": {"resolution_0": 32, "upsampling_steps": 0}, "test": {"threshold": 0.2}}


def cli_small_phase(torch, dev, tmp):
    """Video, occupancy and NeRF at small configs through `cli.main` on the
    card: train (both stages), gen, eval --exp d2c-vae, eval --exp ldm.
    Video: PSNR, then FVD through the full I3D (2 generated clips against
    2 real ones); occupancy: the IoU, then MMD / COV / 1-NNA of 3 meshes
    on 32^3 grids in lockstep groups of 2 (the last padded; INR3D's
    output bias is shifted once, in the stage-1 checkpoint, so that 5% of
    a sampled field lies inside); NeRF: PSNR, then generate.  Each path's
    kernels must launch: attn_block in every domain's UNet, mha_vmem and
    flash_attention in video's, nerf_mlp in NeRF's render.  -> the
    launches of gen and eval."""
    import yaml

    from ddmi_tpu_torch.cli.main import build_dataset, build_pipeline
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import Trainer, sampling_weights

    cfgs = cli_small_configs()
    conv = os.path.join(tmp, "convocc_small.yaml")
    with open(conv, "w") as f:
        yaml.safe_dump(SMALL_CONVOCC, f)
    cfgs["occupancy"]["data"]["conv_config"] = conv
    needs = {"video": {"attn_block", "mha_vmem", "flash_attention"},
             "occupancy": {"attn_block"}, "nerf": {"attn_block", "nerf_mlp"}}
    evals = {"video": ({"eval_samples": 8, "fvd_samples": 2}, "psnr", "fvd"),
             "occupancy": ({"eval_samples": 3, "mesh_batch": 2}, "iou", "mmd"),
             "nerf": ({"eval_samples": 2}, "psnr", "generated")}
    total = collections.Counter()
    for domain, src in cfgs.items():
        sub = os.path.join(tmp, domain)
        os.makedirs(sub)
        extra, key1, key2 = evals[domain]
        t0 = time.perf_counter()
        for exp in ("d2c-vae", "ldm"):
            run_cli(torch, f"cli-{domain}", exp, cli_yaml(
                sub, src, f"train_{exp}.yaml", {"dataset": "synthetic", "mode": "train"}), dev)
        if domain == "occupancy":
            path = cli_yaml(sub, src, "shift.yaml", {"dataset": "synthetic", "mode": "gen"})
            cfg = load_config(path, exp="ldm")
            tr = Trainer(cfg, build_pipeline(cfg, dev), build_dataset(cfg, train=False))
            tr.load_stage1()
            with sampling_weights(tr.pipe, tr.load_stage2()), torch.no_grad():
                z = tr.pipe.sample_latents(1, generator=torch.Generator(device=dev).manual_seed(0))
                shift = recentre_field(torch, tr.pipe, z)
            ck = os.path.join(sub, "stage1", os.listdir(os.path.join(sub, "stage1"))[0])
            saved = torch.load(ck, map_location="cpu", weights_only=True)
            params = saved["state"]["params"]
            params["mlp.net_out.bias"] = params["mlp.net_out.bias"].detach() + shift
            torch.save(saved, ck)
            log(f"[cli-occupancy] INR3D's output bias shifted by {shift:.3f} in {ck}")
            del tr
        for mode, exp in (("gen", "ldm"), ("eval", "d2c-vae"), ("eval", "ldm")):
            path = cli_yaml(sub, src, f"{mode}_{exp}.yaml",
                            {"dataset": "synthetic", "mode": mode, "extra": extra})
            launches, _ = run_cli(torch, f"cli-{domain}", exp, path, dev)
            total.update(launches)
            if exp == "ldm" and not needs[domain] <= set(launches):
                raise AssertionError(f"cli {mode} --exp ldm on {domain} launched {launches}, "
                                     f"not all of {sorted(needs[domain])}")
            if mode == "eval":
                res = eval_json(sub)
                key = key1 if exp == "d2c-vae" else key2
                log(f"[cli-{domain}] eval --exp {exp}: {res}")
                if not math.isfinite(res.get(key, float("nan"))):
                    raise AssertionError(f"eval --exp {exp} on {domain} wrote {res}")
        out = generated(sub, "generation")
        log(f"[cli-{domain}] gen wrote {len(out)} file(s) ({out[:2]}...); train -> gen -> eval "
            f"{time.perf_counter() - t0:.1f} s")
        if not out:
            raise AssertionError(f"gen on {domain} wrote nothing")
        torch.cuda.empty_cache()
    return dict(total)


REFERENCE_STEP = 123
# Phase 41's launches per domain at its configs and NFE 4, for one full
# UNet forward, one on its cache, one exact sampling batch and one
# --turbo 2 request (two full forwards and two on the cache)
CONVERT_SERVE_LAUNCHES = {
    "image": {"full": {"attn_block": 4}, "cached": {"attn_block": 3},
              "exact": {"attn_block": 16, "inr_decode": 1},
              "turbo": {"attn_block": 14, "inr_decode": 1}},
    "video": {"full": {"attn_block": 8, "mha_vmem": 8}, "cached": {"attn_block": 6, "mha_vmem": 5},
              "exact": {"attn_block": 32, "mha_vmem": 34, "flash_attention": 2},
              "turbo": {"attn_block": 28, "mha_vmem": 28, "flash_attention": 2}},
    "occupancy": {"full": {"attn_block": 4}, "cached": {"attn_block": 3},
                  "exact": {"attn_block": 16}, "turbo": {"attn_block": 14}},
    "nerf": {"full": {"attn_block": 4}, "cached": {"attn_block": 3},
             "exact": {"attn_block": 16, "nerf_mlp": 4},
             "turbo": {"attn_block": 14, "nerf_mlp": 4}},
}


def reference_file(torch, pipe, path, video: bool) -> None:
    """The pipeline's weights as the original repository saves an
    `ldm-last.pt`: the stage-1 modules under 'vaemodel', 'mlp' (and
    'pointnet'), the DDPM under 'diffusion' ('model.*', its mixing logit
    (1, C, 1, 1), or (1, C, 1) for video, and a schedule buffer), and an
    EMA under 'ema' ('ema_model.*') 1% off the weights; fp32 on the CPU."""
    g = torch.Generator().manual_seed(41)
    sd = lambda m: {k: v.detach().float().cpu() for k, v in m.state_dict().items()}
    c = pipe.mixing_logit.numel()
    diffusion = {f"model.{k}": v for k, v in sd(pipe.unet).items()}
    diffusion["mixing_logit"] = pipe.mixing_logit.detach().float().cpu().reshape(
        (1, c, 1) if video else (1, c, 1, 1))
    diffusion["betas"] = pipe.gd.schedule.betas.detach().float().cpu()
    ema = {f"ema_model.{k}": v * (1 + 0.01 * torch.randn(v.shape, generator=g))
           for k, v in diffusion.items()}
    data = {"step": REFERENCE_STEP, "vaemodel": sd(pipe.vae), "mlp": sd(pipe.mlp),
            "diffusion": diffusion, "ema": ema}
    if "pointnet" in pipe.stage1_modules:
        data["pointnet"] = sd(pipe.pointnet)
    torch.save(data, path)


def turbo_timing(torch, dev, exact, turbo, reps=20):
    """The exact and the --turbo 2 service's batches in turns (exact,
    turbo, turbo, exact, exact, turbo; seconds to the card's end, from one
    initial latent), and one UNet forward in full and on its cache (host ms
    to enqueue and device ms by CUDA events, `reps` each).  -> a dict."""
    g = torch.Generator(device=dev).manual_seed(9)
    noise = torch.randn((exact.batch,) + exact._noise_shape, device=dev, generator=g)
    walls = {"exact": [], "turbo": []}
    for name in ("exact", "turbo", "turbo", "exact", "exact", "turbo"):
        svc = exact if name == "exact" else turbo
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc._sample(noise, 0)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    unet = exact.pipe.unet
    x = noise.permute(0, 3, 1, 2).contiguous()
    t = torch.full((x.shape[0],), 500, device=dev, dtype=torch.long)
    out = {f"{k}_batch_s": v for k, v in walls.items()}
    with torch.inference_mode():
        _, cache = unet(x, t, return_cache=True)
        for name, fn in (("full", lambda: unet(x, t, return_cache=True)),
                         ("cached", lambda: unet(x, t, cache=cache))):
            fn()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            out[f"{name}_forward_host_ms"] = 1e3 * (time.perf_counter() - t0) / reps
            end.synchronize()
            out[f"{name}_forward_device_ms"] = start.elapsed_time(end) / reps
    return out


def forward_launches(torch, unet, x, t):
    """The launches of one full UNet forward and of one on its cache."""
    with torch.inference_mode():
        read = reset_launches()
        _, cache = unet(x, t, return_cache=True)
        full = read()
        read = reset_launches()
        unet(x, t, cache=cache)
        return full, read()


def convert_serve_phase(torch, dev, tmp):
    """Phase 41: for each domain at a small config (image: celebahq with
    the VAE cut to 32 channels and 1 block a level and the UNet to 2
    levels of 64 channels, the INR at full width, which inr_decode takes;
    video, occupancy, NeRF: phase 38's), a synthetic reference ldm file
    from seeded weights, converted by cli/convert_reference_ckpt.py into
    the port's checkpoints, then served by cli/serve.py's build_service
    with --turbo 2 over HTTP (NFE 4: two full forwards and two on the
    cache).  Checks: /healthz reports the reference step; the served UNet
    holds the file's EMA; the launches of a full forward, a cached one,
    an exact sampling batch and each --turbo 2 request are exactly
    CONVERT_SERVE_LAUNCHES's, and a request's are also an exact batch's
    less 2 x (a full forward's - a cached forward's); every domain's formats
    (image npy and png, video and NeRF npy and gif when PIL imports;
    occupancy obj and npz, and npy refused with 400).  -> launches."""
    import dataclasses

    import numpy as np
    import yaml

    from ddmi_tpu_torch.cli.convert_reference_ckpt import convert
    from ddmi_tpu_torch.cli.main import pipeline_class
    from ddmi_tpu_torch.cli.serve import build_service, parse_args
    from ddmi_tpu_torch.core.config import load_config

    cfgs = cli_small_configs()
    conv = os.path.join(tmp, "convocc_small.yaml")
    with open(conv, "w") as f:
        yaml.safe_dump(SMALL_CONVOCC, f)
    cfgs["occupancy"]["data"]["conv_config"] = conv
    cut = {"model_channels": 64, "channel_mult": [1, 2], "attention_resolutions": [2],
           "num_res_blocks": 1}
    image = ("configs/ldm/celebahq.yaml", {"unetconfig": cut,
                                          "ddconfig": {"ch": 32, "num_res_blocks": 1},
                                          "ddpmconfig": {"sampling_timesteps": 4}})
    pil = have_pil()
    formats = {"image": ["npy"] + (["png"] if pil else []),
               "video": ["npy"] + (["gif"] if pil else []),
               "nerf": ["npy"] + (["gif"] if pil else []), "occupancy": ["obj", "npz", "npy"]}
    serve_args = {"image": ["--resolution", "256"], "video": [],
                  "nerf": ["--resolution", "64", "--n-views", "2"],
                  "occupancy": ["--mesh-resolution0", "32", "--mesh-upsampling", "0"]}
    total = collections.Counter()
    for domain in ("image", "video", "occupancy", "nerf"):
        sub = os.path.join(tmp, domain)
        os.makedirs(sub)
        t0 = time.perf_counter()
        src, params = image if domain == "image" else (cfgs[domain], None)
        path = cli_yaml(sub, src, "serve.yaml", {"dataset": "synthetic", "mode": "gen"}, params)
        cfg = load_config(path, exp="ldm")
        pipe = pipeline_class(domain)(cfg, device=dev, seed=cfg.seed)
        perturb_zero_init(pipe, 41)
        if domain == "occupancy":  # a field with a surface, as phase 38 shifts it
            pipe.cast(torch.bfloat16)
            with torch.no_grad():
                z = pipe.sample_latents(1, generator=torch.Generator(device=dev).manual_seed(0))
            recentre_field(torch, pipe, z)
        pt = os.path.join(sub, "ldm-last.pt")
        reference_file(torch, pipe, pt, domain == "video")
        del pipe
        convert("ldm", path, pt, device=dev)
        svc = build_service(parse_args(["--configs", path, "--batch", "2", "--turbo", "2",
                                        "--linger-ms", "0", "--device", str(dev)]
                                       + serve_args[domain]))
        httpd, url = start_http(svc)
        try:
            health = json.loads(http_call(url, "/healthz")[2])
            ema = torch.load(pt, map_location="cpu", weights_only=True)["ema"]
            w = svc.pipe.unet.out[2].weight
            held = torch.equal(w.float().cpu(), ema["ema_model.model.out.2.weight"].to(w.dtype).float())
            # the per-forward launches at the service's latent shape
            shape = svc._noise_shape
            x = torch.zeros((svc.batch,) + shape, device=dev)
            if domain != "video":
                x = x.permute(0, 3, 1, 2).contiguous()
            t = torch.full((svc.batch,), 5, device=dev, dtype=torch.long)
            full, cached = forward_launches(torch, svc.pipe.unet, x, t)
            gd = svc.pipe.gd
            svc.pipe.gd = dataclasses.replace(gd, encoder_reuse=1)
            read = reset_launches()
            try:
                exact = http_call(url, "/generate", {"n": 1, "seed": 3, "format": formats[domain][0]})
            finally:
                svc.pipe.gd = gd
            exact_l = read()
            nonzero = lambda c: {k: v for k, v in c.items() if v}
            want = CONVERT_SERVE_LAUNCHES[domain]
            seen = {"full": full, "cached": cached, "exact": exact_l}
            for what, got in seen.items():
                if nonzero(got) != want[what]:
                    raise AssertionError(f"{domain}: {what} launches {nonzero(got)}, expected "
                                         f"{want[what]}")
            expect = {k: exact_l[k] - 2 * (full[k] - cached[k]) for k in KERNELS}
            if nonzero(expect) != want["turbo"]:
                raise AssertionError(f"{domain}: an exact batch less 2 x (full - cached) is "
                                     f"{nonzero(expect)}, not {want['turbo']}")
            answers = {}
            for fmt in formats[domain]:
                read = reset_launches()
                answers[fmt] = http_call(url, "/generate", {"n": 1, "seed": 3, "format": fmt})
                got = read()
                total.update(got)
                if got != expect:
                    raise AssertionError(f"{domain} --turbo 2 {fmt}: launches {got}, expected "
                                         f"{expect}")
        finally:
            stop_http(httpd)
            svc.close()
        total.update(exact_l)
        status = {f: a[:2] for f, a in answers.items()}
        log(f"[convert-serve] {domain}: converted and served in {time.perf_counter() - t0:.1f} "
            f"s; /healthz {health}; the UNet holds the file's EMA: {held}; a full forward "
            f"{ {k: v for k, v in full.items() if v} }, a cached one "
            f"{ {k: v for k, v in cached.items() if v} }; an exact batch "
            f"{ {k: v for k, v in exact_l.items() if v} }, each --turbo 2 request "
            f"{ {k: v for k, v in expect.items() if v} }; formats {status}")
        ok = {"image": "application/octet-stream", "png": "image/png", "gif": "image/gif",
              "obj": "text/plain", "npz": "application/octet-stream"}
        for fmt, (code, ctype, body, _) in answers.items():
            if domain == "occupancy" and fmt == "npy":
                if code != 400 or "not valid for domain 'occupancy'" not in body.decode():
                    raise AssertionError(f"occupancy answered npy with {code} {body[:200]}")
            elif code != 200 or ctype != ok.get(fmt, ok["image"]):
                raise AssertionError(f"{domain} answered {fmt} with {code} {ctype}")
        if domain == "occupancy":
            obj, arch = answers["obj"][2].decode(), npy(answers["npz"][2])
            log(f"[convert-serve] occupancy: OBJ {obj.count(chr(10) + 'v ')} vertices, "
                f"{obj.count(chr(10) + 'f ')} faces; npz {sorted(arch.files)}")
            if not obj.startswith("o mesh_0") or sorted(arch.files) != ["faces_0", "verts_0"]:
                raise AssertionError("the occupancy bodies are malformed")
        elif npy(answers["npy"][2]).dtype != np.uint8:
            raise AssertionError(f"{domain}'s npy body is not uint8")
        if (health["step"] != REFERENCE_STEP or health["initialized"] or not held
                or exact[0] != 200):
            raise AssertionError(f"{domain}: the converted service failed its checks")
        torch.cuda.empty_cache()
    return dict(total)


# ------------------------------------------------------ the denoiser family
# MDTv2 (model.DiT) on configs/ldm/celebahq.yaml's diffusion space at
# DiTConfig's own widths: 64 x 64 x 64 latents, patch 2 (1024 tokens),
# hidden 768, depth 12 (4 + 4 + 4 decode blocks), 12 heads of 64.  Served
# at the config's NFE (50), batch 8 at 256^2; trained at mask ratio 0.3
# (sail-sg/MDT's recipe: 614 of 1024 tokens kept), batch 5, accumulation
# over 5, 10 micro-steps
MDT_BATCH, MDT_MASK_RATIO, MDT_STEPS = 8, 0.3, 10
# the cut MDT of the save -> resume check and the converted small config
MDT_CUT = {"hidden_size": 128, "depth": 4, "num_heads": 4, "decode_layer": 2}
# the UNet variants at celebahq's unetconfig width: scale-shift norm with
# 1000 classes at batch 8 (16 fused attention blocks a forward), and the
# spatial transformer attending to a 77-token context of width 512 through
# 4 classifier-free-guided DDIM steps (w = 1) at batch 4
UNET_CLASSES, CTX_TOKENS, CTX_DIM, CFG_STEPS, CFG_BATCH = 1000, 77, 512, 4, 4
# the scale-shift UNet's bf16 forward through attn_block against the same
# forward with the plain block in its place: relative L2 error (each block
# rounds its GEMM operands and P to bf16 where the plain one is fp32)
VARIANT_REL_ERR = 0.02


def mdt_config(path="configs/ldm/celebahq.yaml", **dit):
    """`path` with model.DiT set and ditconfig at DiTConfig's defaults
    updated by `dit`."""
    from ddmi_tpu_torch.core.config import DiTConfig, load_config

    cfg = load_config(os.path.join(ROOT, path))
    model = dataclasses.replace(cfg.model, DiT=True, ditconfig=DiTConfig(**dit))
    return dataclasses.replace(cfg, model=model)


def mdt_slice_phase(torch, dev):
    """Phase 42: the image SamplerService with the MDTv2 denoiser at full
    width (seeded weights, zero-init layers perturbed; served bf16, which
    with the fp32 latent promotes the transformer to fp32 on bf16-rounded
    weights, as flax computes): three concurrent requests coalesce into
    one batch of 8 at 256^2, NFE 50; a repeat of a seed is bit-identical;
    the counters read inr_decode 1 a batch and 0 for every other kernel.
    Samples/s, one MDT forward's CUDA-event time, peak memory.  -> the
    launches."""
    from ddmi_tpu_torch.serve.server import SamplerService

    cfg = mdt_config()
    nfe = cfg.model.ddpmconfig.sampling_timesteps
    t0 = time.perf_counter()
    svc = SamplerService(cfg, service_batch=MDT_BATCH, resolution=RESOLUTION, linger_ms=500,
                         device=dev, allow_init=True)
    perturb_zero_init(svc.pipe, 42)
    n_mdt = sum(p.numel() for p in svc.pipe.unet.parameters())
    log(f"[mdt] celebahq with model.DiT at full width: MDTv2 {n_mdt} parameters "
        f"({svc.pipe.unet.num_tokens()} tokens, hidden {cfg.model.ditconfig.hidden_size}, "
        f"depth {cfg.model.ditconfig.depth}), set up in {time.perf_counter() - t0:.1f} s")
    requests = [(3, 421), (3, 422), (2, 423)]
    try:
        t0 = time.perf_counter()
        svc.warmup()
        log(f"[mdt] warm-up batch {time.perf_counter() - t0:.3f} s")
        results, t_batch, t_repeat, launches, peak = serve(torch, dev, svc, requests, "mdt")
        x = torch.randn((MDT_BATCH, 64, 64, 64), device=dev)
        t = torch.full((MDT_BATCH,), 500, device=dev, dtype=torch.long)
        with torch.inference_mode():
            fwd_ms = events_ms(torch, lambda: svc.pipe.unet(x, t), 5)
    finally:
        svc.close()
    for n, seed in requests:
        r = results[seed]
        if r.shape != (n, RESOLUTION, RESOLUTION, 3) or r.dtype.name != "uint8":
            raise AssertionError(f"mdt: bad result for seed {seed}: {r.shape} {r.dtype}")
    expect = {k: 2 if k == "inr_decode" else 0 for k in launches}
    log(f"[mdt] launches over 2 batches: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"the MDT slice's launch counts are off: {launches}")
    log(f"[mdt] coalesced batch of {MDT_BATCH} at {RESOLUTION}^2, NFE {nfe}: {t_batch:.3f} s = "
        f"{MDT_BATCH / t_batch:.4f} samples/s; repeat request {t_repeat:.3f} s; one MDT forward "
        f"at batch {MDT_BATCH} {fwd_ms:.3f} ms (CUDA events, fp32 compute on bf16 weights); "
        f"peak allocated {peak / 2**30:.2f} GiB on {nvidia_smi()}")
    return launches


def mdt_train_phase(torch, dev, tmp):
    """Phase 43: Trainer.train_stage2 with the masked MDTv2 at full width
    (mask ratio 0.3; celebahq's batch 5 of 256^2 synthetic images, amp,
    accumulation over 5; 10 micro-steps; no checkpoint): every counter 0,
    finite losses, the watched parameters (patch embedding, the first
    block's qkv, the final layer, the mask token, the mixing logit)
    changed at micro-steps 5 and 10 only; micro-steps/s and peak memory.
    Then at a cut width (MDT_CUT) 2 micro-steps with a checkpoint and the
    stage-2 eval hook (2 EMA images through MDTv2, inr_decode 1), and a new
    trainer that resumes for 1 more.  -> the launches."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.data.synthetic import SyntheticImages
    from ddmi_tpu_torch.domains.image import ImagePipeline

    cfg = mdt_config(mask_ratio=MDT_MASK_RATIO)
    m = cfg.model
    extra = {**cfg.data.extra, "nan_check_every": 5, "prefetch": 2}
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, extra=extra))
    pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed)
    perturb_zero_init(pipe, 43)
    u = pipe.unet
    log(f"[mdt-train] masked MDTv2 at full width: {sum(p.numel() for p in u.parameters())} "
        f"parameters (fp32 masters, amp {m.amp}), {u.keep_count()} of {u.num_tokens()} tokens "
        f"kept, batch {cfg.data.batch_size}, accumulation {m.lossconfig.gradient_accumulate_every}")
    data = SyntheticImages(cfg.data.batch_size, 256, length=MDT_STEPS, seed=0)
    watch = {"patch embedding": u.x_embedder.proj.weight,
             "first block qkv": u.en_inblocks[0].attn.qkv.weight,
             "final linear": u.final_layer.linear.weight, "mask token": u.mask_token,
             "mixing logit": pipe.mixing_logit}
    steps, step_fn = [], pipe.stage2_train_step

    def recording(state, x, **kw):
        before = {k: w.detach().clone() for k, w in watch.items()}
        out = step_fn(state, x, **kw)
        changed = [k for k, w in watch.items() if not torch.equal(before[k], w)]
        steps.append((changed, out[1]["loss"], time.perf_counter()))
        return out

    pipe.stage2_train_step = recording
    torch.cuda.reset_peak_memory_stats(dev)
    read = reset_launches()
    t0 = time.perf_counter()
    Trainer(cfg, pipe, data, save_dir=os.path.join(tmp, "full")).train_stage2(epochs=1,
                                                                             save=False)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev)
    del pipe.stage2_train_step
    losses = [float(loss) for _, loss, _ in steps]
    moved = [i for i, (c, _, _) in enumerate(steps, 1) if c]
    log(f"[mdt-train] {len(steps)} micro-steps, losses {[round(v, 5) for v in losses]}; "
        f"parameters changed at {moved} ({[c for c, _, _ in steps if c][:1]}); launches "
        f"{launches} (all expected 0)")
    if any(launches.values()) or len(steps) != MDT_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"MDT training: launches {launches}, losses {losses}")
    for i, (changed, _, _) in enumerate(steps, 1):
        if (i % 5 == 0) != (len(changed) == len(watch)) or (i % 5 and changed):
            raise AssertionError(f"MDT micro-step {i} changed {changed}")
    steady = (steps[-1][2] - steps[0][2]) / (len(steps) - 1)
    log(f"[mdt-train] {len(steps)} micro-steps in {t_run:.3f} s (the first includes set-up); "
        f"steady {1e3 * steady:.1f} ms a micro-step = {cfg.data.batch_size / steady:.4f} "
        f"training samples/s; peak allocated {peak / 2**30:.2f} GiB on {nvidia_smi()}")
    del pipe, u, watch, steps
    torch.cuda.empty_cache()

    cut = mdt_config(mask_ratio=MDT_MASK_RATIO, **MDT_CUT)
    extra = {**cut.data.extra, "nan_check_every": 1, "prefetch": 0, "steps_per_epoch": 2}
    cut = dataclasses.replace(cut, data=dataclasses.replace(cut.data, extra=extra))
    sub = os.path.join(tmp, "cut")
    total = collections.Counter()
    done = []
    for count, resume in ((2, False), (1, True)):
        pipe = ImagePipeline(cut, device=dev, seed=cut.seed)
        read = reset_launches()
        st = Trainer(cut, pipe, Batches(cut.data.batch_size, 256, count, 50 + count),
                     save_dir=sub).train_stage2(epochs=1, resume=resume)
        torch.cuda.synchronize()
        got = read()
        total.update(got)
        done.append((st.step, {k: v for k, v in got.items() if v}))
        del pipe, st
    recs = [json.loads(line) for line in open(os.path.join(sub, "train.jsonl"))]
    losses = [r["s2/loss"] for r in recs if "s2/loss" in r]
    failures = [r for r in recs if "s2/eval_hook_failures" in r]
    samples = sorted(f for f in os.listdir(os.path.join(sub, "samples")))
    log(f"[mdt-train] cut MDT {MDT_CUT}: steps {[s for s, _ in done]}, launches "
        f"{[l for _, l in done]} (inr_decode 1 a run: the eval hook), losses "
        f"{[round(v, 5) for v in losses]}, checkpoints "
        f"{CheckpointManager(sub, prefix='stage2').all_steps()}, samples {samples}, hook "
        f"failures {len(failures)}")
    if ([s for s, _ in done] != [2, 3] or [l for _, l in done] != [{"inr_decode": 1}] * 2
            or len(losses) != 3 or not all(map(math.isfinite, losses)) or failures
            or not samples):
        raise AssertionError("the cut MDT's save -> resume or its eval hook failed")
    return {k: launches[k] + total.get(k, 0) for k in launches}


def dit_convert_serve_phase(torch, dev, tmp):
    """Phase 44: a DiT config at a small width (celebahq with the VAE cut
    to 32 channels and 1 block a level, MDTv2 cut to MDT_CUT, the INR at
    width 256, NFE 4): a synthetic reference ldm file (maskedtransformer.py
    keys with their relative_position_index buffers), converted by
    cli/convert_reference_ckpt.py, then served by cli/serve.py over HTTP:
    the reference step, the file's EMA in the served MDT, one request
    with inr_decode 1 and nothing else; --turbo 2 refused; then gen
    through the CLI.  -> launches."""
    from ddmi_tpu_torch.cli.convert_reference_ckpt import convert
    from ddmi_tpu_torch.cli.serve import build_service, parse_args
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.domains.image import ImagePipeline

    params = {"ddconfig": {"ch": 32, "num_res_blocks": 1}, "ddpmconfig": {"sampling_timesteps": 4},
              "ditconfig": {**MDT_CUT, "mask_ratio": MDT_MASK_RATIO}}
    path = cli_yaml(tmp, "configs/ldm/celebahq.yaml", "serve.yaml",
                    {"dataset": "synthetic", "mode": "gen", "test_batch_size": 2}, params,
                    {"DiT": True})
    cfg = load_config(path, exp="ldm")
    pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed)
    perturb_zero_init(pipe, 44)
    pt = os.path.join(tmp, "ldm-last.pt")
    reference_file(torch, pipe, pt, False)
    data = torch.load(pt, map_location="cpu", weights_only=True)
    for k, b in pipe.unet.named_buffers():  # the reference keeps the index buffers
        for name, prefix in (("diffusion", "model."), ("ema", "ema_model.model.")):
            data[name][prefix + k] = b.cpu()
    torch.save(data, pt)
    del pipe
    t0 = time.perf_counter()
    convert("ldm", path, pt, device=dev)
    t_convert = time.perf_counter() - t0
    try:
        build_service(parse_args(["--configs", path, "--turbo", "2", "--device", str(dev)]))
        raise AssertionError("--turbo 2 was not refused for the MDTv2 denoiser")
    except ValueError as e:
        refused = str(e)
    svc = build_service(parse_args(["--configs", path, "--batch", "2", "--linger-ms", "0",
                                    "--resolution", "256", "--device", str(dev)]))
    httpd, url = start_http(svc)
    try:
        health = json.loads(http_call(url, "/healthz")[2])
        w = svc.pipe.unet.final_layer.linear.weight
        want = data["ema"]["ema_model.model.final_layer.linear.weight"]
        held = torch.equal(w.float().cpu(), want.to(w.dtype).float())
        read = reset_launches()
        code, _, body, sec = http_call(url, "/generate", {"n": 1, "seed": 3, "format": "npy"})
        launches = read()
    finally:
        stop_http(httpd)
        svc.close()
    img = npy(body) if code == 200 else None
    log(f"[dit-convert] converted in {t_convert:.2f} s; /healthz {health}; the served MDT holds "
        f"the file's EMA: {held}; a request {code} in {sec:.3f} s, "
        f"{None if img is None else (img.shape, str(img.dtype))}, launches "
        f"{ {k: v for k, v in launches.items() if v} }; --turbo 2 refused: {refused!r}")
    if (health["step"] != REFERENCE_STEP or health["initialized"] or not held or img is None
            or img.shape != (1, 256, 256, 3) or {k: v for k, v in launches.items() if v}
            != {"inr_decode": 1}):
        raise AssertionError("the converted DiT service failed its checks")
    gen, _ = run_cli(torch, "dit-convert", "ldm", path, dev)
    files = generated(tmp, "generation")
    log(f"[dit-convert] gen wrote {files}")
    if gen != {"inr_decode": 1} or not files:
        raise AssertionError(f"gen on the converted DiT config: launches {gen}, files {files}")
    total = collections.Counter(launches)
    total.update(gen)
    return dict(total)


def unet_variants_phase(torch, dev):
    """Phase 45: the UNet's options at celebahq's unetconfig width, bf16.
    The scale-shift UNet with 1000 class labels: one forward at batch 8
    launches attn_block exactly 16 times and nothing else, its output
    against the same forward with the plain block in the kernel's place
    (relative L2 <= VARIANT_REL_ERR), labels that change the output, both
    forwards timed.  The spatial-transformer UNet (context_dim 512): 4
    classifier-free-guided DDIM steps at batch 4 on a 77-token context, the
    unconditional branch a zero context; no attention kernel launches, the
    sample finite, the context changes a forward.  -> the launches."""
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.diffusion import process
    from ddmi_tpu_torch.nn.unet import UNet
    from ddmi_tpu_torch.ops import attn_block

    cfg = load_config(os.path.join(ROOT, "configs/ldm/celebahq.yaml")).model
    g = torch.Generator(device=dev).manual_seed(45)

    def build(**kw):
        with torch.device(dev):
            unet = UNet(dataclasses.replace(cfg.unetconfig, **kw))
        perturb_zero_init(unet, 45)
        return unet.to(torch.bfloat16).to(memory_format=torch.channels_last)

    unet = build(use_scale_shift_norm=True, num_classes=UNET_CLASSES)
    n_ss = sum(p.numel() for p in unet.parameters())
    x = torch.randn((BATCH, 64, 64, 64), device=dev, generator=g)
    t = torch.randint(0, 1000, (BATCH,), device=dev, generator=g)
    y = torch.randint(0, UNET_CLASSES, (BATCH,), device=dev, generator=g)
    with torch.inference_mode():
        read = reset_launches()
        out = unet(x, t, y=y)
        torch.cuda.synchronize()
        launches = read()
        kernel_ms = events_ms(torch, lambda: unet(x, t, y=y), 3)
        other = unet(x, t, y=y.flip(0))
        fused, plain_fn = attn_block.attention_block, attn_block._plain_module
        attn_block.attention_block = plain_fn
        try:
            ref = unet(x, t, y=y)
            plain_ms = events_ms(torch, lambda: unet(x, t, y=y), 3)
        finally:
            attn_block.attention_block = fused
    rel = float((out - ref).norm() / ref.norm())
    moved = float((out - other).abs().max())
    expect = {k: 16 if k == "attn_block" else 0 for k in launches}
    log(f"[unet-variants] scale-shift + {UNET_CLASSES} classes: {n_ss} parameters; one forward "
        f"at batch {BATCH}: launches {launches} (expected {expect}), {kernel_ms:.3f} ms with "
        f"attn_block against {plain_ms:.3f} ms with the plain block (CUDA events); rel L2 "
        f"{rel:.5f} (<= {VARIANT_REL_ERR}); other labels move the output by {moved:.4f} on "
        f"{nvidia_smi()}")
    if launches != expect or not (rel <= VARIANT_REL_ERR) or not moved > 0:
        raise AssertionError("the scale-shift, class-conditional UNet failed its checks")
    del unet, out, ref, other
    torch.cuda.empty_cache()

    unet = build(use_spatial_transformer=True, context_dim=CTX_DIM)
    n_st = sum(p.numel() for p in unet.parameters())
    ctx = torch.randn((CFG_BATCH, CTX_TOKENS, CTX_DIM), device=dev, generator=g)
    ddpm = dataclasses.replace(cfg.ddpmconfig, sampling_timesteps=CFG_STEPS)
    gd = process.GaussianDiffusion.from_config(ddpm).to(dev)
    logit = torch.zeros((1, 64, 1, 1), device=dev)
    noise = torch.randn((CFG_BATCH, 64, 64, 64), device=dev, generator=g)
    zero = torch.zeros_like(ctx)
    read = reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = process.ddim_sample(gd, lambda a, b: unet(a, b, cond=zero), logit, None, noise=noise,
                            cond_model_fn=lambda a, b: unet(a, b, cond=ctx))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches_st = read()
    with torch.inference_mode():
        tt = torch.full((CFG_BATCH,), 500, device=dev, dtype=torch.long)
        moved = float((unet(noise, tt, cond=ctx) - unet(noise, tt, cond=zero)).abs().max())
    log(f"[unet-variants] spatial transformer (context {CTX_TOKENS} x {CTX_DIM}): {n_st} "
        f"parameters; {CFG_STEPS} CFG DDIM steps at batch {CFG_BATCH} (w {gd.w}, 2 forwards a "
        f"step) in {sec:.3f} s = {1e3 * sec / (2 * CFG_STEPS):.1f} ms a forward; launches "
        f"{ {k: v for k, v in launches_st.items() if v} } (expected none); sample finite "
        f"{bool(torch.isfinite(z).all())}, std {float(z.std()):.4f}; the context moves a "
        f"forward by {moved:.4f} on {nvidia_smi()}")
    if any(launches_st.values()) or not bool(torch.isfinite(z).all()) or not moved > 0:
        raise AssertionError("the spatial-transformer UNet failed its checks")
    return launches

def denoiser_phases(torch, dev):
    """Phases 42-45 in a temporary directory under build/; -> their
    launches."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="denoiser_smoke_", dir=os.path.join(ROOT, "build"))
    total = collections.Counter()
    try:
        total.update(mdt_slice_phase(torch, dev))
        torch.cuda.empty_cache()
        total.update(mdt_train_phase(torch, dev, os.path.join(tmp, "train")))
        torch.cuda.empty_cache()
        os.makedirs(os.path.join(tmp, "convert"))
        total.update(dit_convert_serve_phase(torch, dev, os.path.join(tmp, "convert")))
        torch.cuda.empty_cache()
        total.update(unet_variants_phase(torch, dev))
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(total)


# ------------------------------------------------------ the standalone ConvONet
# configs/convocc/pointcloud/shapenet_3plane.yaml's model block through the
# port's convocc reader: pointnet_local_pool (hidden 256, 7 blocks, three
# 64^2 planes, c_dim 32) and LocalDecoder at its defaults (hidden 256, 5
# blocks); batches of 32 synthetic shapes (3000-point clouds, noise 0.005,
# 2048 query points, the config's data block); Adam at the JAX pipeline's
# 1e-4; a repeated batch for the loss check, then a timed run
CONVONET_CONFIG = "configs/convocc/pointcloud/shapenet_3plane.yaml"
CONVONET_BATCH, CONVONET_STEPS, CONVONET_TIMED = 32, 20, 10
# the voxel variant: LocalVoxelEncoder at c_dim 32, planes at 64, the plane
# UNet (depth 4, start_filts 32) and 'grid' through the UNet3D (f_maps 32,
# 3 levels) on 32^3 grids of batch 32
VOXEL_RES, VOXEL_STEPS = 32, 5
VOXEL_KWARGS = dict(plane_resolution=64, plane_type=("xz", "xy", "yz", "grid"), unet=True,
                    unet_depth=4, unet_start_filts=32, unet3d=True)
# the card (fp32, TF32 off in matmuls and cuDNN convolutions) against the
# port's fp32 CPU run at cut widths: max|err| <= REL * max(1, max|ref|).
# Convolution and matmul algorithms sum in other orders; the models' bar is
# wider for the batch-statistics norms of PointNet++ and for two Adam steps
CONVONET_OPS_REL, CONVONET_MODEL_REL = 1e-4, 1e-3


def voxel_batch(rng, b, res, n_points):
    """Synthetic ellipsoids voxelised on a res^3 grid of the padded unit
    cube (cell centres), with query points and their occupancies."""
    import numpy as np

    radii = rng.uniform(0.15, 0.4, (b, 1, 1, 1, 3)).astype(np.float32)
    c = (np.arange(res, dtype=np.float32) + 0.5) / res - 0.5
    grid = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)[None]
    vox = (np.sum((grid / radii) ** 2, -1) <= 1.0).astype(np.float32)
    pts = rng.uniform(-0.5, 0.5, (b, n_points, 3)).astype(np.float32)
    occ = (np.sum((pts / radii[:, 0, 0]) ** 2, -1) <= 1.0).astype(np.float32)
    return {"points": pts, "occ": occ, "inputs": vox}


def convonet_close(torch, got, ref, rel):
    """(max|err|, bar) of a card tensor against its CPU reference."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    if got.shape != ref.shape:
        raise AssertionError(f"shape {tuple(got.shape)} against {tuple(ref.shape)}")
    return (got - ref).abs().max().item(), rel * max(1.0, ref.abs().max().item())


def convonet_train(torch, dev, pipe, batches, steps, tag):
    """`steps` Adam steps on `batches` (a list, cycled): -> (losses, ms a
    step over the steps after the first, peak GiB, launches)."""
    state = pipe.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    read = reset_launches()
    losses, stamps = [], []
    for i in range(steps):
        state, m = pipe.train_step(state, batches[i % len(batches)])
        losses.append(m["loss"])
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    launches = read()
    ms = 1e3 * (stamps[-1] - stamps[0]) / max(1, steps - 1)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if not all(map(math.isfinite, losses)) or any(launches.values()):
        raise AssertionError(f"{tag}: losses {losses}, launches {launches}")
    return losses, ms, peak, launches


def convonet_phase(torch, dev):
    """Phase 46: the ConvONet of configs/convocc/pointcloud/shapenet_3plane.yaml
    at full width, built by ONetPipeline.from_convocc through the port's
    convocc reader: CONVONET_STEPS Adam steps on one repeated batch of 32
    synthetic shapes (finite, falling loss), a timed run of CONVONET_TIMED
    steps on fresh batches (steps/s, peak memory), eval_iou on a held-out
    batch, then one mesh through MeshGenerator at the config's generation
    block (resolution_0 64, 2 upsampling steps) from mesh_eval_fn: the
    encode, the decode per MISE round and the host's extraction timed.  No
    kernel of the six is on this path (JAX runs it outside Pallas): every
    counter stays 0.  -> launches."""
    import numpy as np

    from ddmi_tpu_torch.core.convocc_config import load_convocc_config
    from ddmi_tpu_torch.data.shapenet import SyntheticOccupancy
    from ddmi_tpu_torch.domains.onet import ONetPipeline
    from ddmi_tpu_torch.geometry.generation import MeshGenerator

    conv = load_convocc_config(os.path.join(ROOT, CONVONET_CONFIG))
    data = conv["data"]
    pipe = ONetPipeline.from_convocc(conv, device=dev, seed=46)
    n_params = sum(p.numel() for p in pipe.model.parameters())
    log(f"[convonet] {CONVONET_CONFIG}: {conv['model']['encoder']} {conv['model']['encoder_kwargs']}"
        f", c_dim {conv['model']['c_dim']}, LocalDecoder defaults; {n_params} parameters, fp32, "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
        f"{torch.backends.cudnn.allow_tf32}; batch {CONVONET_BATCH} x {data['pointcloud_n']} "
        f"points (noise {data['pointcloud_noise']}), {data['points_subsample']} queries")
    shapes = SyntheticOccupancy(CONVONET_BATCH, n_points=data["points_subsample"],
                                n_cloud=data["pointcloud_n"], length=CONVONET_TIMED + 2, seed=46)
    batches = list(shapes)
    losses, _, _, launches = convonet_train(torch, dev, pipe, batches[:1], CONVONET_STEPS,
                                            "convonet repeated batch")
    log(f"[convonet] {CONVONET_STEPS} steps on one batch: losses {losses[0]:.3f} -> "
        f"{losses[-1]:.3f} ({[round(v, 3) for v in losses[::5]]} every 5th); launches {launches}")
    if not losses[-1] < losses[0]:
        raise AssertionError("the ConvONet loss does not fall on a repeated batch")
    losses, ms, peak, more = convonet_train(torch, dev, pipe, batches[1:-1], CONVONET_TIMED,
                                            "convonet timed")
    log(f"[convonet] timed run of {CONVONET_TIMED} steps on fresh batches: {ms:.2f} ms a step "
        f"(after the first) = {1e3 / ms:.3f} steps/s = {CONVONET_BATCH * 1e3 / ms:.1f} shapes/s; "
        f"peak allocated {peak:.3f} GiB on {nvidia_smi()}")
    read = reset_launches()
    iou = pipe.eval_iou(batches[-1])
    log(f"[convonet] eval_iou of a held-out batch of {CONVONET_BATCH}: {iou:.4f}")
    if not 0.0 <= iou <= 1.0:
        raise AssertionError(f"IoU {iou}")
    gen = conv["generation"]
    cloud = torch.from_numpy(batches[-1]["inputs"][:1]).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn = pipe.mesh_eval_fn(cloud)
    torch.cuda.synchronize()
    encode_ms = 1e3 * (time.perf_counter() - t0)
    calls = []

    def timed_fn(points):
        t = time.perf_counter()
        out = fn(points)
        torch.cuda.synchronize()
        calls.append((points.shape[1], time.perf_counter() - t))
        return out

    mg = MeshGenerator(timed_fn, threshold=conv["test"]["threshold"],
                       resolution0=gen["resolution_0"], upsampling_steps=gen["upsampling_steps"],
                       device=str(dev))
    t0 = time.perf_counter()
    verts, tris = mg.generate()
    wall = time.perf_counter() - t0
    mesh_launches = read()
    decode_s = sum(t for _, t in calls)
    rounds = gen["upsampling_steps"] + 1
    log(f"[convonet] mesh at resolution_0 {gen['resolution_0']}, {gen['upsampling_steps']} "
        f"upsampling steps (threshold {conv['test']['threshold']}): {len(verts)} vertices, "
        f"{len(tris)} faces; encode {encode_ms:.2f} ms; decode {1e3 * decode_s:.1f} ms over "
        f"{len(calls)} calls of <= {mg.points_batch_size} points ({sum(n for n, _ in calls)} "
        f"points), {1e3 * decode_s / rounds:.1f} ms a MISE round ({rounds} rounds); host "
        f"extraction (octree, marching cubes) {wall - decode_s:.3f} s of {wall:.3f} s; launches "
        f"{mesh_launches}")
    if any(mesh_launches.values()) or not np.isfinite(verts).all():
        raise AssertionError("the ConvONet mesh failed")
    del pipe, batches
    torch.cuda.empty_cache()
    total = collections.Counter(launches)
    total.update(more)
    total.update(mesh_launches)
    return dict(total)


def voxel_convonet_phase(torch, dev):
    """Phase 47: the voxel variant at full width, LocalVoxelEncoder (c_dim
    32, planes at 64 from the 32^3 grid, the shared plane UNet at depth 4
    and 32 filters, 'grid' through the UNet3D at f_maps 32 and 3 levels)
    with LocalDecoder at its defaults, through VOXEL_STEPS ConvONet steps
    on batches of 32 32^3 grids: finite losses, no launch; ms a step and
    peak memory.  -> launches."""
    import numpy as np

    from ddmi_tpu_torch.domains.onet import ONetPipeline

    pipe = ONetPipeline(c_dim=32, encoder="voxel_simple_local", encoder_kwargs=VOXEL_KWARGS,
                        device=dev, seed=47)
    rng = np.random.default_rng(47)
    batches = [voxel_batch(rng, CONVONET_BATCH, VOXEL_RES, 2048) for _ in range(2)]
    losses, ms, peak, launches = convonet_train(torch, dev, pipe, batches, VOXEL_STEPS, "voxel")
    log(f"[voxel-convonet] LocalVoxelEncoder {VOXEL_KWARGS}, c_dim 32, "
        f"{sum(p.numel() for p in pipe.model.parameters())} parameters, batch {CONVONET_BATCH} "
        f"of {VOXEL_RES}^3: {VOXEL_STEPS} steps, losses {[round(v, 3) for v in losses]}, "
        f"{ms:.2f} ms a step (after the first), peak allocated {peak:.3f} GiB; launches "
        f"{launches}")
    with torch.no_grad():
        x = torch.from_numpy(batches[0]["inputs"]).to(dev)
        enc_ms = cuda_ms(lambda: pipe.model.encode_inputs(x), 3)
    log(f"[voxel-convonet] the encoder's forward {enc_ms:.2f} ms at batch {CONVONET_BATCH}")
    del pipe, batches
    torch.cuda.empty_cache()
    return launches


def pointnetpp_phase(torch, dev):
    """Phase 48: PointNet++ (c_dim 32) forward at batch 32 x 3000 points:
    ms (events), the features finite, no launch."""
    from ddmi_tpu_torch.nn.pointnetpp import PointNetPlusPlus

    torch.manual_seed(48)
    m = PointNetPlusPlus(c_dim=32).to(dev)
    g = torch.Generator(device=dev).manual_seed(48)
    xyz = torch.rand((CONVONET_BATCH, 3000, 3), generator=g, device=dev) - 0.5
    read = reset_launches()
    with torch.no_grad():
        _, feats = m(xyz)
        ms = cuda_ms(lambda: m(xyz), 3)
    launches = read()
    log(f"[pointnetpp] PointNet++ forward at batch {CONVONET_BATCH} x 3000 points: {ms:.2f} ms; "
        f"features {tuple(feats.shape)}, finite {bool(torch.isfinite(feats).all())}; launches "
        f"{launches}")
    if any(launches.values()) or not bool(torch.isfinite(feats).all()):
        raise AssertionError("PointNet++ failed")
    return launches


def convonet_reference_phase(torch, dev):
    """Phase 49: each new module and op on the card (fp32, TF32 off)
    against the port's fp32 CPU run on the same weights and inputs, at cut
    widths: the ConvONet of phase 46 (logits, two Adam steps' losses and
    parameters), the voxel variant with its plane UNet and UNet3D, the
    pointnet's plane UNet, PointNet++ (the farthest-point and ball-query
    indices equal, the features), and at small shapes upfirdn, the
    resampling StyleGAN blocks, the zeros-padded resample and grid_sample_3d
    (CONVONET_OPS_REL for the ops, CONVONET_MODEL_REL for the models)."""
    import numpy as np

    from ddmi_tpu_torch.data.shapenet import SyntheticOccupancy
    from ddmi_tpu_torch.domains.onet import ONetPipeline
    from ddmi_tpu_torch.nn import pointnetpp, stylegan
    from ddmi_tpu_torch.ops import grid_sample, resample, upfirdn

    rows = []

    def check(what, got, ref, rel):
        err, bar = convonet_close(torch, got, ref, rel)
        rows.append(f"{what} {err:.3g} (bar {bar:.3g})")
        if not err <= bar:
            raise AssertionError(f"{what}: max|err| {err} against {bar}")

    def pair(**kw):
        cpu = ONetPipeline(device="cpu", seed=49, **kw)
        gpu = ONetPipeline(device=dev, seed=49, **kw)
        gpu.model.load_state_dict(cpu.model.state_dict())
        return cpu, gpu

    read = reset_launches()
    cut = dict(c_dim=8, encoder_kwargs=dict(hidden_dim=32, plane_resolution=16, n_blocks=3,
                                            unet=True, unet_depth=2, unet_start_filts=8),
               decoder_kwargs=dict(hidden_size=32, n_blocks=3), lr=1e-3)
    cpu, gpu = pair(**cut)
    batch = next(iter(SyntheticOccupancy(2, n_points=256, n_cloud=300, length=1, seed=49)))
    with torch.no_grad():
        t = {k: torch.from_numpy(v) for k, v in batch.items()}
        check("convonet logits", gpu.model(t["points"].to(dev), t["inputs"].to(dev)),
              cpu.model(t["points"], t["inputs"]), CONVONET_MODEL_REL)
    cs, gs = cpu.init(), gpu.init()
    for i in range(2):
        cs, cm = cpu.train_step(cs, batch)
        gs, gm = gpu.train_step(gs, batch)
        check(f"convonet loss {i}", torch.tensor(gm["loss"]), torch.tensor(cm["loss"]),
              CONVONET_MODEL_REL)
    ref_sd = cpu.model.state_dict()
    check("convonet parameters after 2 steps",
          torch.cat([p.flatten().cpu() for p in gpu.model.state_dict().values()]),
          torch.cat([p.flatten() for p in ref_sd.values()]), CONVONET_MODEL_REL)

    vkw = dict(plane_resolution=16, plane_type=("xz", "xy", "yz", "grid"), unet=True,
               unet_depth=2, unet_start_filts=8, unet3d=True)
    cpu, gpu = pair(c_dim=8, encoder="voxel_simple_local", encoder_kwargs=vkw,
                    decoder_kwargs=dict(hidden_size=32, n_blocks=2))
    vb = voxel_batch(np.random.default_rng(49), 2, 8, 256)
    with torch.no_grad():
        p, v = torch.from_numpy(vb["points"]), torch.from_numpy(vb["inputs"])
        check("voxel convonet logits", gpu.model(p.to(dev), v.to(dev)), cpu.model(p, v),
              CONVONET_MODEL_REL)

    torch.manual_seed(49)
    pp = pointnetpp.PointNetPlusPlus(c_dim=16)
    ppg = pointnetpp.PointNetPlusPlus(c_dim=16).to(dev)
    ppg.load_state_dict(pp.state_dict())
    xyz = torch.from_numpy(np.random.default_rng(50).uniform(-0.5, 0.5, (2, 600, 3))
                           .astype(np.float32))
    fps_c = pointnetpp.farthest_point_sample(xyz, 512)
    fps_g = pointnetpp.farthest_point_sample(xyz.to(dev), 512)
    new = pointnetpp.index_points(xyz, fps_c)
    ball_c = pointnetpp.query_ball_point(0.2, 32, xyz, new)
    ball_g = pointnetpp.query_ball_point(0.2, 32, xyz.to(dev), new.to(dev))
    same = torch.equal(fps_g.cpu(), fps_c) and torch.equal(ball_g.cpu(), ball_c)
    rows.append(f"pointnet++ sampling and grouping indices equal {same}")
    if not same:
        raise AssertionError("PointNet++'s indices differ between the card and the CPU")
    with torch.no_grad():
        check("pointnet++ features", ppg(xyz.to(dev))[1], pp(xyz)[1], CONVONET_MODEL_REL)

    rng = np.random.default_rng(51)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, style, skip = f(2, 16, 16, 8), f(2, 6), f(2, 8, 8, 3)
    k = upfirdn.make_fir_kernel((1, 3, 3, 1))
    for up, down, pad in ((2, 1, (2, 1)), (1, 2, (1, 1)), (3, 1, (-1, -2))):
        check(f"upfirdn2d up {up} down {down} pad {pad}",
              upfirdn.upfirdn2d(x.to(dev), k.to(dev), up, down, pad),
              upfirdn.upfirdn2d(x, k, up, down, pad), CONVONET_OPS_REL)
    for kw in (dict(kernel_size=3), dict(kernel_size=3, upsample=True),
               dict(kernel_size=3, downsample=True)):
        mc = stylegan.ModulatedConv(8, 4, 6, **kw)
        with torch.no_grad():
            mc.modulation.bias.add_(f(8).mul(0.1))
            ref = mc(x, style)
            check(f"ModulatedConv {kw}", mc.to(dev)(x.to(dev), style.to(dev)), ref,
                  CONVONET_OPS_REL)
    torgb = stylegan.ToRGB(8, 3, 6)
    layer = stylegan.ConvLayer(8, 4, kernel_size=3, activate=True, bias=True)
    with torch.no_grad():
        ref_rgb, ref_layer = torgb(x, style, skip), layer(x)
        check("ToRGB with the upsampled skip",
              torgb.to(dev)(x.to(dev), style.to(dev), skip.to(dev)), ref_rgb, CONVONET_OPS_REL)
        check("ConvLayer k 3", layer.to(dev)(x.to(dev)), ref_layer, CONVONET_OPS_REL)
    plane, xs = f(2, 3, 9, 7), torch.linspace(-1.3, 1.3, 11)
    check("separable_grid_sample zeros",
          resample.separable_grid_sample(plane.to(dev), xs.to(dev), xs[:5].to(dev),
                                         padding_mode="zeros"),
          resample.separable_grid_sample(plane, xs, xs[:5], padding_mode="zeros"),
          CONVONET_OPS_REL)
    vol, grid = f(2, 4, 5, 6, 3), f(2, 50, 3).clamp(-1.2, 1.2)
    for mode in ("border", "zeros"):
        check(f"grid_sample_3d {mode}", grid_sample.grid_sample_3d(vol.to(dev), grid.to(dev),
                                                                   padding_mode=mode),
              grid_sample.grid_sample_3d(vol, grid, padding_mode=mode), CONVONET_OPS_REL)
    launches = read()
    log(f"[convonet-reference] the card (fp32; TF32 off in matmuls and cuDNN) against the CPU, "
        f"max|err| against max(1, max|ref|) x {CONVONET_OPS_REL} (ops) or "
        f"{CONVONET_MODEL_REL} (models): " + "; ".join(rows) + f"; launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"the ConvONet reference launched {launches}")


def convonet_phases(torch, dev):
    """Phases 46-49; -> their launches (all 0: no kernel of the six is on
    the ConvONet's path)."""
    total = collections.Counter()
    for fn in (convonet_phase, voxel_convonet_phase, pointnetpp_phase):
        total.update(fn(torch, dev))
        torch.cuda.empty_cache()
    convonet_reference_phase(torch, dev)
    torch.cuda.empty_cache()
    return dict(total)


class Laps:
    """lap(what) logs the seconds since the previous lap (or since the
    start) and the bytes this process has written so far."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, what):
        now = time.perf_counter()
        log(f"[clock] {what}: {now - self.t:.1f} s; written so far {write_bytes()}")
        self.t = now


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


def dist_yaml(tmp):
    """configs/ldm/celebahq.yaml at full width with the depth cut
    (DIST_UNET), synthetic data, one epoch (a checkpoint and the eval hook
    at its end)."""
    return cli_yaml(tmp, "configs/ldm/celebahq.yaml", "dist.yaml",
                    {"dataset": "synthetic", "mode": "train",
                     "extra": {"nan_check_every": 5, "steps_per_epoch": DIST_STEPS}},
                    {"unetconfig": DIST_UNET, "lossconfig": {"epochs": 1}})


def state_digest(torch, state) -> dict:
    """{name: SHA-1 of the bytes} of every tensor of a state dict (nested
    dicts and lists flattened), on the host."""
    import hashlib

    out = {}
    for k, v in flat_state(state).items():
        if torch.is_tensor(v):
            t = v.detach().cpu().reshape(-1)
            out[k] = hashlib.sha1(t.view(torch.uint8).numpy().tobytes()
                                  if t.dtype == torch.bfloat16 else t.numpy().tobytes()).hexdigest()
        else:
            out[k] = repr(v)
    return out


def dist_child(path: str, out: str) -> int:
    """Phase 50's torchrun rank (world size 1): the CLI's stage-2 training
    and gen on `path`, the one-rank FSDP2 micro-step against the plain one,
    a timed wrapped run; the results written as JSON to `out`."""
    import warnings

    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ddmi_tpu_torch import data as port_data
    from ddmi_tpu_torch.cli.main import main as cli
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.data.synthetic import SyntheticImages
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.parallel import distributed
    from ddmi_tpu_torch.parallel.mesh import (
        MeshSpec, gather_full, is_sharded, make_mesh, shard_module)

    res = {"env": {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                                  "MASTER_ADDR", "MASTER_PORT")}}
    tmp = os.path.dirname(path)
    real = port_data.SyntheticImages
    port_data.SyntheticImages = lambda bs, resolution, **kw: real(bs, resolution,
                                                                  length=DIST_STEPS, seed=11)
    captured = {}
    train_stage2 = Trainer.train_stage2

    def capture(self, *a, **kw):
        st = train_stage2(self, *a, **kw)
        captured["digest"] = state_digest(torch, gather_full(st.state_dict()))
        captured["sharded"] = sum(is_sharded(p) for p in st.params.values())
        captured["params"] = len(st.params)
        captured["backend"] = torch.distributed.get_backend()
        return st

    Trainer.train_stage2 = capture
    # a stage-1 checkpoint of the config's seeded VAE and INR, which stage 2
    # loads and gen reads (the CLI's stage 1 at full width is phase 37's)
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager

    cfg = load_config(path, exp="ldm")
    pipe = ImagePipeline(cfg, device=torch.device("cuda", int(os.environ["LOCAL_RANK"])),
                         seed=cfg.seed)
    CheckpointManager(tmp, prefix="stage1").save(0, {"state": {"params": {
        k: v.detach() for k, v in pipe.stage1_params().items()}}})
    del pipe
    read = reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cli(["--exp", "ldm", "--configs", path])
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    res["train_launches"] = read()
    res["fallback_warnings"] = sum("falling back to data=1" in str(w.message) for w in caught)
    Trainer.train_stage2 = train_stage2
    port_data.SyntheticImages = real
    res.update(captured)
    recs = [json.loads(line) for line in open(os.path.join(tmp, "train.jsonl"))]
    res["losses"] = [r["s2/loss"] for r in recs if "s2/loss" in r]
    res["hook_failures"] = sum("s2/eval_hook_failures" in r for r in recs)
    res["samples"] = sorted(os.listdir(os.path.join(tmp, "samples")))

    # one micro-step of the state wrapped over a one-rank shard mesh against
    # the unwrapped one, on the same batch and draws (accumulation 1, so that
    # the micro-step updates the parameters)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg1 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, lossconfig=dataclasses.replace(
        cfg.model.lossconfig, gradient_accumulate_every=1)))
    mesh = make_mesh(MeshSpec(1, 1, 1))
    x = torch.from_numpy(next(iter(SyntheticImages(cfg.data.batch_size, 256, length=1,
                                                   seed=12)))).to(dev)
    states = []
    for wrapped in (False, True):
        pipe = ImagePipeline(cfg1, device=dev, seed=cfg1.seed)
        perturb_zero_init(pipe.unet, 51)
        wrap = None
        if wrapped:
            def wrap(p):
                shard_module(p.unet, mesh, amp=p.amp)
        st = pipe.init_stage2(wrap=wrap)
        draws = pipe.stage2_draws(x.shape[0], torch.Generator(device=dev).manual_seed(13))
        st, m = pipe.stage2_train_step(st, x, **draws)
        states.append(({k: v.detach().float() for k, v in gather_full(dict(st.params)).items()},
                       float(m["loss"])))
        del pipe, st
        torch.cuda.empty_cache()
    (plain, loss_a), (shard, loss_b) = states
    lr = cfg.model.lr
    diff = {k: (plain[k] - shard[k]).abs() for k in plain}
    res["fsdp_step"] = {
        "losses": [loss_a, loss_b], "tensors": len(plain),
        "max_abs_diff": max(float(d.max()) for d in diff.values()),
        "differ": int(sum(int((d > 0).sum()) for d in diff.values())),
        "elements": int(sum(d.numel() for d in diff.values())),
        "over_2lr": int(sum(int((d > 2.02 * lr).sum()) for d in diff.values()))}
    del plain, shard, diff, states

    # the plain and the wrapped micro-step timed in turns (plain, wrapped,
    # wrapped, plain) on the same batches, steady over micro-steps
    # 2..DIST_TIMED, and the plain one's launches per micro-step
    batches = [torch.from_numpy(b).to(dev) for b in SyntheticImages(
        cfg.data.batch_size, 256, length=DIST_TIMED, seed=14)]
    runs = {}
    for wrapped in (False, True):
        pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed)
        wrap = None
        if wrapped:
            def wrap(p):
                shard_module(p.unet, mesh, amp=p.amp)
        runs[wrapped] = (pipe, pipe.init_stage2(wrap=wrap))

    def steady_ms(pipe, st):
        gen = torch.Generator(device=dev).manual_seed(15)
        for i, xb in enumerate(batches):
            pipe.stage2_train_step(st, xb, generator=gen)
            if i == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (len(batches) - 1)

    times = {False: [], True: []}
    for i, wrapped in enumerate((False, True, True, False)):
        read = reset_launches()
        times[wrapped].append(steady_ms(*runs[wrapped]))
        if i == 0:
            res["plain_per_step"] = {k: v // DIST_TIMED for k, v in read().items() if v}
    res["plain_ms"], res["wrapped_ms"] = times[False], times[True]
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(out, "w") as f:
        json.dump(res, f)
    distributed.destroy()
    return 0


def distribution_phase(torch, dev):
    """Phase 50 (see the module docstring).  -> the launches of the
    torchrun rank's CLI training run (its eval hook included)."""
    import tempfile

    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.domains.image import ImagePipeline

    tmp = tempfile.mkdtemp(prefix="dist_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        path = dist_yaml(tmp)
        out = os.path.join(tmp, "child.json")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
               os.path.abspath(__file__), "--dist-child", path, out]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, timeout=900)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0 or not os.path.exists(out):
            raise AssertionError(f"the torchrun rank exited {proc.returncode}")
        with open(out) as f:
            r = json.load(f)

        # the rank's checkpoint restored by a plain Trainer in this process
        cfg = load_config(path, exp="ldm")
        per_step = r["plain_per_step"]
        pipe = ImagePipeline(cfg, device=dev, seed=cfg.seed)
        t0 = time.perf_counter()
        restored = Trainer(cfg, pipe, []).load_stage2().state_dict()
        restore_s = time.perf_counter() - t0
        digest = state_digest(torch, restored)
        differ = sorted(k for k in r["digest"] if digest.get(k) != r["digest"][k])
        n_unet = sum(p.numel() for p in pipe.unet.parameters())
        nfe = cfg.model.ddpmconfig.sampling_timesteps
        r_, c = cfg.model.unetconfig.image_size, cfg.model.ddpmconfig.channels
        _, fused, _ = count_attention_blocks(
            torch, pipe.unet.to(torch.bfloat16), torch.zeros((1, c, r_, r_), device=dev),
            torch.zeros((1,), device=dev, dtype=torch.long))
        del pipe, restored
        torch.cuda.empty_cache()

        train = {k: v for k, v in r["train_launches"].items() if v}
        flash = {k: train.get(k, 0) for k in ("flash_attention", "flash_attention_bwd")}
        want_flash = {k: DIST_STEPS * per_step.get(k, 0) for k in flash}
        hook = {k: v for k, v in train.items() if k not in flash}
        want_hook = {"attn_block": fused * nfe, "inr_decode": 1}
        fs = r["fsdp_step"]
        log(f"[dist] torchrun rank {r['env']} ({r.get('backend')}): celebahq stage 2 at full "
            f"width, UNet cut to {DIST_UNET} ({n_unet} parameters), its mesh "
            f"{{data: 4, fsdp: 2}} fell back to data = 1 with {r['fallback_warnings']} "
            f"warning(s); {r.get('sharded')} of {r.get('params')} state tensors FSDP2 shards; "
            f"{len(r['losses'])} micro-steps in {r['train_s']:.1f} s through the CLI (build, "
            f"checkpoint and eval hook included), losses {[round(v, 5) for v in r['losses']]}")
        log(f"[dist] launches: training flash {flash} (the rank's plain micro-step's "
            f"{per_step} x {DIST_STEPS} = {want_flash}); eval hook {hook} (expected "
            f"{want_hook}, samples {r['samples']}, failures {r['hook_failures']})")
        log(f"[dist] one-rank FSDP2 micro-step against the unwrapped one (accumulation 1): "
            f"losses {fs['losses']}, parameters: {fs['differ']} of {fs['elements']} elements "
            f"differ, max |diff| {fs['max_abs_diff']:.3g} (Adam's first step moves each by "
            f"~lr = {cfg.model.lr}), {fs['over_2lr']} beyond 2 lr")
        plain_ms, wrapped_ms = (sum(r[k]) / len(r[k]) for k in ("plain_ms", "wrapped_ms"))
        log(f"[dist] micro-step time in the rank, in turns (plain, FSDP2, FSDP2, plain), "
            f"steady over micro-steps 2-{DIST_TIMED}: plain {r['plain_ms']} ms, FSDP2-wrapped "
            f"{r['wrapped_ms']} ms, means {plain_ms:.1f} and {wrapped_ms:.1f} (the wrapper's "
            f"overhead {wrapped_ms - plain_ms:+.1f} ms) on {nvidia_smi()}; the rank's peak "
            f"{r['peak_gib']:.2f} GiB; "
            f"the checkpoint restored by a plain Trainer in {restore_s:.2f} s: "
            f"{len(r['digest'])} entries, {len(differ)} differ {differ[:3]}; the torchrun "
            f"subprocess took {child_s:.1f} s")
        ok = (r["fallback_warnings"] == 1 and r.get("backend") == "nccl"
              and r["env"]["WORLD_SIZE"] == "1" and len(r["losses"]) == DIST_STEPS
              and all(math.isfinite(v) for v in r["losses"]) and flash == want_flash
              and all(want_flash.values()) and hook == want_hook and not r["hook_failures"]
              and (len(r["samples"]) == 2 or r["samples"] == ["ep0.npy"])
              and not differ and r.get("sharded") == r.get("params", 0) - 1
              and all(math.isfinite(v) for v in fs["losses"])
              and abs(fs["losses"][0] - fs["losses"][1]) <= 1e-3 * abs(fs["losses"][0])
              and fs["over_2lr"] == 0 and fs["differ"] <= 1e-3 * fs["elements"])
        if not ok:
            raise AssertionError("the distribution phase failed its checks")
        return train
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if len(sys.argv) == 4 and sys.argv[1] == "--dist-child":
        return dist_child(sys.argv[2], sys.argv[3])
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

    laps = Laps()
    image_kernel_phase(torch, dev)
    image = image_slice_phase(torch, dev)
    image_breakdown_phase(torch, dev)
    image_reference_phase(torch, dev)
    laps.lap("phases 3-5 (image sampling)")
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
    laps.lap("phases 6-9 (video sampling)")
    nerf_kernel_phase(torch, dev)
    nerf, svc = nerf_slice_phase(torch, dev)
    try:
        nerf_breakdown_phase(torch, dev, svc.pipe)
    finally:
        svc.close()
    del svc
    torch.cuda.empty_cache()
    nerf_reference_phase(torch, dev)
    nerf_wide = nerf_reference_phase(torch, dev, out_ch=NERF_WIDE_OUT_CH)
    torch.cuda.empty_cache()
    laps.lap("phases 10-13 (NeRF sampling)")
    train_kernel_phase(torch, dev)
    train = train_slice_phase(torch, dev)
    torch.cuda.empty_cache()
    train_reference_phase(torch, dev)
    torch.cuda.empty_cache()
    laps.lap("phases 14-16 (image stage-2 training)")
    occ, svc = occupancy_slice_phase(torch, dev)
    try:
        occupancy_breakdown_phase(torch, dev, svc)
        occupancy_reference_phase(torch, dev, svc)
    finally:
        svc.close()
    del svc
    torch.cuda.empty_cache()
    import tempfile

    laps.lap("phases 17-19 (occupancy)")
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

    laps.lap("phases 20-25 (image stage 1)")
    vtmp = tempfile.mkdtemp(prefix="video_train_smoke_", dir=os.path.join(ROOT, "build"))
    sub = Laps()  # each video training phase's seconds
    try:
        vpipe, vtrainer, vstate, v1_ms, v1_shapes = video_stage1_phase(torch, dev, vtmp)
        sub.lap("  phase 26 (video stage 1)")
        stage1_checkpoint_phase(torch, dev, vpipe, vtrainer, vstate, vtmp, data=Clips(1, 9),
                                watch="mlp.net_out.bias",
                                per_step={k: 1 for k in V1_LAUNCHES}, tag="v-stage1-ckpt")
        vrecon = video_reconstruct_phase(torch, dev, vpipe)
        del vpipe, vtrainer, vstate
        torch.cuda.empty_cache()
        sub.lap("  phase 27 (video checkpoint, reconstruct)")
        video_stage1_gan_phase(torch, dev, os.path.join(vtmp, "gan"), v1_ms)
        torch.cuda.empty_cache()
        sub.lap("  phase 28 (adversarial video stage 1)")
        vtrain2, v2_shapes = video_stage2_phase(torch, dev, vtmp)
        torch.cuda.empty_cache()
        sub.lap("  phase 29 (video stage 2)")
        shapes = {s: ("video-stage1", c) for s, c in v1_shapes.items()}
        shapes.update({s: ("video-stage2", c) for s, c in v2_shapes.items()})
        video_train_kernel_phase(torch, dev, shapes)
        torch.cuda.empty_cache()
        sub.lap("  phase 30 (video train kernels)")
        video_reference_train_phase(torch, dev)
        sub.lap("  phase 31 (video train reference)")
    finally:
        shutil.rmtree(vtmp, ignore_errors=True)
    vtrain1 = {k: V1_LAUNCHES.get(k, 0) for k in KERNELS}

    laps.lap("phases 26-31 (video training)")
    ttmp = tempfile.mkdtemp(prefix="threed_train_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        nerf_train_phase(torch, dev, os.path.join(ttmp, "nerf"))
        torch.cuda.empty_cache()
        _, _, o2_hook = occ_train_phase(torch, dev, os.path.join(ttmp, "occupancy"))
        torch.cuda.empty_cache()
        threed_reference_phase(torch, dev)
    finally:
        shutil.rmtree(ttmp, ignore_errors=True)

    laps.lap("phases 32-34 (3D training)")
    nets = metric_nets_phase(torch, dev)
    torch.cuda.empty_cache()
    fid_n = fid_timing_phase(torch, dev, nets)
    torch.cuda.empty_cache()
    ctmp = tempfile.mkdtemp(prefix="cli_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        cli = collections.Counter(fid_n)
        for fn in (cli_nerf_phase, cli_image_phase, cli_small_phase, convert_serve_phase):
            sub = os.path.join(ctmp, fn.__name__)
            os.makedirs(sub)
            cli.update(fn(torch, dev, sub))
            shutil.rmtree(sub, ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ctmp, ignore_errors=True)
    log(f"[cli] launches of FID-n at full width, the CLI's gen and eval runs and phases 40-41's "
        f"serving: {dict(cli)}; "
        f"metric networks {json.dumps(nets)}; this process has written {write_bytes()}")
    laps.lap("phases 35-41 (metric networks, FID, the CLI, serving)")
    den = denoiser_phases(torch, dev)
    laps.lap("phases 42-45 (the denoiser variants)")
    log(f"[denoisers] launches of phases 42-45: {den}; this process wrote {write_bytes()} in all")
    onet = convonet_phases(torch, dev)
    laps.lap("phases 46-49 (the standalone ConvONet)")
    dist = distribution_phase(torch, dev)
    laps.lap("phase 50 (distribution)")

    kernels = [LEDGER.entry(name, image[name] + video[name] + nerf[name] + train[name]
                            + occ[name] + recon[name] + vtrain1[name] + vrecon[name]
                            + vtrain2[name] + o2_hook.get(name, 0) + cli.get(name, 0)
                            + den.get(name, 0) + onet.get(name, 0) + nerf_wide[name]
                            + dist.get(name, 0))
               for name in KERNELS]
    log(f"[device] {nvidia_smi()}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
