"""Training, generation and evaluation on one device (counterpart of
ddmi_tpu/core/trainer.py: stage 1, stage 2, checkpoints, resume, the eval
hooks, `generate`, `evaluate` and the profiler window).

Feeds host batches through a prefetch thread, runs the pipeline's train
step, logs metrics deferred (one device read per chunk), and guards against
a non-finite loss every `data.extra.nan_check_every` steps.  Every
`save_and_sample_every` epochs and at the last one the state is saved
under `<save_dir>/stage1` or `<save_dir>/stage2` (core/checkpoint.py) with
the step generators' states, so that `resume=True` continues bit for bit
where the last checkpoint left off; stage 2 takes its stage-1 modules from
the newest stage-1 checkpoint in the save directory when there is one.

Under a process group (torchrun, parallel/distributed.py) the trainer runs
on `cfg.mesh` as the JAX trainer runs on its device mesh
(parallel/mesh.py: the sizes resolve as JAX's `make_mesh` resolves them,
with its fallback to data = number of ranks).  Each rank takes its rows of
the global batch (`shard_batch`, JAX's wrap-around pad), or the rows its
process-sharded loader gives it (batch_size / data a rank, so the global
batch is batch_size either way), and every micro-step's draws are made for
the global batch from the shared generator, each rank keeping its rows, so
that the step equals the one-process step on the same global batch.
Stage 2's denoiser is split by FSDP2 (`shard_module`: HSDP over
('data', 'fsdp'), JAX's placement rule) before the state is built, so the
EMA and the optimizer's moments are split with it; stage 1's modules and
discriminator are replicated (JAX's stage-1 configs ask for no fsdp, and
their losses read the weights outside the modules' forward: the amp casts
and the spectral-norm regulariser), their gradients averaged over the ranks
after the backward.  The PatchGANs' batch statistics are global
(losses/gan.py).  The logged metrics are the ranks' mean; only rank 0
writes logs, samples and checkpoints, which hold the full state and restore
at any world size.  `generate` and stage 2's `evaluate` sample the DDIM
latents data-parallel when mesh.data > 1 divides the count.  mesh.model > 1
raises ValueError.
The eval hooks run after each save: stage 1 reconstructs and logs PSNR
(image and video) or the IoU of one shape's query points (occupancy); stage
2 samples with the EMA weights and saves the samples (image and video) or
one mesh as `.off` (occupancy).  The NeRF branches do nothing, as in the
JAX trainer.  `generate` (the CLI's gen mode) samples with the EMA weights
of the newest checkpoints and writes the samples under
<save_dir>/generation; `evaluate` (its eval mode) runs each domain's
protocol (rFID, PSNR, IoU; FID, FVD, MMD / COV / 1-NNA), writes
<save_dir>/eval.json and checks the quality gates.  On the card both run
every model of the pipeline in bf16, as the sampling service does, so
that the sampling paths go through the port's kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import queue
import threading
import traceback
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ddmi_tpu_torch.core.checkpoint import CheckpointManager, stage1_weights
from ddmi_tpu_torch.core.metrics import MetricsLogger, ProfilerHook
from ddmi_tpu_torch.parallel import distributed
from ddmi_tpu_torch.parallel.mesh import (
    MeshSpec, RowDraws, all_gather_rows, data_coordinate, data_group, gather_full, is_fsdp,
    is_sharded, make_mesh, shard_batch, shard_module,
)
from ddmi_tpu_torch.utils.mesh_io import write_off


class NaNLossError(RuntimeError):
    """Raised when the training loss goes non-finite."""


class _Resumable:
    """A train state with the step generators whose states a checkpoint
    also keeps."""

    def __init__(self, state, *generators: torch.Generator):
        self.state, self.generators = state, generators

    def state_dict(self) -> dict:
        return {"state": self.state.state_dict(),
                "generators": [g.get_state() for g in self.generators]}

    def load_state_dict(self, sd: dict) -> None:
        self.state.load_state_dict(sd["state"])
        for g, st in zip(self.generators, sd["generators"]):
            g.set_state(st)


class Trainer:
    def __init__(self, cfg, pipeline, dataset, test_dataset=None,
                 save_dir: Optional[str] = None, mesh=None):
        self.cfg = cfg
        self.pipe = pipeline
        self.data = dataset
        self.test_data = test_dataset
        self.save_dir = save_dir or cfg.data.save_pth
        m = cfg.mesh
        if m.model > 1:
            raise ValueError(
                f"mesh.model={m.model}: tensor parallelism is not ported; the port's "
                f"hand-written kernels take whole tensors, and no config, test or reference "
                f"path of the repo uses the 'model' axis")
        # the mesh's sizes as JAX resolves them (warns once on its fallback)
        self.mesh = mesh if mesh is not None else make_mesh(
            MeshSpec(m.data, m.fsdp, m.model), device_type=pipeline.device.type)
        self.distributed = distributed.initialized()
        self.main = distributed.is_main()
        if self.main:
            os.makedirs(self.save_dir, exist_ok=True)
        distributed.barrier()
        self.logger = MetricsLogger(self.save_dir, write=self.main)
        # checking every step would wait on the card every step
        self.nan_check_every = int(cfg.data.extra.get("nan_check_every", 50))
        self.profile_steps = int(cfg.data.extra.get("profile_steps", 0))
        self._profiler: Optional[ProfilerHook] = None

    def _batches(self):
        """Iterate the dataset through a background prefetch thread (depth
        `data.extra.prefetch`, default 2; 0 disables), so that building the
        next batch on the host overlaps the card's work.  A loader error is
        raised again in the training thread."""
        depth = int(self.cfg.data.extra.get("prefetch", 2))
        if depth <= 0:
            yield from self.data
            return
        q: queue.Queue = queue.Queue(maxsize=depth)
        sentinel, failure = object(), []

        def worker():
            try:
                for item in self.data:
                    q.put(item)
            except BaseException as e:  # raised again in the training thread
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]

    def _steps_per_epoch(self) -> int:
        try:
            return max(1, len(self.data))
        except TypeError:
            spe = self.cfg.data.extra.get("steps_per_epoch")
            if spe is None:
                warnings.warn("dataset has no __len__ and data.extra.steps_per_epoch is "
                              "unset; assuming 1000 steps per epoch")
                return 1000
            return max(1, int(spe))

    def _put_batch(self, batch):
        """A host batch (an array, or a dict of arrays as the 3D loaders
        yield) on the pipeline's device."""
        if isinstance(batch, dict):
            return {k: self._put_batch(v) for k, v in batch.items()}
        return torch.as_tensor(batch).to(self.pipe.device, non_blocking=True)

    def _local_batch(self, batch):
        """(this rank's rows of a loader batch, the global batch size).  A
        loader built for one data rank's shard (num_processes > 1, as the
        CLI builds the image folders: batch_size / data rows a rank)
        already gives the rank its rows; any other loader gives every rank
        the global batch, of which the rank keeps its rows (padded by
        wrap-around as JAX pads)."""
        index, size = data_coordinate(self.mesh)
        lead = batch["inputs" if "inputs" in batch else next(iter(batch))] if isinstance(
            batch, dict) else batch
        b = int(np.shape(lead)[0])
        if getattr(self.data, "num_processes", 1) > 1:
            return batch, b * size
        local = shard_batch(batch, index, size, warn=not self._warned_pad)
        self._warned_pad = self._warned_pad or b % size != 0
        return local, b + (-b) % size

    _warned_pad = False

    def _mean_metrics(self, metrics: dict) -> dict:
        """The metrics averaged over the ranks (one all-reduce); each rank's
        are means over its rows."""
        if distributed.world_size() == 1:
            return metrics
        keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
        if keys:
            flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
            torch.distributed.all_reduce(flat)
            flat /= distributed.world_size()
            metrics = dict(metrics, **dict(zip(keys, flat.unbind())))
        return metrics

    def _global_like(self, batch, b: int):
        """Stand-ins of the global batch's shapes (meta tensors) for the
        draws of a batch whose rows are spread over the ranks."""
        if isinstance(batch, dict):
            return {k: self._global_like(v, b) for k, v in batch.items()}
        return torch.empty((b,) + tuple(np.shape(batch)[1:]), device="meta")

    def _stage1_step_fn(self, gen, host):
        """The stage-1 micro-step: the draws are made for the global batch
        and each rank keeps its rows (the image INR's noise as it is drawn,
        through RowDraws); in one process these are the pipeline's own
        draws, in its order."""
        pipe = self.pipe
        index, size = data_coordinate(self.mesh)

        def step(s, batch):
            local, b = self._local_batch(batch)
            if isinstance(batch, dict):
                draws = pipe.draw_stage1(self._global_like(local, b), gen)
            elif pipe.cfg.data.domain == "video":
                draws = pipe.draw_stage1(b, gen)
            else:
                draws = pipe.draw_stage1(b, gen, host)
            fields = {f.name: getattr(draws, f.name) for f in dataclasses.fields(draws)}
            draws = type(draws)(**shard_batch(fields, index, size, warn=False))
            if hasattr(draws, "noise") and draws.noise is None:
                draws.noise = RowDraws(gen, index, size)
            s, metrics = pipe.stage1_train_step(s, self._put_batch(local), generator=gen,
                                                host_generator=host, draws=draws)
            return s, self._mean_metrics(metrics)

        return step

    def _stage2_step_fn(self, gen):
        """The stage-2 micro-step: the draws (posterior eps, t, noise and the
        mask) are made for the global batch and each rank keeps its rows;
        in one process these are the pipeline's own draws, in its order."""
        pipe = self.pipe
        index, size = data_coordinate(self.mesh)

        def step(s, batch):
            local, b = self._local_batch(batch)
            draws = shard_batch(pipe.stage2_draws(b, gen), index, size, warn=False)
            s, metrics = pipe.stage2_train_step(s, self._put_batch(local), generator=gen,
                                                **draws)
            return s, self._mean_metrics(metrics)

        return step

    def _log_step(self, step: int, metrics, prefix: str) -> None:
        """Deferred logging and the throttled NaN guard."""
        self.logger.defer(step, metrics, prefix=prefix)
        if self.nan_check_every > 0 and step % self.nan_check_every == 0:
            rec = self.logger.flush()
            loss = (rec or {}).get(prefix + "loss")
            if loss is not None and not math.isfinite(loss):
                raise NaNLossError(f"non-finite loss at step {step}: {loss}")

    def _maybe_profile(self, step: int) -> None:
        """With data.extra.profile_steps > 0, a torch.profiler trace of the
        micro-steps after step 2 up to step 2 + profile_steps, written
        under <save_dir>/profile (core/metrics.py::ProfilerHook); once per
        trainer, on rank 0 alone under a process group."""
        if self.profile_steps <= 0 or not self.main:
            return
        if self._profiler is None:
            self._profiler = ProfilerHook(os.path.join(self.save_dir, "profile"), 2,
                                          self.profile_steps)
        self._profiler.step(step)
        if step >= 2 + self.profile_steps:
            self.profile_steps = 0

    def _say(self, msg: str) -> None:
        if self.main:
            print(msg, flush=True)

    def _maybe_resume(self, ckpt: CheckpointManager, resumable: _Resumable, resume: bool,
                      tag: str) -> None:
        if resume and ckpt.latest_step() is not None:
            ckpt.restore(resumable)
            self._say(f"resumed {tag} from step {resumable.state.step}")

    def _epochs(self, state, resumable, ckpt, step_fn, epochs, prefix, eval_hook, save):
        """The epoch loop shared by both stages: step, log, then save (and
        run the eval hook) every save_and_sample_every epochs and at the
        last, unless `save` is off."""
        save_every = self.pipe.lc.save_and_sample_every
        step = state.step
        for epoch in range(epochs):
            for batch in self._batches():
                state, metrics = step_fn(state, batch)
                step += 1
                self._log_step(step, metrics, prefix)
                self._maybe_profile(step)
            self.logger.flush()
            if save and (epoch % save_every == 0 or epoch == epochs - 1):
                ckpt.save(state.step, resumable, overwrite=True)
                if eval_hook is not None:
                    eval_hook(self, state, epoch)
        if self._profiler is not None:
            self._profiler.close(step)
        return state

    def train_stage1(self, epochs: Optional[int] = None, eval_hook: Optional[Callable] = None,
                     resume: bool = False):
        """Stage-1 training of the pipeline's stage-1 modules (and, for the
        adversarial configs, its discriminator) over `epochs` passes of the
        dataset (lossconfig.epochs when None).  The weights are the
        pipeline's own (the JAX trainer draws them from cfg.seed, the seed
        to build the pipeline with); the micro-step draws come from a
        generator on the device and one on the host, both seeded
        cfg.seed + 1 (the JAX trainer's step stream).  `eval_hook(trainer,
        state, epoch)` runs after each save (default_stage1_eval_hook when
        None).  Returns the final Stage1State."""
        spe = self._steps_per_epoch()
        state = self.pipe.init_stage1(spe)
        gen = torch.Generator(device=self.pipe.device).manual_seed(self.cfg.seed + 1)
        host = torch.Generator().manual_seed(self.cfg.seed + 1)
        resumable = _Resumable(state, gen, host)
        ckpt = CheckpointManager(self.save_dir, prefix="stage1")
        self._maybe_resume(ckpt, resumable, resume, "stage1")
        epochs = epochs or self.pipe.lc.epochs
        self._say(f"[s1/] {epochs} epoch(s) of {spe} micro-steps on {self.pipe.device}")
        step_fn = self._stage1_step_fn(gen, host)
        return self._epochs(state, resumable, ckpt, step_fn, epochs, "s1/",
                            default_stage1_eval_hook if eval_hook is None else eval_hook, True)

    def load_stage1(self) -> int:
        """Load the stage-1 modules (`pipe.stage1_modules`: the VAE and the
        INR, and the pointnet of the 3D domains) of the newest stage-1
        checkpoint in the save directory into the pipeline; -> its step."""
        step, weights = stage1_weights(self.save_dir, self.pipe.stage1_modules)
        for name, sd in weights.items():
            getattr(self.pipe, name).load_state_dict(sd)
        return step

    def train_stage2(self, epochs: Optional[int] = None, resume: bool = False,
                     save: bool = True, eval_hook: Optional[Callable] = None):
        """Stage-2 training of the pipeline's UNet and mixing logit over
        `epochs` passes of the dataset (lossconfig.epochs when None); the
        frozen stage-1 encoder makes the latents.  The stage-1 modules come
        from the newest stage-1 checkpoint in the save directory when there is
        one (the JAX trainer's load_stage1_params), else they are the
        pipeline's own; the UNet's weights are the pipeline's (the JAX
        trainer draws them from cfg.seed, the seed to build the pipeline
        with).  The step draws (posterior eps, t, noise) come from a
        torch.Generator seeded cfg.seed + 2, the JAX trainer's step stream.
        `save=False` writes no checkpoint (and runs no eval).
        `eval_hook(trainer, state, epoch)` runs after each save
        (default_stage2_eval_hook when None).  Returns the final
        Stage2State."""
        if CheckpointManager(self.save_dir, prefix="stage1").latest_step() is not None:
            step = self.load_stage1()
            self._say(f"[s2/] stage-1 weights from step {step} of "
                      f"{os.path.join(self.save_dir, 'stage1')}")
        wrap = None
        if self.distributed:
            def wrap(pipe):
                # FSDP2 reduces what it splits; the rest (the mixing logit and
                # the leaves JAX keeps whole) the pipeline averages after the
                # backward (reduce_grads)
                shard_module(pipe.unet, self.mesh, amp=pipe.amp)
        state = self.pipe.init_stage2(wrap=wrap)
        gen = torch.Generator(device=self.pipe.device).manual_seed(self.cfg.seed + 2)
        resumable = _Resumable(state, gen)
        ckpt = CheckpointManager(self.save_dir, prefix="stage2")
        self._maybe_resume(ckpt, resumable, resume, "stage2")
        epochs = epochs or self.pipe.lc.epochs
        self._say(f"[s2/] {epochs} epoch(s) of {self._steps_per_epoch()} micro-steps on "
                  f"{self.pipe.device}")
        step_fn = self._stage2_step_fn(gen)
        return self._epochs(state, resumable, ckpt, step_fn, epochs, "s2/",
                            default_stage2_eval_hook if eval_hook is None else eval_hook, save)

    def load_stage1_params(self) -> dict:
        """The stage-1 modules of the newest stage-1 checkpoint, loaded into
        the pipeline; -> their parameters by name (`pipe.stage1_params()`),
        the frozen weights alone: no optimizer or spectral-norm state stays
        on the card."""
        self.load_stage1()
        return self.pipe.stage1_params()

    def load_stage2(self):
        """The newest stage-2 checkpoint restored whole into a fresh state
        (`pipe.init_stage2()`: the UNet and mixing logit, their EMA and the
        optimizer), as the JAX trainer restores it; -> the Stage2State."""
        state = self.pipe.init_stage2()
        saved = CheckpointManager(self.save_dir, prefix="stage2").restore()
        state.load_state_dict(saved["state"])
        return state

    @torch.no_grad()
    def generate(self, n: Optional[int] = None, resolution: Optional[int] = None):
        """The CLI's gen mode: sample n (data.test_batch_size when None) with
        the EMA weights of the newest stage-2 checkpoint and the stage-1
        modules of the newest stage-1 one, from a generator on the
        pipeline's device seeded cfg.seed, and save under <save_dir>:
        image, `generation_<i>.png` at `resolution` (data.test_resolution
        when None); video, each clip's frames as `generation/video_<i>_<f>`;
        occupancy, `generation/mesh_<i>.off`, the meshes extracted in one
        lockstep group (refined when the convocc config asks for it);
        NeRF, each scene's 8 views on the spherical path at `resolution`^2
        (128 when None) as `generation/nerf_<i>_<v>`.  Images are PNGs, or
        one `.npy` per prefix without PIL.  The DDIM runs data-parallel
        under a process group (`sample_latents`); rank 0 writes.  -> the
        samples (numpy), or the meshes."""
        self.load_stage1()
        state = self.load_stage2()
        pipe, cfg = self.pipe, self.cfg
        n = n or cfg.data.test_batch_size
        g = torch.Generator(device=pipe.device).manual_seed(cfg.seed)
        out_dir = os.path.join(self.save_dir, "generation")
        domain = cfg.data.domain
        with sampling_weights(pipe, state):
            z = self.sample_latents(n, g)
            if domain == "image":
                res = resolution or cfg.data.test_resolution
                out = pipe.decode_latents(z, resolution=res).cpu().numpy()
                self._save_images(out, out_dir)
                return out
            if domain == "video":
                out = pipe.decode_videos(z).cpu().numpy()
                for i, vid in enumerate(out):
                    self._save_images(vid, os.path.join(out_dir, f"video_{i}"))
                return out
            if domain == "occupancy":
                meshes = pipe.extract_meshes(z)
                if self.main:
                    os.makedirs(out_dir, exist_ok=True)
                    for i, (verts, tris) in enumerate(meshes):
                        write_off(os.path.join(out_dir, f"mesh_{i}.off"), verts, tris)
                return meshes
            if domain == "nerf":
                res = resolution or 128
                out = pipe.render_nerfs(z, H=res, W=res).cpu().numpy()
                for i, views in enumerate(out):
                    self._save_images(views, os.path.join(out_dir, f"nerf_{i}"))
                return out
        raise NotImplementedError(domain)

    def sample_latents(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """The pipeline's DDIM latents for n samples from `generator`: the
        global batch's initial noise, of which each data rank samples its
        rows, and every rank gathers the rows (JAX's `_sample_jit` splits
        the batch over 'data' the same way), so the latents are the
        one-process run's.  Where mesh.data does not divide n, or DDIM's eta
        is not 0 (its steps then draw per row), every rank samples the
        whole batch."""
        pipe = self.pipe
        index, size = data_coordinate(self.mesh)
        if n % size or pipe.gd.ddim_sampling_eta != 0.0:
            return pipe.sample_latents(n, generator=generator)
        noise = torch.randn(pipe.latent_noise_shape(n), generator=generator,
                            device=pipe.device)
        z = pipe.sample_latents(n // size, noise=shard_batch(noise, index, size))
        return all_gather_rows(z, data_group(self.mesh))

    def _metric_net(self, cls, key: str, from_jax, what: str):
        """A metric network on the pipeline's device: its weights from
        data.extra.<key>, an `.npz` of JAX parameters under "params" (the
        JAX package's format, mapped by interop.py), else drawn from a
        generator seeded 0 with a loud warning."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = cls()
        pth = self.cfg.data.extra.get(key)
        if pth and os.path.exists(pth):
            model.load_state_dict(from_jax(np.load(pth, allow_pickle=True)["params"].item()))
        else:
            warnings.warn(f"no converted {cls.__name__} weights (data.extra.{key}); {what} "
                          f"computed with a random-init network (seed 0), NOT comparable to "
                          f"published numbers", stacklevel=3)
        return model

    def _image_scorer(self):
        """The InceptionV3 FIDScorer (data.extra.inception_pth)."""
        from ddmi_tpu_torch.evals.fid import FIDScorer
        from ddmi_tpu_torch.evals.inception import InceptionV3
        from ddmi_tpu_torch.interop import inception_from_jax

        model = self._metric_net(InceptionV3, "inception_pth", inception_from_jax, "rFID/FID")
        return FIDScorer(model, device=self.pipe.device)

    def _video_scorer(self):
        """The I3D FVDScorer (data.extra.i3d_pth)."""
        from ddmi_tpu_torch.evals.fvd import FVDScorer
        from ddmi_tpu_torch.evals.i3d import I3D
        from ddmi_tpu_torch.interop import i3d_from_jax

        return FVDScorer(self._metric_net(I3D, "i3d_pth", i3d_from_jax, "FVD"),
                         device=self.pipe.device)

    def evaluate(self, exp: str) -> dict:
        """The CLI's eval mode: each domain's protocol on the test loader (the
        training one without a test set), with data.extra.eval_samples
        (default 64) samples, loudly below the reference protocol's count.
        d2c-vae (the stage-1 modules of the newest checkpoint): image rFID
        of reconstructions, video PSNR, occupancy IoU of the query points
        (and `iou_voxels` where the batches carry binvox grids), NeRF PSNR
        of one view of each of 4 scenes.  ldm (with the EMA weights of the
        newest stage-2 checkpoint as well): image FID over eval_samples
        samples, video FVD over data.extra.fvd_samples clips, occupancy
        MMD / COV / 1-NNA of eval_samples meshes extracted in lockstep
        groups of data.extra.mesh_batch (8; the last group padded), NeRF
        one `generate(n=1)`.  Each posterior, render and sampling draw
        comes from a generator on the device seeded as the JAX trainer
        keys it (0, or the batch's index).  The results are logged (eval/),
        checked against data.extra.quality_gates (evals/gates.py) and
        written to <save_dir>/eval.json; a failed gate then raises
        SystemExit.  -> the results."""
        cfg, pipe = self.cfg, self.pipe
        dev = pipe.device
        domain = cfg.data.domain
        data = self.test_data if self.test_data is not None else self.data
        n_eval = int(cfg.data.extra.get("eval_samples", 64))
        protocol = {"image": 10000, "video": 2048, "occupancy": 5000, "nerf": 64}.get(domain,
                                                                                     n_eval)
        if n_eval < protocol:
            print(f"eval: data.extra.eval_samples={n_eval} — REFERENCE PROTOCOL IS {protocol} "
                  f"for domain '{domain}'; results are not comparable to published numbers "
                  f"until raised")
        gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
        results = {}
        self.load_stage1()
        if exp == "d2c-vae":
            max_batches = max(1, n_eval // cfg.data.batch_size)
            if domain in ("image", "video"):
                def recon(x):
                    with torch.no_grad():
                        x = torch.as_tensor(np.asarray(x)).to(dev)
                        return pipe.reconstruct(x, generator=gen(0)).cpu().numpy()
            if domain == "image":
                from ddmi_tpu_torch.evals.fid import test_rfid

                results["rfid"] = test_rfid(self._image_scorer(), recon, data,
                                            max_batches=max_batches)
            elif domain == "video":
                from ddmi_tpu_torch.evals.fvd import psnr

                results["psnr"] = psnr(recon, data, max_batches=max_batches)
            elif domain == "occupancy":
                results.update(self._occupancy_iou(data, n_eval))
            elif domain == "nerf":
                results["psnr"] = self._nerf_psnr(data)
        else:
            if domain == "nerf":
                self.generate(n=1)
                results["generated"] = 1.0
            else:
                state = self.load_stage2()
                with sampling_weights(pipe, state):
                    results.update(self._sample_metrics(data, n_eval, protocol))
        self.logger.log(0, results, prefix="eval/")

        gates = cfg.data.extra.get("quality_gates") or {}
        if gates:
            from ddmi_tpu_torch.evals.gates import check_gates

            passed, detail = check_gates(results, gates)
            results["gates"] = detail
            results["gates_passed"] = passed
            print(f"quality gates: {'PASS' if passed else 'FAIL'}")
            for name, d in detail.items():
                if d["value"] is None:
                    print(f"  {name}: FAIL — {d['reason']}")
                    continue
                print(f"  {name}: {d['value']:.6g} vs published {d['published']:.6g} "
                      f"(±{d['tol_pct']}%, {d['direction']}) -> "
                      f"{'pass' if d['passed'] else 'FAIL'}")
        if self.main:
            with open(os.path.join(self.save_dir, "eval.json"), "w") as f:
                json.dump(results, f)
            print("eval results:", results)
        if gates and not results["gates_passed"]:
            raise SystemExit("quality gates FAILED — see eval.json for detail")
        return results

    @torch.no_grad()
    def _occupancy_iou(self, data, n_eval: int) -> dict:
        """Stage-1 occupancy: the IoU of logits > 0 against occ > 0.5 at each
        batch's query points, the posterior drawn from a generator seeded by
        the batch's index; with binvox grids in the batches, the voxel IoU
        of each shape (its posterior from a generator seeded 0)."""
        from ddmi_tpu_torch.evals.metrics_3d import voxel_iou

        pipe, dev = self.pipe, self.pipe.device
        ious, voxel_ious = [], []
        for i, b in enumerate(data):
            if i * self.cfg.data.batch_size >= n_eval:
                break
            inputs = torch.as_tensor(np.asarray(b["inputs"])).to(dev)
            eps = pipe.posterior_eps(inputs.shape[0], torch.Generator(device=dev).manual_seed(i))
            logits = pipe.occupancy_logits(inputs, torch.as_tensor(np.asarray(b["points"])), eps)
            pred = logits.float().cpu().numpy() > 0
            occ = np.asarray(b["occ"]) > 0.5
            ious.append(np.logical_and(pred, occ).sum() / max(np.logical_or(pred, occ).sum(), 1))
            if "voxels" in b:
                for j in range(inputs.shape[0]):
                    def fn(pts, j=j):
                        eps = pipe.posterior_eps(1, torch.Generator(device=dev).manual_seed(0))
                        return pipe.occupancy_logits(inputs[j : j + 1],
                                                     torch.as_tensor(pts)[None], eps)[0]
                    voxel_ious.append(voxel_iou(fn, np.asarray(b["voxels"][j])))
        out = {"iou": float(np.mean(ious))}
        if voxel_ious:
            out["iou_voxels"] = float(np.mean(voxel_ious))
        return out

    @torch.no_grad()
    def _nerf_psnr(self, data) -> float:
        """Stage-1 NeRF: encode the first cloud of each of 4 test batches
        (its posterior from a generator seeded by the batch's index),
        decode, render its view at the view's size without perturbation,
        and average the PSNRs.  On the card the models run in bf16, the
        render through the NeRF MLP kernel."""
        pipe, dev = self.pipe, self.pipe.device
        vals = []
        with card_dtype(pipe, pipe.stage1_modules):
            for i, b in enumerate(data):
                if i >= 4:
                    break
                eps = pipe.posterior_eps(1, torch.Generator(device=dev).manual_seed(i))
                z, _ = pipe.encode(torch.as_tensor(np.asarray(b["points"])[:1]), eps)
                img = np.asarray(b["image"])[0]
                H, W = img.shape[:2]
                pose = torch.as_tensor(np.asarray(b["pose"])[0]).float().to(dev)
                rgb = pipe.render_image(pipe.decode_planes(z), pose, H, W).cpu().numpy()
                mse = float(np.mean((rgb - img) ** 2))
                vals.append(-10 * np.log10(max(mse, 1e-12)))
        return float(np.mean(vals))

    def _sample_metrics(self, data, n_eval: int, protocol: int) -> dict:
        """Stage 2's sample metrics, inside sampling_weights: image FID,
        video FVD, occupancy MMD / COV / 1-NNA."""
        cfg, pipe = self.cfg, self.pipe
        dev = pipe.device
        domain = cfg.data.domain
        if domain == "image":
            from ddmi_tpu_torch.evals.fid import test_fid_n

            bs = cfg.data.test_batch_size
            res = min(cfg.data.test_resolution, 256)
            reals = []
            for i, b in enumerate(data):
                if i * cfg.data.batch_size >= n_eval:
                    break
                reals.append(np.asarray(b))
            return {"fid": test_fid_n(
                self._image_scorer(),
                lambda g: pipe.decode_latents(self.sample_latents(bs, g), resolution=res),
                reals, n_samples=n_eval, batch=bs,
                generator=torch.Generator(device=dev).manual_seed(0), protocol_n=protocol)}
        if domain == "video":
            from ddmi_tpu_torch.evals.fvd import test_fvd_sample

            scorer = self._video_scorer()
            reals = []
            for i, b in enumerate(data):
                if i >= max(1, n_eval // 4):
                    break
                reals.append(np.asarray(b))
            n_fvd = int(cfg.data.extra.get("fvd_samples", n_eval))
            print(f"FVD: {n_fvd} generated clips vs {len(reals)} real batches (reference "
                  f"runs the full test loader, evals/eval.py:254-345)")

            def sample(g):
                with torch.no_grad():
                    return pipe.decode_videos(self.sample_latents(1, g))

            return {"fvd": test_fvd_sample(scorer, sample, reals, n_samples=n_fvd,
                                           generator=torch.Generator(device=dev).manual_seed(0))}
        if domain == "occupancy":
            return self._occupancy_mmd(data, n_eval)
        raise NotImplementedError(domain)

    def _occupancy_mmd(self, data, k: int) -> dict:
        """k latents sampled at once (a generator seeded 0), their meshes
        extracted in lockstep groups of data.extra.mesh_batch, the last
        group padded to the group's size with inactive slots, 2048 surface
        points of each non-empty mesh against the first 2048 points of k
        test clouds: MMD, COV and 1-NNA (evals/metrics_3d.py) on the
        pipeline's device.  Skipped, with a message, when either side is
        empty."""
        from ddmi_tpu_torch.evals.metrics_3d import mmd_cov_1nna
        from ddmi_tpu_torch.geometry.generation import sample_surface_points

        pipe = self.pipe
        print(f"occupancy eval: generating {k} meshes (reference protocol: 5000 generated, "
              f"1355x1355 MMD pairs — tools/ldm/occupancy.py:204-219)")
        with torch.no_grad():
            z = self.sample_latents(k, torch.Generator(device=pipe.device).manual_seed(0))
        group = max(1, min(k, int(self.cfg.data.extra.get("mesh_batch", 8))))
        gen_pts = []
        for g0 in range(0, k, group):
            zg = z[g0 : g0 + group]
            real = int(zg.shape[0])
            if real < group:  # the last group: pad to the group's size
                zg = torch.cat([zg] + [zg[-1:]] * (group - real), 0)
            for verts, tris in pipe.extract_meshes(zg, real):
                if len(tris):
                    gen_pts.append(sample_surface_points(verts, tris, 2048))
            print(f"occupancy eval: mesh {min(g0 + group, k)}/{k}")
        ref_pts = []
        for b in data:
            if len(ref_pts) >= k:
                break
            inputs = np.asarray(b["inputs"])
            ref_pts.extend(inputs[j, :2048] for j in range(inputs.shape[0]))
        if gen_pts and ref_pts:
            m = mmd_cov_1nna(np.stack(ref_pts[:k]), np.stack(gen_pts), device=pipe.device)
            return {key: float(v) for key, v in m.items()}
        print(f"occupancy eval: MMD/COV skipped — {len(gen_pts)} non-empty generated meshes, "
              f"{len(ref_pts)} reference clouds")
        return {}

    @staticmethod
    def _save_images(imgs: np.ndarray, prefix: str) -> None:
        """PNGs `<prefix>_<i>.png` when PIL is there, else one `<prefix>.npy`
        (rank 0 alone under a process group)."""
        if not distributed.is_main():
            return
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        try:
            from PIL import Image
        except ImportError:
            np.save(prefix + ".npy", imgs)
            return
        for i, im in enumerate(imgs):
            Image.fromarray((np.clip(im, 0, 1) * 255).astype("uint8")).save(f"{prefix}_{i}.png")


def _first_test_batch(trainer: Trainer):
    data = trainer.test_data if trainer.test_data is not None else trainer.data
    for batch in data:
        return batch
    return None


def _psnr(recon: torch.Tensor, ref: torch.Tensor) -> float:
    mse = float(((recon - ref) ** 2).mean())
    return -10.0 * math.log10(max(mse, 1e-12))


def default_stage1_eval_hook(trainer: Trainer, state, epoch: int) -> None:
    """The stage-1 eval after each save, on the first test batch (or the
    first training batch without a test set), with eps drawn from a
    generator seeded 0.  Image: reconstruct 4 images at the anchor
    resolution, log their PSNR against the images as eval/psnr (NaN when
    the images are of another size, as in the JAX trainer), and save them
    under <save_dir>/recon/ep<epoch>.  Video: reconstruct 2 clips and log
    their PSNR as eval/psnr.  Occupancy: encode the first shape's cloud,
    evaluate its query points on the fp32 masters and log the IoU of
    logits > 0 against occ > 0.5 as eval/iou.  NeRF: nothing.  A failure is
    warned about and counted (s1/eval_hook_failures), never raised, as in
    the JAX trainer."""
    domain = trainer.cfg.data.domain
    if domain not in ("image", "video", "occupancy"):
        return
    batch = _first_test_batch(trainer)
    if batch is None:
        return
    try:
        pipe = trainer.pipe
        g = torch.Generator(device=pipe.device).manual_seed(0)
        if domain == "occupancy":
            b = {k: torch.as_tensor(np.asarray(v)[:1]).to(pipe.device) for k, v in batch.items()}
            eps = pipe.posterior_eps(1, g)
            pred = pipe.occupancy_logits(b["inputs"], b["points"], eps) > 0
            occ = b["occ"] > 0.5
            inter = int((pred & occ).sum())
            union = int((pred | occ).sum())
            trainer.logger.log(state.step, {"iou": inter / max(union, 1)}, prefix="eval/")
            return
        if domain == "video":
            x = torch.as_tensor(np.asarray(batch)[:2]).to(pipe.device)
            recon = pipe.reconstruct(x, generator=g)
            trainer.logger.log(state.step, {"psnr": _psnr(recon, x.float())}, prefix="eval/")
            return
        x = torch.as_tensor(np.asarray(batch)[:4]).to(pipe.device)
        recon = pipe.reconstruct(x, generator=g)
        psnr = _psnr(recon, x.float()) if recon.shape == x.shape else float("nan")
        trainer.logger.log(state.step, {"psnr": psnr}, prefix="eval/")
        trainer._save_images(recon.cpu().numpy(),
                             os.path.join(trainer.save_dir, "recon", f"ep{epoch}"))
    except Exception as e:  # an eval must never end a training run
        warnings.warn(f"stage1 eval hook failed: {e}\n{traceback.format_exc()}")
        trainer.logger.log(epoch, {"eval_hook_failures": 1.0}, prefix="s1/")


@contextlib.contextmanager
def ema_weights(pipe, state):
    """Inside the block the pipeline's UNet and mixing logit hold the EMA
    weights, the UNet cast to bf16 on the card (the dtype the sampling
    kernels take, as the sampling service casts it) and fp32 on the CPU;
    after it the trained fp32 parameters are back, bit for bit (the same
    tensors, so the optimizer keeps them).  A UNet split by FSDP2 goes
    through `_sharded_ema_weights`."""
    if is_fsdp(pipe.unet):
        with _sharded_ema_weights(pipe, state):
            yield pipe
        return
    saved = {k: p.detach().clone() for k, p in state.params.items()}
    try:
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(state.ema[k])
        if pipe.device.type == "cuda":
            pipe.unet.to(torch.bfloat16)
        yield pipe
    finally:
        pipe.unet.float()
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(saved[k])


@contextlib.contextmanager
def _sharded_ema_weights(pipe, state):
    """`ema_weights` for a UNet split by FSDP2 (every rank enters it): the
    EMA is gathered whole, the UNet unsharded and its unsharded parameters
    (the forward's: bf16 under amp) take the EMA; resharding drops them,
    and the trained shards were never touched.  The plain tensors (the
    mixing logit, the leaves kept whole) are swapped and restored."""
    full = gather_full(dict(state.ema))
    plain = {k: p for k, p in state.params.items() if not is_sharded(p)}
    saved = {k: p.detach().clone() for k, p in plain.items()}
    pipe.unet.unshard()
    try:
        with torch.no_grad():
            unsharded = dict(pipe.unet.named_parameters())
            for k in state.params:
                dst = plain[k] if k in plain else unsharded[k[len("unet."):]]
                dst.copy_(full[k])
        yield pipe
    finally:
        pipe.unet.reshard()
        with torch.no_grad():
            for k, p in plain.items():
                p.copy_(saved[k])


@contextlib.contextmanager
def card_dtype(pipe, names):
    """On the card, the pipeline's modules `names` in bf16 inside the block
    (the dtype the sampling kernels take, as the sampling service casts
    them); after it each of their parameters and buffers holds the very
    tensor it held before.  On the CPU nothing changes."""
    if pipe.device.type != "cuda":
        yield pipe
        return
    modules = [getattr(pipe, name) for name in names]
    saved = [(t, t.data) for m in modules for t in (*m.parameters(), *m.buffers())]
    try:
        for m in modules:
            m.to(torch.bfloat16)
        yield pipe
    finally:
        for t, data in saved:
            t.data = data


@contextlib.contextmanager
def sampling_weights(pipe, state):
    """`ema_weights`, and on the card the stage-1 modules in bf16
    (`card_dtype`): the weights `generate` and stage 2's `evaluate` sample
    with."""
    with ema_weights(pipe, state), card_dtype(pipe, pipe.stage1_modules):
        yield pipe


def default_stage2_eval_hook(trainer: Trainer, state, epoch: int) -> None:
    """The stage-2 eval after each save: sample with the EMA weights from a
    generator seeded cfg.seed + 100 + epoch and save the samples under
    <save_dir>/samples/: image, 2 images at min(test_resolution, 256)
    (ep<epoch>_<i>); video, one clip's frames (ep<epoch>_video_<i>);
    occupancy, one latent's mesh extracted on a 32^3 grid with no MISE
    refinement (ep<epoch>.off); NeRF, nothing.  A failure is warned about
    and counted (s2/eval_hook_failures), never raised, as in the JAX
    trainer."""
    domain = trainer.cfg.data.domain
    if domain not in ("image", "video", "occupancy"):
        return
    out_dir = os.path.join(trainer.save_dir, "samples")
    try:
        pipe = trainer.pipe
        g = torch.Generator(device=pipe.device).manual_seed(trainer.cfg.seed + 100 + epoch)
        with ema_weights(pipe, state):
            if domain == "image":
                res = min(trainer.cfg.data.test_resolution, 256)
                imgs = pipe.sample_images(2, resolution=res, generator=g)
                trainer._save_images(imgs.cpu().numpy(), os.path.join(out_dir, f"ep{epoch}"))
            elif domain == "video":
                vids = pipe.sample_videos(1, generator=g)
                trainer._save_images(vids[0].cpu().numpy(),
                                     os.path.join(out_dir, f"ep{epoch}_video"))
            else:
                from ddmi_tpu_torch.geometry.generation import MeshGenerator

                with torch.no_grad():
                    z = pipe.sample_latents(1, generator=g)
                verts, tris = MeshGenerator(pipe.decode_logits_fn(z), upsampling_steps=0,
                                            resolution0=32, device=pipe.device).generate()
                if trainer.main:
                    os.makedirs(out_dir, exist_ok=True)
                    write_off(os.path.join(out_dir, f"ep{epoch}.off"), verts, tris)
    except Exception as e:  # an eval must never end a training run
        warnings.warn(f"stage2 eval hook failed: {e}\n{traceback.format_exc()}")
        trainer.logger.log(epoch, {"eval_hook_failures": 1.0}, prefix="s2/")
