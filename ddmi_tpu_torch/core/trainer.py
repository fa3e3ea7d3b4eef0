"""Training loop on one device (counterpart of ddmi_tpu/core/trainer.py:
stage 1, stage 2, checkpoints, resume and the stage-1 eval hook).

Feeds host batches through a prefetch thread, runs the pipeline's train
step, logs metrics deferred (one device read per chunk), and guards against
a non-finite loss every `data.extra.nan_check_every` steps.  Every
`save_and_sample_every` epochs and at the last one the state is saved
under `<save_dir>/stage1` or `<save_dir>/stage2` (core/checkpoint.py) with
the step generators' states, so that `resume=True` continues bit for bit
where the last checkpoint left off; stage 2 takes its VAE and INR from the
newest stage-1 checkpoint in the save directory when there is one.  The JAX
trainer's mesh becomes one card: `cfg.mesh` is read and changes nothing,
which the run says once, as the JAX package's `make_mesh` fallback does.
The stage-2 eval hook is not ported.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import traceback
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ddmi_tpu_torch.core.checkpoint import CheckpointManager
from ddmi_tpu_torch.core.coords import resize_antialias
from ddmi_tpu_torch.core.metrics import MetricsLogger


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
                 save_dir: Optional[str] = None):
        self.cfg = cfg
        self.pipe = pipeline
        self.data = dataset
        self.test_data = test_dataset
        self.save_dir = save_dir or cfg.data.save_pth
        os.makedirs(self.save_dir, exist_ok=True)
        self.logger = MetricsLogger(self.save_dir)
        # checking every step would wait on the card every step
        self.nan_check_every = int(cfg.data.extra.get("nan_check_every", 50))
        mesh = cfg.mesh
        if mesh.data not in (-1, 1) or mesh.fsdp != 1 or mesh.model != 1:
            warnings.warn(
                f"mesh (data={mesh.data}, fsdp={mesh.fsdp}, model={mesh.model}) asks for "
                f"more than one device; this trainer runs on one ({pipeline.device}) and "
                f"shards nothing", stacklevel=2)

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

    def _put_batch(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch).to(self.pipe.device, non_blocking=True)

    def _log_step(self, step: int, metrics, prefix: str) -> None:
        """Deferred logging and the throttled NaN guard."""
        self.logger.defer(step, metrics, prefix=prefix)
        if self.nan_check_every > 0 and step % self.nan_check_every == 0:
            rec = self.logger.flush()
            loss = (rec or {}).get(prefix + "loss")
            if loss is not None and not math.isfinite(loss):
                raise NaNLossError(f"non-finite loss at step {step}: {loss}")

    def _maybe_resume(self, ckpt: CheckpointManager, resumable: _Resumable, resume: bool,
                      tag: str) -> None:
        if resume and ckpt.latest_step() is not None:
            ckpt.restore(resumable)
            print(f"resumed {tag} from step {resumable.state.step}", flush=True)

    def _epochs(self, state, resumable, ckpt, step_fn, epochs, prefix, eval_hook, save):
        """The epoch loop shared by both stages: step, log, then save (and
        run the eval hook) every save_and_sample_every epochs and at the
        last, unless `save` is off."""
        save_every = self.pipe.lc.save_and_sample_every
        step = state.step
        for epoch in range(epochs):
            for batch in self._batches():
                state, metrics = step_fn(state, self._put_batch(batch))
                step += 1
                self._log_step(step, metrics, prefix)
            self.logger.flush()
            if save and (epoch % save_every == 0 or epoch == epochs - 1):
                ckpt.save(state.step, resumable, overwrite=True)
                if eval_hook is not None:
                    eval_hook(self, state, epoch)
        return state

    def train_stage1(self, epochs: Optional[int] = None, eval_hook: Optional[Callable] = None,
                     resume: bool = False):
        """Stage-1 training of the pipeline's VAE and INR (and, for the
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
        print(f"[s1/] {epochs} epoch(s) of {spe} micro-steps on {self.pipe.device}", flush=True)
        step_fn = lambda s, x: self.pipe.stage1_train_step(s, x, generator=gen,
                                                           host_generator=host)
        return self._epochs(state, resumable, ckpt, step_fn, epochs, "s1/",
                            default_stage1_eval_hook if eval_hook is None else eval_hook, True)

    def load_stage1(self) -> int:
        """Load the VAE and INR of the newest stage-1 checkpoint in the save
        directory into the pipeline; -> its step."""
        ckpt = CheckpointManager(self.save_dir, prefix="stage1")
        step = ckpt.latest_step()
        params = ckpt.restore(step=step)["state"]["params"]
        for name, module in (("vae", self.pipe.vae), ("mlp", self.pipe.mlp)):
            module.load_state_dict({k[len(name) + 1:]: v for k, v in params.items()
                                    if k.startswith(name + ".")})
        return step

    def train_stage2(self, epochs: Optional[int] = None, resume: bool = False,
                     save: bool = True):
        """Stage-2 training of the pipeline's UNet and mixing logit over
        `epochs` passes of the dataset (lossconfig.epochs when None); the
        frozen VAE encoder makes the latents.  The VAE and the INR come from
        the newest stage-1 checkpoint in the save directory when there is
        one (the JAX trainer's load_stage1_params), else they are the
        pipeline's own; the UNet's weights are the pipeline's (the JAX
        trainer draws them from cfg.seed, the seed to build the pipeline
        with).  The step draws (posterior eps, t, noise) come from a
        torch.Generator seeded cfg.seed + 2, the JAX trainer's step stream.
        `save=False` writes no checkpoint.  Returns the final Stage2State."""
        if CheckpointManager(self.save_dir, prefix="stage1").latest_step() is not None:
            print(f"[s2/] stage-1 weights from step {self.load_stage1()} of "
                  f"{os.path.join(self.save_dir, 'stage1')}", flush=True)
        state = self.pipe.init_stage2()
        gen = torch.Generator(device=self.pipe.device).manual_seed(self.cfg.seed + 2)
        resumable = _Resumable(state, gen)
        ckpt = CheckpointManager(self.save_dir, prefix="stage2")
        self._maybe_resume(ckpt, resumable, resume, "stage2")
        epochs = epochs or self.pipe.lc.epochs
        print(f"[s2/] {epochs} epoch(s) of {self._steps_per_epoch()} micro-steps on "
              f"{self.pipe.device}", flush=True)
        step_fn = lambda s, x: self.pipe.stage2_train_step(s, x, generator=gen)
        return self._epochs(state, resumable, ckpt, step_fn, epochs, "s2/", None, save)

    @staticmethod
    def _save_images(imgs: np.ndarray, prefix: str) -> None:
        """PNGs `<prefix>_<i>.png` when PIL is there, else one `<prefix>.npy`."""
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


def default_stage1_eval_hook(trainer: Trainer, state, epoch: int) -> None:
    """The stage-1 eval after each save, for the image domain: reconstruct 4
    test images (the first test batch, or the first training batch without
    a test set) at the anchor resolution with eps drawn from a generator
    seeded 0, log their PSNR against the images (resized to that resolution
    when they differ, where the JAX hook logs NaN) as eval/psnr, and save
    them under <save_dir>/recon/ep<epoch>.  A failure is warned about and
    counted (s1/eval_hook_failures), never raised, as in the JAX trainer."""
    if trainer.cfg.data.domain != "image":
        return
    batch = _first_test_batch(trainer)
    if batch is None:
        return
    try:
        pipe = trainer.pipe
        x = torch.as_tensor(np.asarray(batch)[:4]).to(pipe.device)
        g = torch.Generator(device=pipe.device).manual_seed(0)
        recon = pipe.reconstruct(x, generator=g)
        ref = x.float()
        if ref.shape != recon.shape:
            ref = resize_antialias(ref, recon.shape[1])
        mse = float(((recon - ref) ** 2).mean())
        trainer.logger.log(state.step, {"psnr": -10.0 * math.log10(max(mse, 1e-12))},
                           prefix="eval/")
        trainer._save_images(recon.cpu().numpy(),
                             os.path.join(trainer.save_dir, "recon", f"ep{epoch}"))
    except Exception as e:  # an eval must never end a training run
        warnings.warn(f"stage1 eval hook failed: {e}\n{traceback.format_exc()}")
        trainer.logger.log(epoch, {"eval_hook_failures": 1.0}, prefix="s1/")
