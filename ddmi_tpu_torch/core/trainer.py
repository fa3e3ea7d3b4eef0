"""Training loop on one device (counterpart of ddmi_tpu/core/trainer.py,
stage 2).

Feeds host batches through a prefetch thread, runs the pipeline's train
step, logs metrics deferred (one device read per chunk), and guards against
a non-finite loss every `data.extra.nan_check_every` steps.  The JAX
trainer's mesh becomes one card: `cfg.mesh` is read and changes nothing,
which the run says once, as the JAX package's `make_mesh` fallback does.
Checkpoints and the eval/sample hooks come with the next slice.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import warnings
from typing import Optional

import torch

from ddmi_tpu_torch.core.metrics import MetricsLogger


class NaNLossError(RuntimeError):
    """Raised when the training loss goes non-finite."""


class Trainer:
    def __init__(self, cfg, pipeline, dataset, save_dir: Optional[str] = None):
        self.cfg = cfg
        self.pipe = pipeline
        self.data = dataset
        self.save_dir = save_dir or cfg.data.extra.get("save_pth", "./save")
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

    def train_stage2(self, epochs: Optional[int] = None, resume: bool = False):
        """Stage-2 training of the pipeline's UNet and mixing logit over
        `epochs` passes of the dataset (lossconfig.epochs when None); the
        frozen VAE encoder makes the latents.  The weights are the
        pipeline's own (the JAX trainer draws them from cfg.seed, which is
        the seed to build the pipeline with); the step draws (posterior
        eps, t, noise) come from a torch.Generator seeded cfg.seed + 2, the
        JAX trainer's step stream.  Saves no checkpoint in this slice, so
        `resume` raises.  Returns the final Stage2State."""
        if resume:
            raise NotImplementedError("stage-2 checkpoints are not ported yet: nothing to resume")
        state = self.pipe.init_stage2()
        gen = torch.Generator(device=self.pipe.device).manual_seed(self.cfg.seed + 2)
        epochs = epochs or self.pipe.lc.epochs
        print(f"[s2/] {epochs} epoch(s) of {self._steps_per_epoch()} micro-steps on "
              f"{self.pipe.device}", flush=True)
        step = state.step
        for _ in range(epochs):
            for batch in self._batches():
                state, metrics = self.pipe.stage2_train_step(
                    state, self._put_batch(batch), generator=gen)
                step += 1
                self._log_step(step, metrics, "s2/")
            self.logger.flush()
        return state
