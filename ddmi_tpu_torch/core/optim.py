"""The training optimizers (counterpart of ddmi_tpu/core/optim.py and of
the optax transformations the JAX image pipeline builds).

`AdamW` reproduces optax.adamw(lr, weight_decay=0.0) with optax's
scale_by_adam: eps 1e-8 outside the square root, bias correction, nu in
fp32, and mu in `mu_dtype`: fp32 as optax keeps it without mu_dtype
(stage 1, the discriminator), or bf16 for stage 2's
optax.adamw(..., mu_dtype=bfloat16) (b1 * mu taken in bf16, as JAX's weak
typing does, the new mu formed in fp32, used unrounded for the update and
rounded when stored).  torch.optim.AdamW keeps mu in the parameter's
dtype, so it is not this optimizer.  The learning rate is a constant or a
schedule of the optimizer's own update count, read before the count
advances (optax's scale_by_schedule), so a schedule that starts at 0 makes
the first update a no-op.  `linear_schedule` and
`warmup_cosine_decay_schedule` are optax's, in its fp32 order of
operations.  `MultiSteps` reproduces optax.MultiSteps(every_k_schedule=k):
gradients are averaged over k micro-steps (optax's running mean
acc + (g - acc) / (n + 1)), the parameters change only on the k-th, and
the inner count advances only then.  All update in place, on plain
tensors or on the DTensor shards of parameters split by FSDP2
(parallel/mesh.py), whose moments `zeros_like` splits alike.
"""

from __future__ import annotations

from typing import Callable, List, Union

import numpy as np
import torch

from ddmi_tpu_torch.parallel.mesh import copy_full_, local

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over `transition_steps` counts,
    then held (constant init when transition_steps <= 0)."""
    f32 = np.float32
    if transition_steps <= 0:
        return lambda count: float(f32(init_value))

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        frac = f32(1.0) - f32(c) / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warm-up init -> peak over
    `warmup_steps`, then cosine decay to end_value by `decay_steps`."""
    f32 = np.float32
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = float(decay_steps - warmup_steps)
    if not span > 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, got {decay_steps}")

    def cosine(count: int) -> float:
        c = f32(min(count, span))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c / f32(span), dtype=np.float32))
        return float(f32(peak_value) * (f32(1.0 - alpha) * cos + f32(alpha)))

    return lambda count: warmup(count) if count < warmup_steps else cosine(count - warmup_steps)


class AdamW:
    """AdamW(lr, wd 0) over a list of parameters, updated in place; `lr` a
    float or a Schedule of the update count."""

    def __init__(self, params: List[torch.Tensor], lr: Union[float, Schedule], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, mu_dtype=torch.bfloat16):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    def learning_rate(self) -> float:
        """The rate of the next update."""
        return self.lr(self.count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        """One AdamW step."""
        lr = self.learning_rate()
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** self.count)
        bc2 = float(f32(1.0) - f32(self.b2) ** self.count)
        for p, g, mu, nu in zip(local(params), local(grads), local(self.mu), local(self.nu)):
            m = (mu * self.b1).float().add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            u = (m / bc1) / ((nu / bc2).sqrt_().add_(self.eps))
            p.add_(u * -lr)
            mu.copy_(m)

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        for dst, src in zip(self.mu + self.nu, list(sd["mu"]) + list(sd["nu"])):
            copy_full_(dst, src)
        self.count = int(sd["count"])


class MultiSteps:
    """Gradient accumulation over k micro-steps around `inner`."""

    def __init__(self, inner: AdamW, params: List[torch.Tensor], k: int):
        self.inner, self.k = inner, k
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.mini_step = 0
        self.gradient_step = 0

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        """Take one micro-step's gradients; step the inner optimizer on the
        k-th."""
        n = self.mini_step
        for acc, g in zip(local(self.acc), local(grads)):
            acc.add_((g - acc) / (n + 1))
        if n == self.k - 1:
            self.inner.update(params, self.acc)
            for acc in local(self.acc):
                acc.zero_()
            self.gradient_step += 1
        self.mini_step = (n + 1) % self.k

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "acc": self.acc, "mini_step": self.mini_step,
                "gradient_step": self.gradient_step}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd["inner"])
        for dst, src in zip(self.acc, sd["acc"]):
            copy_full_(dst, src)
        self.mini_step, self.gradient_step = int(sd["mini_step"]), int(sd["gradient_step"])


def stage2_adamw(cfg, params: List[torch.Tensor]):
    """AdamW(model.lr, wd 0, mu in model.extra.adam_mu_dtype, default
    bf16), inside MultiSteps when lossconfig.gradient_accumulate_every > 1."""
    m = cfg.model
    accum = max(1, m.lossconfig.gradient_accumulate_every)
    mu_dtype = getattr(torch, m.extra.get("adam_mu_dtype", "bfloat16"))
    tx = AdamW(params, m.lr, mu_dtype=mu_dtype)
    return MultiSteps(tx, params, accum) if accum > 1 else tx


def stage1_adamw(cfg, params: List[torch.Tensor], steps_per_epoch: int,
                 warmup_only: bool = True):
    """The stage-1 optimizer (ddmi_tpu/domains/{image,video}.py::
    stage1_optimizer): AdamW(wd 0, fp32 mu) on a schedule of optimizer
    updates, a linear warm-up from 0 over warmup_epochs then cosine decay
    to 0 by the last epoch (lossconfig.lr_scheduler); without the
    scheduler the warm-up alone (`warmup_only`, the image domain's) or a
    constant model.lr (the video domain's).  Inside MultiSteps when
    lossconfig.gradient_accumulate_every > 1."""
    m = cfg.model
    lc = m.lossconfig
    accum = max(1, lc.gradient_accumulate_every)
    total = steps_per_epoch * lc.epochs // accum
    warmup = steps_per_epoch * lc.warmup_epochs // accum
    if lc.lr_scheduler:
        sched = warmup_cosine_decay_schedule(0.0, m.lr, max(warmup, 1), max(total, 2))
    elif warmup_only:
        sched = linear_schedule(0.0, m.lr, max(warmup, 1))
    else:
        sched = m.lr
    tx = AdamW(params, sched, mu_dtype=torch.float32)
    return MultiSteps(tx, params, accum) if accum > 1 else tx


def disc_adamw(cfg, params: List[torch.Tensor]) -> AdamW:
    """The PatchGAN's optimizer: AdamW(model.lr, b1 0.5, b2 0.9, wd 0, fp32
    mu), constant rate, no accumulation."""
    return AdamW(params, cfg.model.lr, b1=0.5, b2=0.9, mu_dtype=torch.float32)
