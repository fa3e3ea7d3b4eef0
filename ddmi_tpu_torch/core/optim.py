"""The stage-2 optimizer (counterpart of ddmi_tpu/core/optim.py): AdamW
with weight decay 0 and a bf16 first moment, inside gradient accumulation.

`AdamW` reproduces optax.adamw(lr, weight_decay=0.0, mu_dtype=bfloat16)
(optax/_src/transform.py::scale_by_adam): b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias correction, mu stored in bf16 (b1 * mu taken
in bf16, as JAX's weak typing does, the new mu formed in fp32, used
unrounded for the update and rounded when stored), nu in fp32.
torch.optim.AdamW keeps mu in the parameter's dtype, so it is not this
optimizer.  `MultiSteps` reproduces optax.MultiSteps(every_k_schedule=k):
gradients are averaged over k micro-steps (optax's running mean
acc + (g - acc) / (n + 1)), the parameters change only on the k-th, and
the inner step count advances only then.  Both update in place.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


class AdamW:
    """AdamW(lr, wd 0) over a list of parameters, updated in place."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, mu_dtype=torch.bfloat16):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        """One AdamW step."""
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** self.count)
        bc2 = float(f32(1.0) - f32(self.b2) ** self.count)
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            m = (mu * self.b1).float().add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            u = (m / bc1) / ((nu / bc2).sqrt_().add_(self.eps))
            p.add_(u * -self.lr)
            mu.copy_(m)


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
        for acc, g in zip(self.acc, grads):
            acc.add_((g - acc) / (n + 1))
        if n == self.k - 1:
            self.inner.update(params, self.acc)
            for acc in self.acc:
                acc.zero_()
            self.gradient_step += 1
        self.mini_step = (n + 1) % self.k


def stage2_adamw(cfg, params: List[torch.Tensor]):
    """AdamW(model.lr, wd 0, mu in model.extra.adam_mu_dtype, default
    bf16), inside MultiSteps when lossconfig.gradient_accumulate_every > 1."""
    m = cfg.model
    accum = max(1, m.lossconfig.gradient_accumulate_every)
    mu_dtype = getattr(torch, m.extra.get("adam_mu_dtype", "bfloat16"))
    tx = AdamW(params, m.lr, mu_dtype=mu_dtype)
    return MultiSteps(tx, params, accum) if accum > 1 else tx
