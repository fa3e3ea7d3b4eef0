"""Exponential moving average of the trainable parameters (counterpart of
ddmi_tpu/core/ema.py, ema_pytorch's schedule): decay_t = clamp(1 - (1 +
t / inv_gamma)^(-power), 0, beta), applied every `update_every` steps, with
t counted from `update_after_step`; before it the average copies the
parameters (decay 0).  The step is the micro-step, as the JAX
Stage2State.step counts it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ddmi_tpu_torch.parallel.mesh import local


def ema_decay_schedule(updates: int, beta: float = 0.9999, inv_gamma: float = 1.0,
                       power: float = 2.0 / 3.0) -> float:
    """The decay after `updates` updates, computed in fp32 as the JAX
    package computes it."""
    one = np.float32(1.0)
    value = one - (one + np.float32(updates) / np.float32(inv_gamma)) ** np.float32(-power)
    return float(np.clip(value, np.float32(0.0), np.float32(beta)))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], step: int,
               beta: float = 0.9999, update_every: int = 10,
               update_after_step: int = 100) -> Dict[str, torch.Tensor]:
    """Blend `params` into `ema` at micro-step `step`: e * d + p * (1 - d)
    on update_every boundaries, nothing otherwise.  Updates `ema` in place
    (JAX returns a new tree) and returns it."""
    if step % update_every:
        return ema
    d = ema_decay_schedule(max((step - update_after_step) // update_every, 0), beta)
    one_minus = float(np.float32(1.0) - np.float32(d))
    keys = list(ema)
    # on the ranks' local parts of tensors split by FSDP2 (parallel/mesh.py)
    e = local([ema[k] for k in keys])
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, torch._foreach_mul(local([params[k].detach() for k in keys]),
                                              one_minus))
    return ema
