"""DDIM (eta 0) over an eps-predicting denoiser with DDMI's learned mixed
prediction: the denoiser's output is blended with sqrt(1 - acp_t) x_t by a
per-channel sigmoid coefficient before it is read as eps."""

from __future__ import annotations

import numpy as np
import torch


class Schedule:
    """The linear beta schedule ("linear": betas evenly spaced in sqrt
    between linear_start and linear_end, squared), in float64, kept as
    float32 tables."""

    def __init__(self, timesteps: int, linear_start: float, linear_end: float, device=None):
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                            dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.timesteps = timesteps
        self.acp = f32(acp)
        self.sqrt_one_minus_acp = f32(np.sqrt(1.0 - acp))
        self.sqrt_recip_acp = f32(np.sqrt(1.0 / acp))
        self.sqrt_recipm1_acp = f32(np.sqrt(1.0 / acp - 1.0))


def ddim_pairs(timesteps: int, steps: int):
    """The (t, t_next) pairs: linspace(-1, T - 1, steps + 1) truncated to
    integers, descending."""
    times = np.linspace(-1, timesteps - 1, steps + 1).astype(int).tolist()[::-1]
    return list(zip(times[:-1], times[1:]))


def ddim_step(sched: Schedule, model_out, mixing_logit, x, t: int, t_next: int):
    """One update from x_t, given the denoiser's raw output at (x_t, t)."""
    coeff = torch.sigmoid(mixing_logit.float())
    eps = (1 - coeff) * sched.sqrt_one_minus_acp[t] * x + coeff * model_out
    x0 = sched.sqrt_recip_acp[t] * x - sched.sqrt_recipm1_acp[t] * eps
    if t_next < 0:
        return x0
    a_next = sched.acp[t_next]
    return x0 * torch.sqrt(a_next) + torch.sqrt(torch.clamp(1 - a_next, min=0.0)) * eps


def ddim_sample(denoiser, sched: Schedule, mixing_logit, x_T, steps: int):
    """x_T (b, C, h, w) -> the DDIM sample x_0; denoiser(x, t (b,)) -> eps-hat."""
    x = x_T.float()
    for t, t_next in ddim_pairs(sched.timesteps, steps):
        t_vec = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        x = ddim_step(sched, denoiser(x, t_vec), mixing_logit, x, t, t_next)
    return x
