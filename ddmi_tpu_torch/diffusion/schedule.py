"""Noise schedules (counterpart of ddmi_tpu/diffusion/schedule.py).

Schedule quantities are computed in float64 on the host with numpy, then
stored as float32 tensors, exactly as the JAX package stores them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    if schedule == "linear":
        return np.linspace(
            linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64
        ) ** 2
    if schedule == "cosine":
        t = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(t / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], a_min=0, a_max=0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown.")


class DiffusionSchedule(NamedTuple):
    """The schedule arrays the sampler reads; float32 tensors of shape (T,)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*(a.to(device) for a in self))


def make_schedule(beta_schedule: str = "linear", timesteps: int = 1000,
                  linear_start: float = 1e-4, linear_end: float = 2e-2,
                  cosine_s: float = 8e-3) -> DiffusionSchedule:
    betas = make_beta_schedule(
        beta_schedule, timesteps, linear_start, linear_end, cosine_s
    )
    acp = np.cumprod(1.0 - betas, axis=0)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
    )


def ddim_times(num_timesteps: int, sampling_timesteps: int) -> np.ndarray:
    """DDIM (time, time_next) pairs: descending pairs from
    linspace(-1, T-1, S+1), truncated to int.  int32 array of shape (S, 2)."""
    times = np.linspace(-1, num_timesteps - 1, sampling_timesteps + 1)
    times = list(reversed(times.astype(int).tolist()))
    return np.array(list(zip(times[:-1], times[1:])), dtype=np.int32)
