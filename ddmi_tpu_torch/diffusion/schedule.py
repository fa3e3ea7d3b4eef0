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
    """The schedule arrays the samplers and the training loss read; float32
    tensors of shape (T,).  The posterior terms are q(x_{t-1} | x_t, x_0)'s,
    which the ancestral sampler reads."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    lvlb_weights: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*(a.to(device) for a in self))


def lvlb_weights(betas: np.ndarray, v_posterior: float, parameterization: str) -> np.ndarray:
    """The VLB weights of the training loss (ddmi_tpu/diffusion/schedule.py):
    for eps, beta^2 / (2 var_posterior alpha (1 - acp)); for x0 and v the
    reference's shipped expression 0.5 sqrt(acp) / (2 * 1 - acp).  Index 0
    takes index 1's value."""
    alphas = 1.0 - betas
    acp = np.cumprod(alphas, axis=0)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = (1 - v_posterior) * betas * (1.0 - acp_prev) / (1.0 - acp) + v_posterior * betas
    if parameterization == "eps":
        with np.errstate(divide="ignore"):  # post_var[0] == 0; index 0 is replaced
            w = betas**2 / (2 * post_var * alphas * (1 - acp))
    elif parameterization in ("x0", "v"):
        w = 0.5 * np.sqrt(acp) / (2.0 * 1 - acp)
    else:
        raise NotImplementedError(parameterization)
    w = np.asarray(w)
    w[0] = w[1]
    if np.isnan(w).any():
        raise ValueError("lvlb_weights has NaNs")
    return w


def make_schedule(beta_schedule: str = "linear", timesteps: int = 1000,
                  linear_start: float = 1e-4, linear_end: float = 2e-2,
                  cosine_s: float = 8e-3, v_posterior: float = 0.0,
                  parameterization: str = "eps") -> DiffusionSchedule:
    betas = make_beta_schedule(
        beta_schedule, timesteps, linear_start, linear_end, cosine_s
    )
    alphas = 1.0 - betas
    acp = np.cumprod(alphas, axis=0)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = (1 - v_posterior) * betas * (1.0 - acp_prev) / (1.0 - acp) + v_posterior * betas
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(np.log(np.maximum(post_var, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        lvlb_weights=f32(lvlb_weights(betas, v_posterior, parameterization)),
    )


def ddim_times(num_timesteps: int, sampling_timesteps: int) -> np.ndarray:
    """DDIM (time, time_next) pairs: descending pairs from
    linspace(-1, T-1, S+1), truncated to int.  int32 array of shape (S, 2)."""
    times = np.linspace(-1, num_timesteps - 1, sampling_timesteps + 1)
    times = list(reversed(times.astype(int).tolist()))
    return np.array(list(zip(times[:-1], times[1:])), dtype=np.int32)
