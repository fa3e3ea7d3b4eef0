"""DDIM sampling with learned mixed prediction (counterpart of
ddmi_tpu/diffusion/process.py, sampling half).

The JAX `lax.scan` over (time, time_next) pairs is a Python loop here, run
under `torch.inference_mode()`.  Noise is an argument, or is drawn from an
explicit `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ddmi_tpu_torch.diffusion.schedule import DiffusionSchedule, ddim_times, make_schedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] for per-sample timesteps t (b,), broadcast to ndim dims."""
    out = a[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def predict_start_from_noise(sched: DiffusionSchedule, x_t, t, noise):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * noise
    )


def mixing_component(sched: DiffusionSchedule, x_noisy, t):
    """sqrt(1 - acp_t) * x_t."""
    return extract(sched.sqrt_one_minus_alphas_cumprod, t, x_noisy.ndim) * x_noisy


def mixed_prediction(model_out, mixing_logit: Optional[torch.Tensor], mix_comp):
    """coeff = sigmoid(logit); (1 - coeff) * mix + coeff * out.  The logit
    broadcasts over the channel axis: (1, C, 1, 1) for NCHW images, (1, 1, C)
    for (b, n, c) video tokens."""
    if mixing_logit is None:
        return model_out
    coeff = torch.sigmoid(mixing_logit)
    return (1 - coeff) * mix_comp + coeff * model_out


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Diffusion configuration + schedule, the fields sampling reads."""

    schedule: DiffusionSchedule
    parameterization: str = "eps"
    mixed_prediction: bool = True
    sampling_timesteps: int = 50
    ddim_sampling_eta: float = 0.0
    clip_denoised: bool = False

    @classmethod
    def from_config(cls, c) -> "GaussianDiffusion":
        sched = make_schedule(
            beta_schedule=c.beta_schedule, timesteps=c.timesteps,
            linear_start=c.linear_start, linear_end=c.linear_end,
            cosine_s=c.cosine_s,
        )
        return cls(
            schedule=sched, parameterization=c.parameterization,
            mixed_prediction=c.mixed_prediction,
            sampling_timesteps=c.sampling_timesteps,
            ddim_sampling_eta=c.ddim_sampling_eta,
            clip_denoised=c.clip_denoised,
        )

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    def to(self, device) -> "GaussianDiffusion":
        return dataclasses.replace(self, schedule=self.schedule.to(device))


def model_predictions(gd: GaussianDiffusion, model_fn: ModelFn, mixing_logit, x, t,
                      clip_x_start: bool = False):
    """eps-hat and x0-hat.  Every reference parameterization trains the raw
    output as an eps prediction, so sampling reads it as eps for all three
    (see ddmi_tpu/diffusion/process.py::_check_sampling_parameterization)."""
    if gd.parameterization not in ("eps", "x0", "v"):
        raise NotImplementedError(f"unknown parameterization={gd.parameterization!r}")
    out = model_fn(x, t)
    if gd.mixed_prediction:
        out = mixed_prediction(out, mixing_logit, mixing_component(gd.schedule, x, t))
    x_start = predict_start_from_noise(gd.schedule, x, t, out)
    if clip_x_start:
        x_start = x_start.clamp(-1.0, 1.0)
    return out, x_start


def _ddim_update(sched: DiffusionSchedule, eta: float, img, pred_noise, x_start,
                 time: int, time_next: int, generator: Optional[torch.Generator]):
    """One DDIM x_t -> x_{t-1} update; the final step (time_next < 0)
    returns x_start."""
    if time_next < 0:
        return x_start
    alpha = sched.alphas_cumprod[time]
    alpha_next = sched.alphas_cumprod[time_next]
    sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
    c = torch.sqrt(torch.clamp(1 - alpha_next - sigma**2, min=0.0))
    img_next = x_start * torch.sqrt(alpha_next) + c * pred_noise
    if eta != 0.0:
        step_noise = torch.randn(
            img.shape, generator=generator, device=img.device, dtype=img.dtype
        )
        img_next = img_next + sigma * step_noise
    return img_next


@torch.inference_mode()
def ddim_sample(gd: GaussianDiffusion, model_fn: ModelFn, mixing_logit,
                shape: Tuple[int, ...], *, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """DDIM sampler over the (time, time_next) pairs.  The initial latent is
    `noise` when given, else a draw from `generator`."""
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    img = noise.float()
    sched = gd.schedule.to(img.device)
    batch = shape[0]
    for time, time_next in ddim_times(gd.num_timesteps, gd.sampling_timesteps).tolist():
        t_vec = torch.full((batch,), time, dtype=torch.long, device=img.device)
        pred_noise, x_start = model_predictions(
            gd, model_fn, mixing_logit, img, t_vec, clip_x_start=gd.clip_denoised
        )
        img = _ddim_update(
            sched, gd.ddim_sampling_eta, img, pred_noise, x_start, time, time_next,
            generator,
        )
    return img


def ddim_sample_unet(gd: GaussianDiffusion, unet, mixing_logit, shape, *,
                     noise=None, generator=None, device=None) -> torch.Tensor:
    """DDIM with a UNet (nn/unet.py, or the TriplaneUNet of
    nn/unet_triplane.py over tokens) as the denoiser (encoder reuse = 1)."""
    return ddim_sample(
        gd, lambda x, t: unet(x, t), mixing_logit, shape, noise=noise,
        generator=generator, device=device,
    )
