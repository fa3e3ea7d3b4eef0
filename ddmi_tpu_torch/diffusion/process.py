"""The samplers (DDIM, DDIM with encoder reuse, ancestral) with learned
mixed prediction and classifier-free guidance, and the training loss
(counterpart of ddmi_tpu/diffusion/process.py).

The JAX `lax.scan`s over the timesteps are Python loops here, run under
`torch.inference_mode()`.  Noise and timesteps are arguments, or are drawn
from an explicit `torch.Generator`.  Each DDIM step runs in a
`sampler.step` span (core/tracing.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ddmi_tpu_torch.core.tracing import span
from ddmi_tpu_torch.diffusion.schedule import DiffusionSchedule, ddim_times, make_schedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] for per-sample timesteps t (b,), broadcast to ndim dims."""
    out = a[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Forward diffusion q(x_t | x_0) sample."""
    nd = x_start.ndim
    return (extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def get_velocity(sched: DiffusionSchedule, sample, noise, t):
    """The reference's velocity: sqrt(acp) * noise - sqrt(1 - acp) * sample."""
    nd = sample.ndim
    return (extract(sched.sqrt_alphas_cumprod, t, nd) * noise
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * sample)


def predict_start_from_noise(sched: DiffusionSchedule, x_t, t, noise):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * noise
    )


def q_posterior(sched: DiffusionSchedule, x_start, x_t, t):
    """q(x_{t-1} | x_t, x_0): -> (mean, variance, clipped log-variance)."""
    nd = x_t.ndim
    mean = (extract(sched.posterior_mean_coef1, t, nd) * x_start
            + extract(sched.posterior_mean_coef2, t, nd) * x_t)
    return (mean, extract(sched.posterior_variance, t, nd),
            extract(sched.posterior_log_variance_clipped, t, nd))


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
    """Diffusion configuration + schedule, the fields sampling and the
    training loss read."""

    schedule: DiffusionSchedule
    parameterization: str = "eps"
    loss_type: str = "l2"
    mixed_prediction: bool = True
    sampling_timesteps: int = 50
    ddim_sampling_eta: float = 0.0
    original_elbo_weight: float = 0.0
    l_simple_weight: float = 1.0
    clip_denoised: bool = False
    w: float = 1.0  # classifier-free guidance weight
    # ddpmconfig.extra["encoder_reuse"]: > 1 samples with encoder
    # propagation (ddim_sample_unet; the serving CLI's --turbo)
    encoder_reuse: int = 1

    @classmethod
    def from_config(cls, c) -> "GaussianDiffusion":
        sched = make_schedule(
            beta_schedule=c.beta_schedule, timesteps=c.timesteps,
            linear_start=c.linear_start, linear_end=c.linear_end,
            cosine_s=c.cosine_s, v_posterior=c.v_posterior,
            parameterization=c.parameterization,
        )
        return cls(
            schedule=sched, parameterization=c.parameterization,
            loss_type=c.loss_type, mixed_prediction=c.mixed_prediction,
            sampling_timesteps=c.sampling_timesteps,
            ddim_sampling_eta=c.ddim_sampling_eta,
            original_elbo_weight=c.original_elbo_weight,
            l_simple_weight=c.l_simple_weight,
            clip_denoised=c.clip_denoised, w=c.w,
            encoder_reuse=int(c.extra.get("encoder_reuse", 1)),
        )

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    @property
    def is_ddim_sampling(self) -> bool:
        return self.sampling_timesteps < self.num_timesteps

    def to(self, device) -> "GaussianDiffusion":
        return dataclasses.replace(self, schedule=self.schedule.to(device))


def _model_out_mixed(gd: GaussianDiffusion, model_fn: ModelFn, mixing_logit, x, t):
    """The model's output at (x, t), blended with sqrt(1 - acp_t) x_t under
    mixed prediction."""
    out = model_fn(x, t)
    if gd.mixed_prediction:
        out = mixed_prediction(out, mixing_logit, mixing_component(gd.schedule, x, t))
    return out


def p_losses(gd: GaussianDiffusion, model_fn: ModelFn, mixing_logit, x_start, t, noise):
    """The training loss for timesteps t (b,) and noise: per-sample MSE or
    L1 of the (mixed) model output against the parameterization's target,
    plus the VLB-weighted term.  -> (loss, {loss_simple, loss_vlb, loss})."""
    sched = gd.schedule
    x_noisy = q_sample(sched, x_start, t, noise)
    model_out = _model_out_mixed(gd, model_fn, mixing_logit, x_noisy, t)
    if gd.parameterization == "eps":
        target = noise
    elif gd.parameterization == "x0":
        target = x_start
        model_out = predict_start_from_noise(sched, x_noisy, t, model_out)
    elif gd.parameterization == "v":
        target = get_velocity(sched, x_start, noise, t)
        model_out = get_velocity(sched, x_start, model_out, t)
    else:
        raise NotImplementedError(gd.parameterization)
    err = model_out - target
    dims = tuple(range(1, err.ndim))
    if gd.loss_type == "l2":
        per_sample = (err**2).mean(dim=dims)
    elif gd.loss_type == "l1":
        per_sample = err.abs().mean(dim=dims)
    else:
        raise NotImplementedError(gd.loss_type)
    loss_simple = per_sample.mean() * gd.l_simple_weight
    loss_vlb = (sched.lvlb_weights[t] * per_sample).mean()
    loss = loss_simple + gd.original_elbo_weight * loss_vlb
    return loss, {"loss_simple": loss_simple, "loss_vlb": loss_vlb, "loss": loss}


def draw_t_noise(gd: GaussianDiffusion, x_start, generator: Optional[torch.Generator] = None,
                 t=None, noise=None):
    """t ~ U[0, T) per sample, then Gaussian noise of x_start's shape, each
    drawn from `generator` unless given.  -> (t, noise)."""
    if t is None:
        t = torch.randint(0, gd.num_timesteps, (x_start.shape[0],), generator=generator,
                          device=x_start.device)
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                            dtype=x_start.dtype)
    return t, noise


def diffusion_loss(gd: GaussianDiffusion, model_fn: ModelFn, mixing_logit, x_start,
                   generator: Optional[torch.Generator] = None, t=None, noise=None):
    """p_losses at the draws of `draw_t_noise`."""
    t, noise = draw_t_noise(gd, x_start, generator, t, noise)
    return p_losses(gd, model_fn, mixing_logit, x_start, t, noise)


def _check_sampling_parameterization(gd: GaussianDiffusion) -> None:
    """Every reference parameterization trains the raw output as an eps
    prediction, so sampling reads it as eps for all three (see
    ddmi_tpu/diffusion/process.py::_check_sampling_parameterization)."""
    if gd.parameterization not in ("eps", "x0", "v"):
        raise NotImplementedError(f"unknown parameterization={gd.parameterization!r}")


def model_predictions(gd: GaussianDiffusion, model_fn: ModelFn, mixing_logit, x, t,
                      cond_model_fn: Optional[ModelFn] = None, clip_x_start: bool = False):
    """eps-hat and x0-hat.  `model_fn` is the unconditional branch; with
    `cond_model_fn` (classifier-free guidance) eps-hat is (1 + w) cond -
    w uncond, each branch blended by mixed prediction first."""
    out = _model_out_mixed(gd, model_fn, mixing_logit, x, t)
    if cond_model_fn is not None:
        cond = _model_out_mixed(gd, cond_model_fn, mixing_logit, x, t)
        out = (1 + gd.w) * cond - gd.w * out
    _check_sampling_parameterization(gd)
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


def _ddim_step(gd: GaussianDiffusion, sched: DiffusionSchedule, model_fn: ModelFn,
               mixing_logit, img, time: int, time_next: int,
               generator: Optional[torch.Generator], cond_model_fn: Optional[ModelFn] = None):
    """The model's predictions at `time`, then the DDIM update to `time_next`."""
    t_vec = torch.full((img.shape[0],), time, dtype=torch.long, device=img.device)
    pred_noise, x_start = model_predictions(
        gd, model_fn, mixing_logit, img, t_vec, cond_model_fn=cond_model_fn,
        clip_x_start=gd.clip_denoised,
    )
    return _ddim_update(sched, gd.ddim_sampling_eta, img, pred_noise, x_start, time,
                        time_next, generator)


@torch.inference_mode()
def ddim_sample(gd: GaussianDiffusion, model_fn: ModelFn, mixing_logit,
                shape: Tuple[int, ...], *, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                device=None, cond_model_fn: Optional[ModelFn] = None) -> torch.Tensor:
    """DDIM sampler over the (time, time_next) pairs.  The initial latent is
    `noise` when given, else a draw from `generator`; `cond_model_fn`
    guides (see `model_predictions`)."""
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    img = noise.float()
    sched = gd.schedule.to(img.device)
    for time, time_next in ddim_times(gd.num_timesteps, gd.sampling_timesteps).tolist():
        with span("sampler.step"):
            img = _ddim_step(gd, sched, model_fn, mixing_logit, img, time, time_next,
                             generator, cond_model_fn)
    return img


@torch.inference_mode()
def p_sample_loop(gd: GaussianDiffusion, model_fn: ModelFn, mixing_logit,
                  shape: Tuple[int, ...], *, noise: Optional[torch.Tensor] = None,
                  step_noise=None, generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """The ancestral sampler over t = T-1 .. 0: x0-hat from the (mixed)
    output read as eps, then a draw from q(x_{t-1} | x_t, x0-hat), with no
    noise at t = 0.  The initial latent is `noise` when given, else a draw
    from `generator`; the step draws are `step_noise[i]` for step i (a (T,
    *shape) tensor or a sequence of T tensors) when given, else drawn from
    `generator`, one per step, t = 0 included, as the JAX loop draws."""
    _check_sampling_parameterization(gd)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    img = noise.float()
    sched = gd.schedule.to(img.device)
    for i, t in enumerate(range(gd.num_timesteps - 1, -1, -1)):
        t_vec = torch.full((img.shape[0],), t, dtype=torch.long, device=img.device)
        out = _model_out_mixed(gd, model_fn, mixing_logit, img, t_vec)
        x_recon = predict_start_from_noise(sched, img, t_vec, out)
        if gd.clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        mean, _, log_var = q_posterior(sched, x_recon, img, t_vec)
        if step_noise is not None:
            z = step_noise[i].to(img.device, img.dtype)
        else:
            z = torch.randn(img.shape, generator=generator, device=img.device, dtype=img.dtype)
        img = mean + torch.exp(0.5 * log_var) * z if t > 0 else mean
    return img


def sample(gd: GaussianDiffusion, model_fn: ModelFn, mixing_logit, shape: Tuple[int, ...], *,
           noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
           device=None, cond_model_fn: Optional[ModelFn] = None,
           step_noise=None) -> torch.Tensor:
    """DDIM when sampling_timesteps < T, else the ancestral loop (whose
    `step_noise` DDIM does not take).  Guidance runs with DDIM only, as in
    the JAX package; the ancestral loop refuses `cond_model_fn`."""
    if gd.is_ddim_sampling:
        return ddim_sample(gd, model_fn, mixing_logit, shape, noise=noise, generator=generator,
                           device=device, cond_model_fn=cond_model_fn)
    if cond_model_fn is not None:
        raise ValueError("classifier-free guidance samples with DDIM only "
                         "(sampling_timesteps < timesteps)")
    return p_sample_loop(gd, model_fn, mixing_logit, shape, noise=noise, step_noise=step_noise,
                         generator=generator, device=device)


@torch.inference_mode()
def ddim_sample_encoder_reuse(gd: GaussianDiffusion, full_fn, reuse_fn, mixing_logit,
                              shape: Tuple[int, ...], reuse: int, *,
                              noise: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None,
                              device=None) -> torch.Tensor:
    """DDIM with encoder propagation (arXiv:2312.09608, "Faster Diffusion"):
    the first step of every group of `reuse` steps runs the full denoiser
    and caches its down-path features, and the group's other reuse - 1
    steps run only the middle and up paths on that cache under their own
    timestep.  Each update still reads the current x_t, so the trajectory
    follows the sample; the cache stands in for slowly varying encoder
    features.  The NFE % reuse steps left over at the end run in full.

    `full_fn(x, t) -> (model_out, cache)`, `reuse_fn(x, t, cache) ->
    model_out`.  reuse = 1 is `ddim_sample` exactly; a larger reuse changes
    the samples (turbo sampling is opt-in, never the default)."""
    if reuse < 1:
        raise ValueError(f"reuse must be >= 1, got {reuse}")
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    img = noise.float()
    sched = gd.schedule.to(img.device)
    pairs = ddim_times(gd.num_timesteps, gd.sampling_timesteps).tolist()
    grouped = len(pairs) // reuse * reuse
    cache = None

    def caching(x, t):
        nonlocal cache
        out, cache = full_fn(x, t)
        return out

    for i, (time, time_next) in enumerate(pairs):
        if i >= grouped:
            fn = lambda x, t: full_fn(x, t)[0]
        elif i % reuse == 0:
            fn = caching
        else:
            fn = lambda x, t: reuse_fn(x, t, cache)
        with span("sampler.step"):
            img = _ddim_step(gd, sched, fn, mixing_logit, img, time, time_next, generator)
    return img


def ddim_sample_unet(gd: GaussianDiffusion, unet, mixing_logit, shape, *,
                     noise=None, generator=None, device=None) -> torch.Tensor:
    """DDIM with a UNet (nn/unet.py, or the TriplaneUNet of
    nn/unet_triplane.py over tokens) as the denoiser; gd.encoder_reuse > 1
    samples with encoder propagation through the UNet's cache split."""
    if gd.encoder_reuse > 1:
        return ddim_sample_encoder_reuse(
            gd, lambda x, t: unet(x, t, return_cache=True),
            lambda x, t, c: unet(x, t, cache=c), mixing_logit, shape, gd.encoder_reuse,
            noise=noise, generator=generator, device=device,
        )
    return ddim_sample(
        gd, lambda x, t: unet(x, t), mixing_logit, shape, noise=noise,
        generator=generator, device=device,
    )
