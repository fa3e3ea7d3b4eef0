"""Image domain (counterpart of ddmi_tpu/domains/image.py::ImagePipeline):
sampling (DDIM over the denoiser, HDBF decode, INR render), stage-1 D2C-VAE
training (the multiscale reconstruction through the VAE and the INR at the
crop's coordinates, the annealed KL, LPIPS, the spectral-norm regulariser
and, for the adversarial configs, the PatchGAN), reconstruction at any
resolution, and stage-2 training (the frozen VAE encoder, the diffusion
loss through the denoiser, AdamW with gradient accumulation, EMA).  The
denoiser is the ADM UNet, or with `model.DiT` the MDTv2 transformer
(nn/mdt.py), whose masked training draws its token mask explicitly.

Every random draw of a stage-1 micro-step is explicit (`Stage1Draws`): the
multiscale branch and crop (drawn on the host), the posterior eps, the
INR's NoiseInjection draws and the DiffAugment draws, so that a test can
feed the JAX package's own.  Each stage of a stage-1 micro-step runs in a
span named `stage1/<stage>` (multiscale, encode, decode, inr, lpips, sn,
backward, gan, optimizer; core/tracing.py), which a torch.profiler trace
shows as a range of that name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ddmi_tpu_torch.core.amp import amp_denoiser, compute_cast, method_call
from ddmi_tpu_torch.core.coords import (
    draw_multiscale, get_scale_injection, linear_kl_coeff, multiscale_image_transform,
    resize_antialias, symmetrize, unsymmetrize,
)
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.core.ema import ema_update
from ddmi_tpu_torch.core.optim import disc_adamw, stage1_adamw, stage2_adamw
from ddmi_tpu_torch.core.sn_reg import init_sn_state, norm_scale_loss, spectral_norm_loss
from ddmi_tpu_torch.core.tracing import span
from ddmi_tpu_torch.diffusion.process import (
    GaussianDiffusion, ddim_sample, ddim_sample_unet, diffusion_loss, draw_t_noise,
)
from ddmi_tpu_torch.losses.diffaugment import diff_augment, draw_diffaugment
from ddmi_tpu_torch.losses.gan import GANLoss2D
from ddmi_tpu_torch.nn.inr import INRImage
from ddmi_tpu_torch.nn.mdt import MDTv2
from ddmi_tpu_torch.nn.unet import UNet
from ddmi_tpu_torch.nn.vae import Autoencoder
from ddmi_tpu_torch.ops.attention import needs_grad
from ddmi_tpu_torch.ops.inr_decode import render_tokens_fused
from ddmi_tpu_torch.ops.resample import pixel_center_lin
from ddmi_tpu_torch.parallel.mesh import copy_full_, reduce_grads


def _copy_into(dst: Dict[str, torch.Tensor], src) -> None:
    for k, t in dst.items():
        copy_full_(t, src[k])


def stage1_kl_coeff(lc, total_iters: int, step: int) -> float:
    """The KL weight at micro-step `step`: annealed over total_iters
    micro-steps (lossconfig.kl_anneal), else kl_max_coeff; in JAX's fp32."""
    if not lc.kl_anneal:
        return float(np.float32(lc.kl_max_coeff))
    total = max(total_iters, 1)
    f32 = np.float32
    return linear_kl_coeff(step, f32(lc.kl_anneal_portion) * f32(total),
                           f32(lc.kl_const_portion) * f32(total),
                           lc.kl_const_coeff, lc.kl_max_coeff)


def stage1_sn_weight(lc, kl_coeff: float) -> float:
    """The SN regulariser's weight: annealed geometrically from
    sn_reg_weight_decay_init to sn_reg_weight_decay along the KL weight
    (lossconfig.sn_reg_weight_decay_anneal), else sn_reg_weight_decay."""
    if not lc.sn_reg_weight_decay_anneal:
        return lc.sn_reg_weight_decay
    f32, k = np.float32, np.float32(kl_coeff)
    return float(np.exp((f32(1.0) - k) * np.log(f32(lc.sn_reg_weight_decay_init))
                        + k * np.log(f32(lc.sn_reg_weight_decay))))


@dataclasses.dataclass
class Stage1Draws:
    """The random draws of one stage-1 micro-step: `multiscale` = (p, i, j,
    i2, j2) (core/coords.py::draw_multiscale), `eps` the posterior's
    standard-normal noise (b, embed_dim, h, w) fp32, `noise` an iterator of
    the INR's twelve NoiseInjection draws (None: drawn from the step's
    generator as the INR runs), `aug` the DiffAugment draws (adversarial
    configs with a policy)."""

    multiscale: Tuple[float, int, int, int, int]
    eps: torch.Tensor
    noise: Optional[Iterator[torch.Tensor]] = None
    aug: Optional[list] = None


@dataclasses.dataclass
class Stage1State:
    """Stage-1 training state (JAX Stage1State): `step` counts micro-steps;
    `params` are the trainable parameters themselves (`vae.<name>`,
    `mlp.<name>`: fp32 masters updated in place), `opt` their optimizer
    (core/optim.py), `sn` the spectral-norm vectors (core/sn_reg.py);
    for the adversarial configs `disc` the discriminator's parameters and
    `disc_opt` its optimizer."""

    step: int
    params: Dict[str, torch.Tensor]
    opt: object
    sn: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    disc: Optional[Dict[str, torch.Tensor]] = None
    disc_opt: Optional[object] = None

    def state_dict(self) -> dict:
        return {"step": self.step, "params": self.params, "opt": self.opt.state_dict(),
                "sn": {k: list(uv) for k, uv in self.sn.items()}, "disc": self.disc,
                "disc_opt": None if self.disc_opt is None else self.disc_opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Copy a saved state into this one's tensors, in place."""
        self.step = int(sd["step"])
        _copy_into(self.params, sd["params"])
        self.opt.load_state_dict(sd["opt"])
        self.sn = {k: (u.to(self.sn[k][0].device), v.to(self.sn[k][1].device))
                   for k, (u, v) in sd["sn"].items()}
        if self.disc is not None:
            _copy_into(self.disc, sd["disc"])
            self.disc_opt.load_state_dict(sd["disc_opt"])


@dataclasses.dataclass
class Stage2State:
    """Stage-2 training state (JAX Stage2State): `step` counts micro-steps;
    `params` are the trainable parameters themselves (`unet.<name>` and
    `mixing_logit`, fp32 masters updated in place), `ema` their fp32
    averages, `opt` the optimizer (core/optim.py) with its moments."""

    step: int
    params: Dict[str, torch.Tensor]
    ema: Dict[str, torch.Tensor]
    opt: object

    def state_dict(self) -> dict:
        return {"step": self.step, "params": self.params, "ema": self.ema,
                "opt": self.opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Copy a saved state into this one's tensors, in place."""
        self.step = int(sd["step"])
        _copy_into(self.params, sd["params"])
        _copy_into(self.ema, sd["ema"])
        self.opt.load_state_dict(sd["opt"])


class LatentTraining:
    """The training methods the pipelines share: their parameter sets, both
    stages' states, stage 2's loss, optimizer and EMA step.  A pipeline
    brings its stage-1 modules (`stage1_modules`: the VAE and the INR, and
    for the 3D domains the pointnet; `vae` among them), `unet`,
    `mixing_logit`, `gan`, `cfg`, `lc`, `amp`, `device`, its
    `encode_latents` and `stage2_latents`, and says whether its stage-1
    rate without lossconfig.lr_scheduler keeps the warm-up
    (`stage1_warmup_only`) or is constant, and which frozen stage-1 modules
    stage 2 runs in bf16 under model.amp (`stage2_bf16_modules`)."""

    stage1_modules: Tuple[str, ...] = ("vae", "mlp")
    stage2_bf16_modules: Tuple[str, ...] = ("vae",)
    # The KL anneal's length in micro-steps until init_stage1 sets it (the
    # JAX package's default).
    _stage1_total_iters = 100_000
    def stage1_params(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters, `<module>.<name>` over stage1_modules."""
        return {f"{name}.{k}": p for name in self.stage1_modules
                for k, p in getattr(self, name).named_parameters()}

    def init_stage1(self, steps_per_epoch: int = 1000) -> Stage1State:
        """Ready the pipeline for stage-1 training from its current weights:
        the stage-1 modules train in fp32 (the VAE laid out channels-last on
        the card), and the state starts with a fresh optimizer, spectral-norm
        vectors of the VAE drawn from a generator seeded 7 (the JAX
        package's key) and, for the adversarial configs, the
        discriminator's optimizer.  The KL anneals over steps_per_epoch x
        lossconfig.epochs micro-steps."""
        for name in self.stage1_modules:
            getattr(self, name).float().requires_grad_(True)
        if self.device.type == "cuda":
            self.vae.to(memory_format=torch.channels_last)
        self._stage1_total_iters = steps_per_epoch * self.lc.epochs
        params = self.stage1_params()
        gen = torch.Generator(device=self.device).manual_seed(7)
        sn = init_sn_state(self.vae, gen)
        disc = disc_opt = None
        if self.gan is not None:
            self.gan.float().requires_grad_(True)
            disc = dict(self.gan.named_parameters())
            disc_opt = disc_adamw(self.cfg, list(disc.values()))
        opt = stage1_adamw(self.cfg, list(params.values()), steps_per_epoch,
                           warmup_only=self.stage1_warmup_only)
        return Stage1State(0, params, opt, sn, disc, disc_opt)

    def stage2_params(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters: the UNet's and the mixing logit."""
        params = {f"unet.{k}": p for k, p in self.unet.named_parameters()}
        params["mixing_logit"] = self.mixing_logit
        return params

    def init_stage2(self, wrap=None) -> Stage2State:
        """Ready the pipeline for stage-2 training from its current weights:
        the UNet and the mixing logit train in fp32 (on the card laid out
        channels-last), the stage-1 modules are frozen, and under model.amp
        the frozen `stage2_bf16_modules` are cast to bf16 once (the bf16
        cast JAX takes of them every step).  `wrap(pipeline)` then runs
        before the state is built (the trainer's FSDP2 split of the UNet),
        so that the state's tensors are made from the wrapped parameters.
        Returns the state with fp32 EMA copies and a fresh optimizer:
        AdamW(lr, wd 0, bf16 mu) with gradient accumulation."""
        for name in self.stage1_modules:
            getattr(self, name).requires_grad_(False)
        self.unet.float().requires_grad_(True)
        self.mixing_logit.requires_grad_(True)
        if self.device.type == "cuda":
            for module in (self.unet, self.vae):
                module.to(memory_format=torch.channels_last)
        if self.amp:
            for name in self.stage2_bf16_modules:
                getattr(self, name).to(torch.bfloat16)
        if wrap is not None:
            wrap(self)
        params = self.stage2_params()
        ema = {k: p.detach().clone() for k, p in params.items()}
        return Stage2State(0, params, ema, stage2_adamw(self.cfg, list(params.values())))

    def stage2_latents(self, x, eps=None, generator: Optional[torch.Generator] = None):
        """The frozen encode of a stage-2 batch (`encode_latents` of the
        images or clips; the 3D domains encode the batch's point cloud)."""
        return self.encode_latents(x, eps, generator)

    def stage2_draws(self, b: int, generator: Optional[torch.Generator] = None) -> dict:
        """The draws `stage2_loss` makes for a batch of b, from `generator`
        in its order: the posterior eps (`stage2_eps`), t, the diffusion
        noise of the latents' shape (`stage2_z_shape`) and, for a masked
        denoiser, the mask's uniforms.  -> its keyword arguments."""
        eps = self.stage2_eps(b, generator)
        t = torch.randint(0, self.gd.num_timesteps, (b,), generator=generator,
                          device=self.device)
        noise = torch.randn(self.stage2_z_shape(b), generator=generator, device=self.device)
        mask = (torch.rand((b, self.unet.num_tokens()), generator=generator, device=self.device)
                if self.masked_denoiser else None)
        return {"eps": eps, "t": t, "noise": noise, "mask_noise": mask}

    # True where the denoiser trains masked (MDTv2 with a mask ratio)
    masked_denoiser = False

    def stage2_loss(self, x, generator: Optional[torch.Generator] = None, t=None, noise=None,
                    eps=None, mask_noise=None):
        """The stage-2 loss: the frozen encode (`stage2_latents`), then the
        diffusion loss through the denoiser (bf16 compute under model.amp,
        core/amp.py; the mixing logit stays fp32).  The posterior eps, the
        timesteps t, the diffusion noise and, for a masked denoiser, the
        (b, L) uniform mask draws are drawn from `generator`, in that order,
        where not given.  -> (loss, aux)."""
        z = self.stage2_latents(x, eps, generator)
        kwargs = {}
        if self.masked_denoiser:
            t, noise = draw_t_noise(self.gd, z, generator, t, noise)
            if mask_noise is None:
                mask_noise = torch.rand((z.shape[0], self.unet.num_tokens()),
                                        generator=generator, device=z.device)
            kwargs["mask_noise"] = mask_noise
        model_fn = amp_denoiser(self.unet, self.amp, **kwargs)
        return diffusion_loss(self.gd, model_fn, self.mixing_logit, z, generator, t, noise)

    def stage2_apply(self, state: Stage2State) -> None:
        """The optimizer (gradients taken from the parameters' .grad, which
        are cleared) and the EMA for one micro-step; advances state.step."""
        params = list(state.params.values())
        reduce_grads(params)
        state.opt.update(params, [p.grad for p in params])
        for p in params:
            p.grad = None
        ema_update(state.ema, state.params, state.step, beta=self.lc.ema_decay,
                   update_every=self.lc.ema_update_every)
        state.step += 1

    def stage2_train_step(self, state: Stage2State, x, generator: Optional[torch.Generator] = None,
                          t=None, noise=None, eps=None, mask_noise=None):
        """One micro-step: the loss and its gradients, then the optimizer and
        the EMA; the draws as in `stage2_loss`.  -> (state, aux of detached
        fp32 scalars)."""
        loss, aux = self.stage2_loss(x, generator, t=t, noise=noise, eps=eps,
                                     mask_noise=mask_noise)
        loss.backward()
        self.stage2_apply(state)
        return state, {k: v.detach() for k, v in aux.items()}


class ImagePipeline(LatentTraining, nn.Module):
    """The models of one image config: `unet` + `mixing_logit` (stage 2;
    `unet` is the MDTv2 transformer when model.DiT is set, with its side
    interpolater's parameters when ditconfig.mask_ratio is), `vae` + `mlp`
    (stage 1), and `gan` (the PatchGAN loss) for the adversarial stage-1
    configs.

    Parameters are initialised on `device` (the card unless the caller asks
    for the CPU) from `seed`; `load_state_dicts`
    replaces them with trained ones (reference state_dict layouts, see
    interop.py).  `cast(dtype)` casts every model parameter but
    `mixing_logit`, which stays fp32 as in the JAX package.  `perceptual`
    is the LPIPS of stage-1 training (evals/lpips.py::build_perceptual), or
    None to train without it, as the JAX pipeline's perceptual_fn."""

    stage1_warmup_only = True

    def __init__(self, cfg, device="cuda", seed: int = 0, perceptual: Optional[nn.Module] = None):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        self.is_dit = bool(m.DiT)
        self.masked_denoiser = self.is_dit and m.ditconfig.mask_ratio is not None
        device = resolve_device(device)
        cuda = [device.index or 0] if device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda, device_type="cuda"):
            torch.manual_seed(seed)
            with device:
                self.unet = MDTv2(m.ditconfig) if self.is_dit else UNet(m.unetconfig)
                self.vae = Autoencoder(m.ddconfig, embed_dim=m.embed_dim)
                self.mlp = INRImage(m.mlpconfig)
                self.gan = (GANLoss2D(m.ddconfig.in_channels, disc_weight=m.lossconfig.disc_weight)
                            if m.lossconfig.adversarial else None)
        self.diffaug_policy = tuple(m.lossconfig.extra.get("diffaugment") or ())
        self.perceptual = perceptual
        d = m.ddpmconfig
        self.mixing_logit = nn.Parameter(
            torch.full((1, d.channels, 1, 1), float(d.mixed_init), device=device)
        )
        self.gd = GaussianDiffusion.from_config(d).to(device)
        self.anchor = m.ddconfig.resolution
        self.amp = bool(m.amp)
        self.lc = m.lossconfig
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.mixing_logit.device

    def load_state_dicts(self, unet=None, vae=None, mlp=None, mixing_logit=None) -> None:
        """Load port state_dicts (strict); `mixing_logit` is (1, C, 1, 1)."""
        for module, sd in ((self.unet, unet), (self.vae, vae), (self.mlp, mlp)):
            if sd is not None:
                module.load_state_dict(sd, strict=True)
        if mixing_logit is not None:
            with torch.no_grad():
                self.mixing_logit.copy_(torch.as_tensor(mixing_logit).reshape(
                    self.mixing_logit.shape))

    def cast(self, dtype: torch.dtype) -> "ImagePipeline":
        """Cast the models' parameters; on CUDA also lay the UNet and the
        decoder out channels-last (cuDNN's fast layout, and the attention
        kernel's NHWC view)."""
        for module in (self.unet, self.vae, self.mlp):
            module.to(dtype)
            if self.device.type == "cuda" and module is not self.mlp:
                module.to(memory_format=torch.channels_last)
        return self

    def _hdbf_shapes(self, b: int):
        """NCHW shapes of the decoded pyramid, coarse to fine."""
        c = self.cfg.model.ddconfig
        shapes = []
        curr = c.resolution // 2 ** (len(c.ch_mult) - 1)
        for _ in range(len(c.ch_mult)):
            if curr in c.hdbf_resolutions:
                shapes.append((b, c.out_ch, curr, curr))
            curr *= 2
        shapes.append((b, c.out_ch, c.resolution, c.resolution))
        return shapes

    def _render_grid(self, hdbf, res: int, si, seed: int) -> torch.Tensor:
        """Regular res x res render -> (b, res * res, out_ch).  With no
        gradient recorded, in one call of the fused render (the INR decode
        kernel on CUDA, its plain version on the CPU): at 8 x 256^2 tokens
        the three (N, 128) bf16 token sets take 384 MB, small beside the
        card's memory, so the render is not tiled.  Under autograd, through
        the INRImage module (the fused render has no gradient), with its
        noise drawn from a generator seeded by `seed`."""
        if needs_grad(*hdbf, *self.mlp.parameters()):
            lin = pixel_center_lin(res, device=hdbf[0].device)
            gen = torch.Generator(device=hdbf[0].device).manual_seed(seed)
            return self.mlp(hdbf, si, grid_1d=(lin, lin), generator=gen)
        return render_tokens_fused(self.mlp, hdbf, res, si, seed)

    def latent_noise_shape(self, batch: int) -> Tuple[int, int, int, int]:
        """The shape of the DDIM's initial latent for a batch."""
        d = self.cfg.model.ddpmconfig
        return (batch, d.channels, d.image_size, d.image_size)

    @torch.inference_mode()
    def sample_images(self, batch: int, resolution: Optional[int] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      render_seed: int = 0) -> torch.Tensor:
        """DDIM + HDBF decode + INR render -> (batch, res, res, out_ch) in
        [0, 1], fp32 (`sample_latents`, then `decode_latents`).  `noise`
        (batch, C, h, w) is the initial latent; without it the latent is
        drawn from `generator`.  `render_seed` keys the INR's NoiseInjection
        draws."""
        return self.decode_latents(self.sample_latents(batch, noise, generator), resolution,
                                   render_seed)

    @torch.inference_mode()
    def sample_latents(self, batch: int, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The DDIM's latents (batch, C, h, w) fp32.  Encoder reuse
        (ddpmconfig.extra) needs the UNet's down/up split: with the MDTv2
        denoiser it raises ValueError."""
        shape = self.latent_noise_shape(batch)
        if self.is_dit:
            if self.gd.encoder_reuse > 1:
                raise ValueError("encoder_reuse needs the UNet down/up split; the MDTv2 "
                                 "(model.DiT) denoiser does not support it")
            z = ddim_sample(self.gd, self.unet, self.mixing_logit, shape, noise=noise,
                            generator=generator, device=self.device)
        else:
            z = ddim_sample_unet(
                self.gd, self.unet, self.mixing_logit, shape, noise=noise,
                generator=generator, device=self.device,
            )
        return z

    @torch.inference_mode()
    def decode_latents(self, z: torch.Tensor, resolution: Optional[int] = None,
                       render_seed: int = 0) -> torch.Tensor:
        """HDBF decode + INR render of DDIM latents -> (b, res, res, out_ch)
        in [0, 1], fp32."""
        batch = z.shape[0]
        res = resolution or self.cfg.data.test_resolution
        p_dtype = self.vae.post_quant_conv.weight.dtype
        hdbf = self.vae.decode(z.to(p_dtype))
        si = get_scale_injection(res, self.anchor)
        out = self._render_grid(hdbf, res, si, render_seed)
        img = out.float().reshape(batch, res, res, -1)
        return unsymmetrize(img.clamp(-1.0, 1.0))

    # ------------------------------------------------------------ stage 1

    def latent_shape(self, b: int) -> Tuple[int, int, int, int]:
        c = self.cfg.model.ddconfig
        r = c.resolution // 2 ** (len(c.ch_mult) - 1)
        return (b, self.cfg.model.embed_dim, r, r)

    def stage2_eps(self, b: int, generator: Optional[torch.Generator] = None):
        """The posterior's eps as `encode_latents` draws it."""
        return torch.randn(self.latent_shape(b), generator=generator, device=self.device)

    stage2_z_shape = latent_shape

    def draw_stage1(self, b: int, generator: Optional[torch.Generator] = None,
                    host_generator: Optional[torch.Generator] = None) -> Stage1Draws:
        """One micro-step's draws for a batch of b: the multiscale draws from
        `host_generator` (a CPU generator, so that the crop needs no read
        from the card), then from `generator` the posterior eps and the
        DiffAugment draws; the INR's noise is left to `generator`."""
        ms = draw_multiscale(self.anchor, host_generator)
        eps = torch.randn(self.latent_shape(b), generator=generator, device=self.device)
        aug = None
        if self.gan is not None and self.diffaug_policy:
            aug = draw_diffaugment((b, self.anchor, self.anchor, self.cfg.model.mlpconfig.out_ch),
                                   self.diffaug_policy, generator, self.device)
        return Stage1Draws(ms, eps, aug=aug)

    def stage1_loss(self, x: torch.Tensor, step: int, draws: Stage1Draws, sn_state,
                    generator: Optional[torch.Generator] = None):
        """The stage-1 loss of a batch x (b, H, W, C) in [0, 1]: the
        multiscale target and coordinates, encode -> posterior sample ->
        decode -> INR at the crop's coordinates, then sum over (H, W, C) of
        |output - target| averaged over the batch, plus the annealed KL
        (its coefficient reads the micro-step `step`), LPIPS and the
        spectral-norm regulariser on the fp32 masters.  Under model.amp the
        VAE and the INR compute on bf16 casts of their parameters with a
        bf16 input; the coordinates stay fp32 and the output returns to
        fp32 before the loss.  -> (loss, metrics, new sn state, (target,
        output, scale))."""
        lc = self.lc
        with span("stage1/multiscale"):
            x = symmetrize(x.float())
            target, coords, scale, y = multiscale_image_transform(x, self.anchor, lc.multiscale,
                                                                  draws.multiscale)
        b, res = target.shape[0], target.shape[1]
        with span("stage1/encode"):
            p_vae = compute_cast(dict(self.vae.named_parameters()), self.amp)
            p_mlp = compute_cast(dict(self.mlp.named_parameters()), self.amp)
            y = y.permute(0, 3, 1, 2).to(torch.bfloat16 if self.amp else torch.float32)
            if y.is_cuda:
                y = y.contiguous(memory_format=torch.channels_last)
            posterior = method_call(self.vae, p_vae, "encode", y)
            z = posterior.sample(draws.eps)
        with span("stage1/decode"):
            hdbf = method_call(self.vae, p_vae, "decode", z)
        with span("stage1/inr"):
            out = method_call(self.mlp, p_mlp, "forward", hdbf, scale,
                              coords=coords.reshape(1, res * res, 2),
                              generator=draws.noise if draws.noise is not None else generator)
            output = out.float().reshape(b, res, res, -1)

        kld = posterior.kl().float().mean()
        kl_coeff = stage1_kl_coeff(lc, self._stage1_total_iters, step)
        recon = (output - target).abs().sum(dim=(1, 2, 3)).mean()
        loss = recon + kl_coeff * kld
        p_loss = torch.zeros((), device=x.device)
        if self.perceptual is not None:
            with span("stage1/lpips"):
                p_loss = self.perceptual(target, output).mean()
            loss = loss + lc.perceptual_weight * p_loss
        new_sn, sn = sn_state, torch.zeros((), device=x.device)
        if lc.sn_reg:
            with span("stage1/sn"):
                sn, new_sn = spectral_norm_loss(self.vae, sn_state)
                sn = sn + norm_scale_loss(self.vae)
            loss = loss + sn * stage1_sn_weight(lc, kl_coeff)
        metrics = {"loss": loss, "recon": recon, "kl": kld, "kl_coeff": kl_coeff,
                   "lpips": p_loss, "sn": sn}
        return loss, metrics, new_sn, (target, output, scale)

    def _augment(self, x, draws: Stage1Draws):
        return diff_augment(x, self.diffaug_policy, draws.aug) if draws.aug else x

    def stage1_train_step(self, state: Stage1State, x: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          host_generator: Optional[torch.Generator] = None,
                          draws: Optional[Stage1Draws] = None):
        """One micro-step: the loss and its gradients, then the optimizer (and
        for the adversarial configs the discriminator's loss, gradient and
        optimizer, from the same forward); the draws are `draws` or made by
        `draw_stage1`.  Advances state.step.  -> (state, metrics of
        detached scalars)."""
        if draws is None:
            draws = self.draw_stage1(x.shape[0], generator, host_generator)
        loss, metrics, sn, (target, output, scale) = self.stage1_loss(
            x, state.step, draws, state.sn, generator)
        if self.gan is None:
            with span("stage1/backward"):
                loss.backward()
        else:
            with span("stage1/gan"):
                t_aug, o_aug = self._augment(target, draws), self._augment(output, draws)
                # the generator's gradient with respect to the discriminator
                # is not taken (JAX discards it)
                self.gan.requires_grad_(False)
                g_gan = self.gan.generator_loss(t_aug, o_aug, scale)
            with span("stage1/backward"):
                (loss + g_gan).backward()
            with span("stage1/gan"):
                self.gan.requires_grad_(True)
                d_loss = self.gan.discriminator_loss(t_aug, o_aug, scale)
                d_loss.backward()
                disc = list(state.disc.values())
                reduce_grads(disc)
                state.disc_opt.update(disc, [p.grad for p in disc])
                for p in disc:
                    p.grad = None
            metrics = dict(metrics, g_gan=g_gan, d_loss=d_loss)
        with span("stage1/optimizer"):
            params = list(state.params.values())
            reduce_grads(params)
            state.opt.update(params, [p.grad if p.grad is not None else torch.zeros_like(p)
                                      for p in params])
            for p in params:
                p.grad = None
        state.sn = sn
        state.step += 1
        return state, {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}

    @torch.no_grad()
    def reconstruct(self, x: torch.Tensor, resolution: Optional[int] = None,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    render_seed: int = 0) -> torch.Tensor:
        """Reconstruction at any resolution (the rFID path): x (b, H, W, C)
        in [0, 1] is resized to the anchor, symmetrized and clipped,
        encoded, sampled with `eps` (drawn from `generator` when not given),
        decoded, and rendered at resolution x resolution (the anchor when
        None) with scale injection anchor / resolution through the fused
        render: the INR decode kernel on the card, its plain version on the
        CPU, its NoiseInjection keyed by `render_seed`.  Under model.amp the
        VAE computes on bf16 casts of its parameters; on the card the render
        takes the kernel's bf16 tokens.  -> (b, res, res, out_ch) in [0, 1],
        fp32."""
        res = resolution or self.anchor
        dtype = torch.bfloat16 if self.amp else self.vae.post_quant_conv.weight.dtype
        y = resize_antialias(symmetrize(x.to(self.device).float()), self.anchor).clamp(-1.0, 1.0)
        y = y.permute(0, 3, 1, 2).to(dtype)
        if y.is_cuda:
            y = y.contiguous(memory_format=torch.channels_last)
        p_vae = {k: v.to(dtype) for k, v in self.vae.named_parameters()}
        posterior = method_call(self.vae, p_vae, "encode", y)
        if eps is None:
            eps = torch.randn(posterior.mean.shape, generator=generator, device=self.device)
        hdbf = method_call(self.vae, p_vae, "decode", posterior.sample(eps.to(self.device)))
        if self.device.type == "cuda":
            hdbf = [h.to(torch.bfloat16) for h in hdbf]
        out = self._render_grid(hdbf, res, get_scale_injection(res, self.anchor), render_seed)
        img = out.float().reshape(x.shape[0], res, res, -1)
        return unsymmetrize(img.clamp(-1.0, 1.0))

    # ------------------------------------------------------------ stage 2

    @torch.no_grad()
    def encode_latents(self, x, eps=None, generator: Optional[torch.Generator] = None):
        """The frozen stage-1 encode: x (b, H, W, 3) in [0, 1] is resized to
        the anchor, symmetrized and clipped, encoded (bf16 under model.amp)
        and sampled with standard-normal fp32 `eps` (drawn from `generator`
        when not given) -> fp32 latents (b, embed_dim, h, w)."""
        y = resize_antialias(symmetrize(x.float()), self.anchor).clamp(-1.0, 1.0)
        y = y.permute(0, 3, 1, 2).to(self.vae.quant_conv.weight.dtype)
        if y.is_cuda:
            y = y.contiguous(memory_format=torch.channels_last)
        posterior = self.vae.encode(y)
        if eps is None:
            eps = torch.randn(posterior.mean.shape, generator=generator, device=y.device)
        return posterior.sample(eps).float()
