"""Image domain (counterpart of ddmi_tpu/domains/image.py::ImagePipeline):
sampling (DDIM over the UNet, HDBF decode, INR render) and stage-2 training
(the frozen VAE encoder, the diffusion loss through the UNet, AdamW with
gradient accumulation, EMA).

Stage-1 training, reconstruction and the MDTv2 denoiser wait for later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ddmi_tpu_torch.core.amp import amp_denoiser
from ddmi_tpu_torch.core.coords import (
    get_scale_injection, resize_antialias, symmetrize, unsymmetrize,
)
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.core.ema import ema_update
from ddmi_tpu_torch.core.optim import stage2_adamw
from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, ddim_sample_unet, diffusion_loss
from ddmi_tpu_torch.nn.inr import INRImage
from ddmi_tpu_torch.nn.unet import UNet
from ddmi_tpu_torch.nn.vae import Autoencoder
from ddmi_tpu_torch.ops.attention import needs_grad
from ddmi_tpu_torch.ops.inr_decode import render_tokens_fused
from ddmi_tpu_torch.ops.resample import pixel_center_lin


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


class ImagePipeline(nn.Module):
    """The models of one image config: `unet` + `mixing_logit` (stage 2),
    `vae` + `mlp` (stage 1).

    Parameters are initialised on `device` (the card unless the caller asks
    for the CPU) from `seed`; `load_state_dicts`
    replaces them with trained ones (reference state_dict layouts, see
    interop.py).  `cast(dtype)` casts every model parameter but
    `mixing_logit`, which stays fp32 as in the JAX package."""

    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__()
        m = cfg.model
        if m.DiT:
            raise NotImplementedError("the MDTv2 denoiser is not ported")
        if int(m.ddpmconfig.extra.get("encoder_reuse", 1)) != 1:
            raise NotImplementedError("encoder_reuse > 1 is not ported")
        self.cfg = cfg
        device = resolve_device(device)
        cuda = [device.index or 0] if device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda, device_type="cuda"):
            torch.manual_seed(seed)
            with device:
                self.unet = UNet(m.unetconfig)
                self.vae = Autoencoder(m.ddconfig, embed_dim=m.embed_dim)
                self.mlp = INRImage(m.mlpconfig)
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

    @torch.inference_mode()
    def sample_images(self, batch: int, resolution: Optional[int] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      render_seed: int = 0) -> torch.Tensor:
        """DDIM + HDBF decode + INR render -> (batch, res, res, out_ch) in
        [0, 1], fp32.  `noise` (batch, C, h, w) is the initial latent; without
        it the latent is drawn from `generator`.  `render_seed` keys the INR's
        NoiseInjection draws."""
        m = self.cfg.model
        res = resolution or self.cfg.data.test_resolution
        d = m.ddpmconfig
        shape = (batch, d.channels, d.image_size, d.image_size)
        z = ddim_sample_unet(
            self.gd, self.unet, self.mixing_logit, shape, noise=noise,
            generator=generator, device=self.device,
        )
        p_dtype = self.vae.post_quant_conv.weight.dtype
        hdbf = self.vae.decode(z.to(p_dtype))
        si = get_scale_injection(res, self.anchor)
        out = self._render_grid(hdbf, res, si, render_seed)
        img = out.float().reshape(batch, res, res, -1)
        return unsymmetrize(img.clamp(-1.0, 1.0))

    # ------------------------------------------------------------ stage 2

    def stage2_params(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters: the UNet's and the mixing logit."""
        params = {f"unet.{k}": p for k, p in self.unet.named_parameters()}
        params["mixing_logit"] = self.mixing_logit
        return params

    def stage2_optimizer(self, params: Dict[str, torch.Tensor]):
        """AdamW(lr, wd 0, bf16 mu) with gradient accumulation."""
        return stage2_adamw(self.cfg, list(params.values()))

    def init_stage2(self) -> Stage2State:
        """Ready the pipeline for stage-2 training from its current weights:
        the UNet and the mixing logit train in fp32 (on the card laid out
        channels-last), the VAE and the INR are frozen, and under model.amp
        the frozen VAE is cast to bf16 once (the bf16 cast JAX takes of it
        every step).  Returns the state with fp32 EMA copies and a fresh
        optimizer."""
        for module in (self.vae, self.mlp):
            module.requires_grad_(False)
        self.unet.float().requires_grad_(True)
        self.mixing_logit.requires_grad_(True)
        if self.device.type == "cuda":
            for module in (self.unet, self.vae):
                module.to(memory_format=torch.channels_last)
        if self.amp:
            self.vae.to(torch.bfloat16)
        params = self.stage2_params()
        ema = {k: p.detach().clone() for k, p in params.items()}
        return Stage2State(0, params, ema, self.stage2_optimizer(params))

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

    def stage2_loss(self, x, generator: Optional[torch.Generator] = None, t=None, noise=None,
                    eps=None):
        """The stage-2 loss: encode, then the diffusion loss through the UNet
        (bf16 compute under model.amp, core/amp.py).  The posterior eps,
        the timesteps t and the diffusion noise are drawn from `generator`,
        in that order, where not given.  -> (loss, aux)."""
        z = self.encode_latents(x, eps, generator)
        model_fn = amp_denoiser(self.unet, self.amp)
        return diffusion_loss(self.gd, model_fn, self.mixing_logit, z, generator, t, noise)

    def stage2_apply(self, state: Stage2State) -> None:
        """The optimizer (gradients taken from the parameters' .grad, which
        are cleared) and the EMA for one micro-step; advances state.step."""
        params = list(state.params.values())
        state.opt.update(params, [p.grad for p in params])
        for p in params:
            p.grad = None
        ema_update(state.ema, state.params, state.step, beta=self.lc.ema_decay,
                   update_every=self.lc.ema_update_every)
        state.step += 1

    def stage2_train_step(self, state: Stage2State, x, generator: Optional[torch.Generator] = None,
                          t=None, noise=None, eps=None):
        """One micro-step: the loss and its gradients, then the optimizer and
        the EMA; the draws as in `stage2_loss`.  -> (state, aux of detached
        fp32 scalars)."""
        loss, aux = self.stage2_loss(x, generator, t=t, noise=noise, eps=eps)
        loss.backward()
        self.stage2_apply(state)
        return state, {k: v.detach() for k, v in aux.items()}
