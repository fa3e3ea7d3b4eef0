"""Image domain, sampling half (counterpart of ddmi_tpu/domains/image.py::
ImagePipeline): DDIM over the UNet, HDBF decode, INR render.

Training, reconstruction and the MDTv2 denoiser wait for later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ddmi_tpu_torch.core.coords import get_scale_injection, unsymmetrize
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, ddim_sample_unet
from ddmi_tpu_torch.nn.inr import INRImage
from ddmi_tpu_torch.nn.unet import UNet
from ddmi_tpu_torch.nn.vae import Autoencoder
from ddmi_tpu_torch.ops.inr_decode import render_tokens_fused


class ImagePipeline(nn.Module):
    """The sampling models of one image config: `unet` + `mixing_logit`
    (stage 2), `vae` (decode half) + `mlp` (stage 1).

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
        """Regular res x res render -> (b, res * res, out_ch), in one call of
        the fused render (the INR decode kernel on CUDA, its plain version on
        the CPU): at 8 x 256^2 tokens the three (N, 128) bf16 token sets take
        384 MB, small beside the card's memory, so the render is not tiled."""
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
