"""Video domain, sampling half (counterpart of ddmi_tpu/domains/video.py::
VideoPipeline.sample_videos): DDIM over the [xy | xt | yt] latent tokens
with the TriplaneUNet, the triplane decode, and the INR render one frame at
a time.

The TimeSformer encoder and training wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ddmi_tpu_torch.core.coords import unsymmetrize
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, ddim_sample_unet
from ddmi_tpu_torch.nn.inr import INRVideo
from ddmi_tpu_torch.nn.unet_triplane import TriplaneUNet
from ddmi_tpu_torch.nn.video_vae import VideoAutoencoder
from ddmi_tpu_torch.ops.resample import pixel_center_lin


def video_axes(t: int, h: int, w: int, device=None):
    """Pixel-centre axes (ts, ys, xs), each [-(n-1)/n, (n-1)/n], as the
    reference passes them at train and eval time."""
    return tuple(pixel_center_lin(k, device=device) for k in (t, h, w))


class VideoPipeline(nn.Module):
    """The sampling models of one video config: `unet` (TriplaneUNet) +
    `mixing_logit` (1, 1, C) (stage 2), `vae` (decode half) + `mlp`
    (INRVideo) (stage 1).

    Parameters are initialised on `device` (the card unless the caller asks
    for the CPU) from `seed`; `load_state_dicts` replaces them with trained
    ones (reference state_dict layouts, see interop.py).  `cast(dtype)`
    casts every model parameter but `mixing_logit`, which stays fp32."""

    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__()
        m = cfg.model
        if m.DiT:
            raise NotImplementedError("the MDTv2 denoiser is not ported")
        if int(m.ddpmconfig.extra.get("encoder_reuse", 1)) != 1:
            raise NotImplementedError("encoder_reuse > 1 is not ported")
        self.cfg = cfg
        self.frames = cfg.data.frames
        self.res = m.ddconfig.resolution
        r = self.res // 8
        self.n_latent_tokens = r * r + 2 * self.frames * r
        u = m.unetconfig
        if not u.plane_sizes:
            u = dataclasses.replace(
                u, plane_sizes=((r, r), (self.frames, r), (self.frames, r)))
        device = resolve_device(device)
        cuda = [device.index or 0] if device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda, device_type="cuda"):
            torch.manual_seed(seed)
            with device:
                self.unet = TriplaneUNet(u)
                self.vae = VideoAutoencoder(m.ddconfig, m.embed_dim, self.frames)
                self.mlp = INRVideo(m.mlpconfig)
        d = m.ddpmconfig
        self.mixing_logit = nn.Parameter(
            torch.full((1, 1, d.channels), float(d.mixed_init), device=device))
        self.gd = GaussianDiffusion.from_config(d).to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.mixing_logit.device

    def load_state_dicts(self, unet=None, vae=None, mlp=None, mixing_logit=None) -> None:
        """Load port state_dicts (strict); `mixing_logit` is (1, 1, C)."""
        for module, sd in ((self.unet, unet), (self.vae, vae), (self.mlp, mlp)):
            if sd is not None:
                module.load_state_dict(sd, strict=True)
        if mixing_logit is not None:
            with torch.no_grad():
                self.mixing_logit.copy_(torch.as_tensor(mixing_logit).reshape(
                    self.mixing_logit.shape))

    def cast(self, dtype: torch.dtype) -> "VideoPipeline":
        """Cast the models' parameters; on CUDA also lay the convolution
        weights out channels-last (the planes are channels-last views)."""
        for module in (self.unet, self.vae, self.mlp):
            module.to(dtype)
            if self.device.type == "cuda" and module is not self.mlp:
                module.to(memory_format=torch.channels_last)
        return self

    def render(self, hdbf, frame: int) -> torch.Tensor:
        """One frame of the INR render -> (b, res * res, out_ch)."""
        ts, ys, xs = video_axes(self.frames, self.res, self.res, self.device)
        return self.mlp(hdbf, (ts[frame : frame + 1], ys, xs))

    @torch.inference_mode()
    def sample_videos(self, batch: int, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM + triplane decode + INR render -> (batch, frames, res, res,
        out_ch) in [0, 1], fp32.  `noise` (batch, n_latent_tokens, C) is the
        initial latent; without it the latent is drawn from `generator`."""
        d = self.cfg.model.ddpmconfig
        shape = (batch, self.n_latent_tokens, d.channels)
        z = ddim_sample_unet(self.gd, self.unet, self.mixing_logit, shape, noise=noise,
                             generator=generator, device=self.device)
        hdbf = self.vae.decode(z.to(self.vae.post_xy.weight.dtype))
        # one frame at a time, as the JAX package's lax.map: the whole voxel
        # grid (16 x 256^2 tokens at batch 2) would hold every MLP
        # activation at once
        out = torch.stack([self.render(hdbf, f).float() for f in range(self.frames)], dim=1)
        vid = out.reshape(batch, self.frames, self.res, self.res, -1)
        return unsymmetrize(vid.clamp(-1.0, 1.0))
