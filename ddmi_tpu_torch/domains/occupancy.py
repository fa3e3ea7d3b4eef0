"""3D occupancy domain, inference half (counterpart of
ddmi_tpu/domains/occupancy.py::OccupancyPipeline: `sample_latents`,
`decode_pyramids`, `logits_from_pyramids`, `decode_logits_fn`,
`encode_latents`, `occupancy_logits`).

Generation: DDIM over the channel-concat triplane latents z (b, 3 *
embed_dim, r, r), channels [xy | xz | yz], with the 2D UNet (the one TPU
kernel on the path is its fused attention block); the triplane decoder
turns z into three HDBF pyramids (xy, yz, xz); INR3D evaluates occupancy
logits at query points; geometry/generation.py extracts meshes.
Reconstruction: a point cloud through the pointnet ({xz, xy, yz} feature
planes), the triplane encoder and the posterior to latents.

Under bf16 parameters the encoder runs in bf16 (the feature planes are
cast to it, as JAX's `encode_latents` casts them), the pointnet and INR3D
promote as flax does (see nn/inr.py), the posterior draws are formed in
fp32, and latents return fp32.  The decoder runs in the parameters' dtype:
z is cast to it, as the JAX image and NeRF paths cast it before their
decodes (the JAX occupancy service hands the decoder fp32 z, which flax
promotes to an fp32 decode on bf16-valued weights).

Training (stage 1 and 2) waits for a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ddmi_tpu_torch.core.convocc_config import (
    encoder_name,
    generation_kwargs,
    load_convocc_config,
    pointnet_kwargs,
)
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, ddim_sample_unet
from ddmi_tpu_torch.nn.inr import INR3D
from ddmi_tpu_torch.nn.pointnet import LocalPoolPointnet
from ddmi_tpu_torch.nn.triplane_vae import TriplaneAutoencoder
from ddmi_tpu_torch.nn.unet import UNet


class OccupancyPipeline(nn.Module):
    """The models of one occupancy config: `unet` + `mixing_logit` (1, C, 1,
    1) (stage 2); `pointnet`, `vae` (encoder, posterior convs and decoder)
    and `mlp` (INR3D) (stage 1).  The pointnet's and the mesh extraction's
    settings come from `data.conv_config` (configs/convocc/pointcloud/
    shapenet_3plane.yaml, read from the working directory as the JAX package
    reads it), else the pointnet's from `model.pointnet` and the extraction
    keeps its defaults.

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
        dd = m.ddconfig
        self.generation_kwargs = generation_kwargs({})
        if cfg.data.conv_config:
            conv_cfg = load_convocc_config(cfg.data.conv_config)
            if encoder_name(conv_cfg) != "pointnet_local_pool":
                raise NotImplementedError(
                    f"encoder {encoder_name(conv_cfg)!r} is not ported")
            pn_kwargs = pointnet_kwargs(conv_cfg)
            self.generation_kwargs = generation_kwargs(conv_cfg)
        else:
            enc = m.extra.get("pointnet", {})
            pn_kwargs = dict(c_dim=enc.get("c_dim", dd.in_channels),
                             hidden_dim=enc.get("hidden_dim", 256),
                             plane_resolution=enc.get("plane_resolution", dd.resolution),
                             n_blocks=enc.get("n_blocks", 7))
        self.latent_res = dd.resolution // 2 ** (len(dd.ch_mult) - 1)
        device = resolve_device(device)
        cuda = [device.index or 0] if device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda, device_type="cuda"):
            torch.manual_seed(seed)
            with device:
                self.unet = UNet(m.unetconfig)
                self.pointnet = LocalPoolPointnet(**pn_kwargs)
                self.vae = TriplaneAutoencoder(dd, embed_dim=m.embed_dim, with_encoder=True)
                self.mlp = INR3D(m.mlpconfig)
        d = m.ddpmconfig
        self.mixing_logit = nn.Parameter(
            torch.full((1, d.channels, 1, 1), float(d.mixed_init), device=device))
        self.gd = GaussianDiffusion.from_config(d).to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.mixing_logit.device

    def load_state_dicts(self, unet=None, pointnet=None, vae=None, mlp=None,
                         mixing_logit=None) -> None:
        """Load port state_dicts (strict); `mixing_logit` has C values."""
        for module, sd in ((self.unet, unet), (self.pointnet, pointnet), (self.vae, vae),
                           (self.mlp, mlp)):
            if sd is not None:
                module.load_state_dict(sd, strict=True)
        if mixing_logit is not None:
            with torch.no_grad():
                self.mixing_logit.copy_(torch.as_tensor(mixing_logit).reshape(
                    self.mixing_logit.shape))

    def cast(self, dtype: torch.dtype) -> "OccupancyPipeline":
        """Cast the models' parameters; on CUDA also lay the UNet and the
        VAE out channels-last (the attention kernel's NHWC view)."""
        for module in (self.unet, self.pointnet, self.vae, self.mlp):
            module.to(dtype)
            if self.device.type == "cuda" and module in (self.unet, self.vae):
                module.to(memory_format=torch.channels_last)
        return self

    @property
    def vae_dtype(self) -> torch.dtype:
        return self.vae.post_quant_conv_xy.weight.dtype

    # ------------------------------------------------------------ stage 1

    @torch.no_grad()
    def encode_latents(self, cloud: torch.Tensor,
                       eps: Optional[Sequence[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z = the channel-concat posterior samples [xy | xz | yz], fp32 (b,
        3 * embed_dim, r, r).  `eps` holds the three draws' standard-normal
        noise in plane order (xy, yz, xz), each (b, embed_dim, r, r); without
        it they are drawn from `generator`.  The pointnet's feature planes
        enter the encoder in the VAE's dtype."""
        fea = self.pointnet(cloud.to(self.device))
        dt = self.vae_dtype
        posts = self.vae.encode((fea["xy"].to(dt), fea["yz"].to(dt), fea["xz"].to(dt)))
        if eps is None:
            eps = [torch.randn(p.mean.shape, generator=generator, device=self.device)
                   for p in posts]
        xy, yz, xz = (p.sample(e.to(self.device)).float() for p, e in zip(posts, eps))
        return torch.cat([xy, xz, yz], dim=1)

    @torch.no_grad()
    def occupancy_logits(self, cloud: torch.Tensor, query_points: torch.Tensor,
                         eps: Sequence[torch.Tensor]) -> torch.Tensor:
        """Encode a point cloud (a posterior draw per plane from `eps`),
        decode it and evaluate the logits at query_points (b, n, 3)."""
        pyramids = self.decode_pyramids(self.encode_latents(cloud, eps))
        return self.mlp(query_points.to(self.device), pyramids)

    # ------------------------------------------------------------ stage 2

    def sample_latents(self, batch: int, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM -> z (batch, C, r, r) fp32; `noise` (batch, C, r, r) is the
        initial latent, else it is drawn from `generator`."""
        r, c = self.latent_res, self.cfg.model.ddpmconfig.channels
        return ddim_sample_unet(self.gd, self.unet, self.mixing_logit, (batch, c, r, r),
                                noise=noise, generator=generator, device=self.device)

    @torch.no_grad()
    def decode_pyramids(self, z: torch.Tensor):
        """z (b, 3 * embed_dim, r, r) -> the (xy, yz, xz) HDBF pyramids, each
        a list of NCHW planes coarse to fine, in the VAE's dtype (not
        inference tensors: refinement differentiates the logits through
        them)."""
        return self.vae.decode(z.to(self.device, self.vae_dtype))

    def logits_from_pyramids(self, points: torch.Tensor, pyramids) -> torch.Tensor:
        """Occupancy logits at points (b, n, 3) given decoded pyramids
        (differentiable in points)."""
        return self.mlp(points, pyramids)

    def decode_logits_fn(self, z: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
        """fn(points (b, n, 3)) -> logits, on the pyramids decoded once from
        z."""
        pyramids = self.decode_pyramids(z)
        return lambda points: self.logits_from_pyramids(points, pyramids)
