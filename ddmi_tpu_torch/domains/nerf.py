"""NeRF domain, sampling half (counterpart of ddmi_tpu/domains/nerf.py::
NeRFPipeline.sample_nerfs): DDIM over triplane latents with the 2D UNet,
the triplane decode, and a volume render of a spherical camera path through
the NeRF MLP.

Rays, stratified samples (perturb 0 at sampling, so the render draws no
random numbers), the triplane lookup (pts / 3.5, align_corners=True,
border), the frequency embeddings and the alpha compositing stay fp32; the
MLP input is cast to the parameters' dtype.  With no gradient recorded and
wherever the kernel's predicate takes the MLP's width (256) the MLP runs as
`nerf_mlp_fused`: on the card the hand-written kernel of csrc/nerf_mlp.cu,
on the CPU its plain version; other widths, and any render under autograd,
run the INRNeRF module, as the JAX package does.

The point-cloud encoder and training wait for later slices.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.core.convocc_config import load_convocc_config, nerf_kwargs
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, ddim_sample_unet
from ddmi_tpu_torch.nn.inr import FreqEmbedding, INRNeRF
from ddmi_tpu_torch.nn.triplane_vae import TriplaneAutoencoder
from ddmi_tpu_torch.nn.unet import UNet
from ddmi_tpu_torch.ops import nerf_mlp
from ddmi_tpu_torch.ops.attention import needs_grad
from ddmi_tpu_torch.ops.grid_sample import grid_sample_2d

# srn-cars camera intrinsics (the JAX package's, from the reference trainer)
FOV = 0.6911112070083618
NEAR, FAR = 2.0, 6.0
RAY_CHUNK = 4096


def intrinsics(H: int, W: int) -> Tuple[float, float, float]:
    focal = 0.5 * W / math.tan(0.5 * FOV)
    return focal, 0.5 * W, 0.5 * H


def get_rays(H: int, W: int, c2w: torch.Tensor):
    """Pixel rays in the world frame: dirs ((i - cx) / f, -(j - cy) / f, -1)
    rotated by c2w.  -> (H, W, 3) origins and directions, fp32."""
    focal, cx, cy = intrinsics(H, W)
    c2w = c2w.float()
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=c2w.device),
                          torch.arange(W, dtype=torch.float32, device=c2w.device),
                          indexing="ij")
    dirs = torch.stack([(i - cx) / focal, -(j - cy) / focal, -torch.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].t()
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def sample_triplane(planes: Dict[str, torch.Tensor], pts: torch.Tensor) -> torch.Tensor:
    """Triplane features at world points: planes NCHW with batch 1, pts
    (..., 3) -> (..., 3c), features concatenated xy, yz, xz, where the xy
    plane is sampled at (x, y), yz at (y, z) and xz at (x, z) of pts / 3.5."""
    p = (pts.float() / 3.5).reshape(1, -1, 3)
    feats = [
        grid_sample_2d(planes[key].permute(0, 2, 3, 1), p[..., list(sel)])
        for key, sel in (("xy", (0, 1)), ("yz", (1, 2)), ("xz", (0, 2)))
    ]
    return torch.cat(feats, -1).reshape(*pts.shape[:-1], -1)


def raw2outputs(raw, z_vals, rays_d, white_bkgd: bool):
    """Alpha compositing with softplus density -> (rgb (n, 3), weights
    (n, s), acc (n,))."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    rgb = raw[..., :3]
    alpha = 1.0 - torch.exp(-F.softplus(raw[..., 3]) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1), dim=-1
    )[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    acc_map = torch.sum(weights, -1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, weights, acc_map


def spherical_poses(n_views: int, radius: float = 1.3, elevation: float = -0.3,
                    device=None) -> torch.Tensor:
    """Camera-to-world matrices (n_views, 4, 4) of the generation path,
    looking at the origin (the reference's spherical trajectory)."""
    poses = []
    for theta in np.linspace(0, 2 * np.pi, n_views, endpoint=False):
        cam_pos = np.array([radius * np.cos(theta), radius * np.sin(theta),
                            -radius * elevation])
        forward = -cam_pos / np.linalg.norm(cam_pos)
        right = np.cross(forward, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        up = np.cross(right, forward)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -forward, cam_pos
        poses.append(c2w)
    return torch.tensor(np.stack(poses), dtype=torch.float32, device=device)


class NeRFPipeline(nn.Module):
    """The sampling models of one NeRF config: `unet` + `mixing_logit`
    (1, C, 1, 1) (stage 2), `vae` (triplane decode half) + `mlp` (INRNeRF)
    (stage 1).  Render settings come from `data.conv_config`'s model.TN
    block, else from `mlpconfig` extras.

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
        tn = nerf_kwargs(load_convocc_config(cfg.data.conv_config)) \
            if cfg.data.conv_config else {}
        mc = m.mlpconfig.extra
        multires = tn.get("multires", mc.get("multires", 10))
        multires_views = tn.get("multires_views", mc.get("multires_views", 4))
        self.embed_xyz = FreqEmbedding(multires)
        self.embed_dir = FreqEmbedding(multires_views)
        self.n_samples = int(tn.get("N_samples", mc.get("N_samples", 256)))
        self.white_bkgd = bool(tn.get("white_bkgd", mc.get("white_bkgd", True)))
        dd = m.ddconfig
        self.latent_res = dd.resolution // 2 ** (len(dd.ch_mult) - 1)
        device = resolve_device(device)
        cuda = [device.index or 0] if device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda, device_type="cuda"):
            torch.manual_seed(seed)
            with device:
                self.unet = UNet(m.unetconfig)
                self.vae = TriplaneAutoencoder(dd, embed_dim=m.embed_dim)
                self.mlp = INRNeRF(
                    depth=mc.get("D", 6), width=mc.get("W", 256),
                    in_channels_xyz=3 * dd.out_ch + self.embed_xyz.out_dim(),
                    in_channels_dir=self.embed_dir.out_dim(),
                    skips=tuple(mc.get("skips", (2, 4))),
                )
        d = m.ddpmconfig
        self.mixing_logit = nn.Parameter(
            torch.full((1, d.channels, 1, 1), float(d.mixed_init), device=device))
        self.gd = GaussianDiffusion.from_config(d).to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.mixing_logit.device

    def load_state_dicts(self, unet=None, vae=None, mlp=None, mixing_logit=None) -> None:
        """Load port state_dicts (strict); `mixing_logit` has C values."""
        for module, sd in ((self.unet, unet), (self.vae, vae), (self.mlp, mlp)):
            if sd is not None:
                module.load_state_dict(sd, strict=True)
        if mixing_logit is not None:
            with torch.no_grad():
                self.mixing_logit.copy_(torch.as_tensor(mixing_logit).reshape(
                    self.mixing_logit.shape))

    def cast(self, dtype: torch.dtype) -> "NeRFPipeline":
        """Cast the models' parameters; on CUDA also lay the UNet and the
        decoder out channels-last (the attention kernel's NHWC view)."""
        for module in (self.unet, self.vae, self.mlp):
            module.to(dtype)
            if self.device.type == "cuda" and module is not self.mlp:
                module.to(memory_format=torch.channels_last)
        return self

    # ----------------------------------------------------------- render

    def fold_mlp(self) -> Optional[nerf_mlp.FoldedNeRF]:
        """The MLP in the kernel's layout, in the parameters' dtype, or None
        where the kernel does not take its width (JAX's predicate) or its
        input widths (the CUDA kernel's shared memory)."""
        m = self.mlp
        if not nerf_mlp.kernel_supported(m.width, m.in_channels_xyz, m.in_channels_dir):
            return None
        return nerf_mlp.fold_nerf_params(m, dtype=m.sigma.weight.dtype)

    def mlp_input(self, planes, rays_o, rays_d):
        """-> (x (n, s, in_xyz + in_dir) in the parameters' dtype, z (n, s)):
        the triplane features and both embeddings at the ray samples."""
        n, s = rays_o.shape[0], self.n_samples
        t = torch.linspace(0.0, 1.0, s, device=rays_o.device)
        z = (NEAR * (1 - t) + FAR * t).expand(n, s)
        pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        dtype = self.mlp.sigma.weight.dtype
        e_dir = self.embed_dir(viewdirs).to(dtype)[:, None].expand(n, s, -1)
        x = torch.cat([sample_triplane(planes, pts).to(dtype),
                       self.embed_xyz(pts).to(dtype), e_dir], -1)
        return x, z

    def run_mlp(self, x, folded=None) -> torch.Tensor:
        """x (..., in_xyz + in_dir) -> raw (..., 4) fp32.  Under autograd
        (a gradient recorded for x or the MLP's parameters) through the
        INRNeRF module, whose gradients the fused MLP would drop: the fold
        copies the weights detached, as JAX's `_fused_mlp_gate` takes the
        kernel only in inference traces."""
        if needs_grad(x, *self.mlp.parameters()):
            return self.mlp(x).float()
        if folded is None:
            folded = self.fold_mlp()
        if folded is None:
            return self.mlp(x).float()
        return nerf_mlp.nerf_mlp_fused(folded, x.reshape(-1, x.shape[-1])).reshape(
            *x.shape[:-1], 4)

    def render_rays(self, planes, rays_o, rays_d, folded=None) -> torch.Tensor:
        """rays_o / rays_d (n, 3) -> rgb (n, 3) fp32."""
        x, z = self.mlp_input(planes, rays_o, rays_d)
        raw = self.run_mlp(x, folded)
        return raw2outputs(raw, z, rays_d, self.white_bkgd)[0]

    def render_image(self, planes, pose, H: int, W: int, folded=None) -> torch.Tensor:
        """One view -> (H, W, 3), rendered RAY_CHUNK rays at a time (4
        chunks at 128^2; a last chunk may be short)."""
        rays_o, rays_d = get_rays(H, W, pose)
        ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        if folded is None:
            folded = self.fold_mlp()
        rgb = [self.render_rays(planes, ro[k : k + RAY_CHUNK], rd[k : k + RAY_CHUNK], folded)
               for k in range(0, ro.shape[0], RAY_CHUNK)]
        return torch.cat(rgb).reshape(H, W, 3)

    def spherical_poses(self, n_views: int, radius: float = 1.3,
                        elevation: float = -0.3) -> torch.Tensor:
        return spherical_poses(n_views, radius, elevation, device=self.device)

    def decode_planes(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        """z (b, 3 * embed_dim, r, r) -> {"xy", "yz", "xz"}: the first plane
        of each decoded pyramid (srn_cars has no HDBF taps, so each pyramid
        is the one decoded plane), NCHW."""
        pyr_xy, pyr_yz, pyr_xz = self.vae.decode(z.to(self.vae.post_quant_conv_xy.weight.dtype))
        return {"xy": pyr_xy[0], "yz": pyr_yz[0], "xz": pyr_xz[0]}

    # --------------------------------------------------------- sampling

    def sample_latents(self, batch: int, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM -> z (batch, C, r, r) fp32; `noise` (batch, C, r, r) is the
        initial latent, else it is drawn from `generator`."""
        r, c = self.latent_res, self.cfg.model.ddpmconfig.channels
        return ddim_sample_unet(self.gd, self.unet, self.mixing_logit, (batch, c, r, r),
                                noise=noise, generator=generator, device=self.device)

    def render_camera_path(self, z1: torch.Tensor, poses: torch.Tensor, H: int,
                           W: int) -> torch.Tensor:
        """One scene: decode its planes, fold the MLP once, render every
        pose.  z1 (1, C, r, r) -> (views, H, W, 3) fp32."""
        planes = self.decode_planes(z1)
        folded = self.fold_mlp()
        return torch.stack([self.render_image(planes, pose, H, W, folded) for pose in poses])

    @torch.inference_mode()
    def sample_nerfs(self, batch: int, n_views: int = 8, H: int = 128, W: int = 128,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM latents -> decoded planes -> a rendered camera path per
        scene: (batch, n_views, H, W, 3) fp32 (not clipped)."""
        z = self.sample_latents(batch, noise=noise, generator=generator)
        poses = self.spherical_poses(n_views)
        return torch.stack([self.render_camera_path(z[b : b + 1], poses, H, W)
                            for b in range(batch)])
