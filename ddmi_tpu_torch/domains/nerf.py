"""NeRF domain (counterpart of ddmi_tpu/domains/nerf.py::NeRFPipeline):
sampling (DDIM over triplane latents with the 2D UNet, the triplane decode,
and a volume render of a spherical camera path through the NeRF MLP) and
both training stages (domains/triplane.py).

Rays, stratified samples, the triplane lookup (pts / 3.5,
align_corners=True, border), the frequency embeddings and the alpha
compositing stay fp32; the MLP input is cast to the MLP's compute dtype.
With no gradient recorded and wherever the kernel's predicate takes the
MLP's width (256) the MLP runs as `nerf_mlp_fused`: on the card the
hand-written kernel of csrc/nerf_mlp.cu, on the CPU its plain version;
other widths, any render under autograd and every training render run the
INRNeRF module, as the JAX package does, so training launches no kernel.
Sampling renders without perturbation and draws no random numbers.

Stage 1 (`stage1_loss`): the cloud (b, n, 6: xyz and rgb) through the
pointnet, the encoder and the sampled posteriors, packed [xy | xz | yz],
then the decode; per scene, N_rand rays of its one view, drawn without
replacement, rendered with perturbed stratified samples, and 20 x the sum
of |rgb - target| over them, averaged over the scenes; plus the KL and the
spectral-norm regulariser.  Under model.amp the VAE and the INRNeRF compute
in bf16.  The plane samples are blended in fp32 and rounded once to the
planes' dtype, where the JAX package blends the four corners in the planes'
bf16; the tests hold the amp loss to JAX's within 1e-2.  Stage 2 trains the
UNet on the frozen encode of the batch's `points`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ddmi_tpu_torch.core.amp import compute_cast, method_call
from ddmi_tpu_torch.core.convocc_config import (
    load_convocc_config, nerf_kwargs, pointnet_input_dim, pointnet_kwargs,
)
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, ddim_sample_unet
from ddmi_tpu_torch.domains.triplane import TriplaneDraws, TriplaneTraining
from ddmi_tpu_torch.nn.inr import FreqEmbedding, INRNeRF
from ddmi_tpu_torch.nn.pointnet import LocalPoolPointnet
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


class NeRFPipeline(TriplaneTraining, nn.Module):
    """The models of one NeRF config: `unet` + `mixing_logit` (1, C, 1, 1)
    (stage 2); `pointnet`, `vae` (encoder, posterior convs and decoder) and
    `mlp` (INRNeRF) (stage 1).  The pointnet's settings and the render's
    come from `data.conv_config` (its encoder_kwargs, data.dim and model.TN
    blocks), else from `model.pointnet` (a 6-wide cloud unless it says
    `dim`) and `mlpconfig` extras.  A batch is a dict: `points` (b, n, 6)
    the cloud, `image` (b, H, W, 3) one view in [0, 1] and `pose` (b, 4, 4)
    its camera (data/nerf.py).

    Parameters are initialised on `device` (the card unless the caller asks
    for the CPU) from `seed`; `load_state_dicts` replaces them with trained
    ones (reference state_dict layouts, see interop.py).  `cast(dtype)`
    casts every model parameter but `mixing_logit`, which stays fp32."""

    cloud_key = "points"

    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__()
        m = cfg.model
        if m.DiT:  # the JAX pipeline ignores the key and builds its UNet
            raise ValueError("model.DiT selects the MDTv2 denoiser of the image domain; the "
                             "NeRF pipeline denoises with its UNet")
        self.cfg = cfg
        dd = m.ddconfig
        if cfg.data.conv_config:
            conv_cfg = load_convocc_config(cfg.data.conv_config)
            tn = nerf_kwargs(conv_cfg)
            pn_kwargs = dict(pointnet_kwargs(conv_cfg), dim=pointnet_input_dim(conv_cfg))
        else:
            tn = {}
            enc = m.extra.get("pointnet", {})
            pn_kwargs = dict(c_dim=enc.get("c_dim", dd.in_channels),
                             hidden_dim=enc.get("hidden_dim", 256),
                             plane_resolution=enc.get("plane_resolution", dd.resolution),
                             n_blocks=enc.get("n_blocks", 7), dim=enc.get("dim", 6))
        mc = m.mlpconfig.extra
        multires = tn.get("multires", mc.get("multires", 10))
        multires_views = tn.get("multires_views", mc.get("multires_views", 4))
        self.embed_xyz = FreqEmbedding(multires)
        self.embed_dir = FreqEmbedding(multires_views)
        self.n_samples = int(tn.get("N_samples", mc.get("N_samples", 256)))
        self.n_rand = int(tn.get("N_rand", mc.get("N_rand", 5000)))
        self.perturb = float(tn.get("perturb", mc.get("perturb", 1.0)))
        self.white_bkgd = bool(tn.get("white_bkgd", mc.get("white_bkgd", True)))
        self.latent_res = dd.resolution // 2 ** (len(dd.ch_mult) - 1)
        self.amp = bool(m.amp)
        self.lc = m.lossconfig
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
                # the encode half last: a seed gives the sampling modules the
                # weights it gave them before the pipeline trained
                self.vae.add_encoder()
                self.pointnet = LocalPoolPointnet(**pn_kwargs)
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
        """Load port state_dicts (strict); `mixing_logit` has C values.  A
        `vae` state_dict of the decode half alone (the sampling checkpoints)
        leaves the encoder and the quant convs as they are."""
        if vae is not None and not any(k.startswith(("encoder.", "quant_conv")) for k in vae):
            vae = {**{k: v for k, v in self.vae.state_dict().items()
                      if k.startswith(("encoder.", "quant_conv"))}, **vae}
        for module, sd in ((self.unet, unet), (self.pointnet, pointnet), (self.vae, vae),
                           (self.mlp, mlp)):
            if sd is not None:
                module.load_state_dict(sd, strict=True)
        if mixing_logit is not None:
            with torch.no_grad():
                self.mixing_logit.copy_(torch.as_tensor(mixing_logit).reshape(
                    self.mixing_logit.shape))

    def cast(self, dtype: torch.dtype) -> "NeRFPipeline":
        """Cast the models' parameters; on CUDA also lay the UNet and the
        VAE out channels-last (the attention kernel's NHWC view)."""
        for module in (self.unet, self.pointnet, self.vae, self.mlp):
            module.to(dtype)
            if self.device.type == "cuda" and module in (self.unet, self.vae):
                module.to(memory_format=torch.channels_last)
        return self

    # ----------------------------------------------------------- render

    def fold_mlp(self) -> Optional[nerf_mlp.FoldedNeRF]:
        """The MLP in the kernel's layout, in the parameters' dtype, or None
        where the kernel does not take its width (JAX's predicate: 256, at
        any input width)."""
        m = self.mlp
        if not nerf_mlp.kernel_supported(m.width, m.in_channels_xyz, m.in_channels_dir):
            return None
        return nerf_mlp.fold_nerf_params(m, dtype=m.sigma.weight.dtype)

    def mlp_input(self, planes, rays_o, rays_d, uniforms=None, dtype=None):
        """-> (x (n, s, in_xyz + in_dir) in `dtype` (the MLP parameters' when
        None), z (n, s)): the triplane features and both embeddings at the
        ray samples, evenly spaced in [NEAR, FAR] or, given `uniforms` (n,
        s) in [0, 1), each drawn within its stratum between the midpoints."""
        n, s = rays_o.shape[0], self.n_samples
        t = torch.linspace(0.0, 1.0, s, device=rays_o.device)
        z = (NEAR * (1 - t) + FAR * t).expand(n, s)
        if uniforms is not None:
            mids = 0.5 * (z[..., 1:] + z[..., :-1])
            upper = torch.cat([mids, z[..., -1:]], -1)
            lower = torch.cat([z[..., :1], mids], -1)
            z = lower + (upper - lower) * uniforms
        pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        dtype = dtype or self.mlp.sigma.weight.dtype
        e_dir = self.embed_dir(viewdirs).to(dtype)[:, None].expand(n, s, -1)
        x = torch.cat([sample_triplane(planes, pts).to(dtype),
                       self.embed_xyz(pts).to(dtype), e_dir], -1)
        return x, z

    def run_mlp(self, x, folded=None, params=None) -> torch.Tensor:
        """x (..., in_xyz + in_dir) -> raw (..., 4) fp32.  With `params`
        (name -> tensor: training's casts of the masters) or under autograd
        (a gradient recorded for x or the MLP's parameters) through the
        INRNeRF module, whose gradients the fused MLP would drop: the fold
        copies the weights detached, as JAX's `_fused_mlp_gate` takes the
        kernel only in inference traces."""
        if params is not None:
            return method_call(self.mlp, params, "forward", x).float()
        if needs_grad(x, *self.mlp.parameters()):
            return self.mlp(x).float()
        if folded is None:
            folded = self.fold_mlp()
        if folded is None:
            return self.mlp(x).float()
        return nerf_mlp.nerf_mlp_fused(folded, x.reshape(-1, x.shape[-1])).reshape(
            *x.shape[:-1], 4)

    def render_rays(self, planes, rays_o, rays_d, folded=None, uniforms=None,
                    params=None) -> torch.Tensor:
        """rays_o / rays_d (n, 3) -> rgb (n, 3) fp32; `uniforms` perturb the
        samples (mlp_input) and `params` replace the MLP's (run_mlp)."""
        dtype = None if params is None else next(iter(params.values())).dtype
        x, z = self.mlp_input(planes, rays_o, rays_d, uniforms, dtype)
        raw = self.run_mlp(x, folded, params)
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

    def decode_planes(self, z: torch.Tensor, p_vae: Optional[dict] = None
                      ) -> Dict[str, torch.Tensor]:
        """z (b, 3 * embed_dim, r, r) -> {"xy", "yz", "xz"}: the first plane
        of each decoded pyramid (srn_cars has no HDBF taps, so each pyramid
        is the one decoded plane), NCHW, in the VAE's dtype (or in that of
        `p_vae`, which replaces its parameters)."""
        if p_vae is None:
            pyr_xy, pyr_yz, pyr_xz = self.vae.decode(z.to(self.vae_dtype))
        else:
            z = z.to(next(iter(p_vae.values())).dtype)
            pyr_xy, pyr_yz, pyr_xz = method_call(self.vae, p_vae, "decode", z)
        return {"xy": pyr_xy[0], "yz": pyr_yz[0], "xz": pyr_xz[0]}

    # ---------------------------------------------------------- stage 1

    def draw_stage1(self, batch, generator: Optional[torch.Generator] = None) -> TriplaneDraws:
        """One micro-step's draws from `generator`: the three posteriors'
        eps, then per scene N_rand of the view's H * W pixels without
        replacement (the first N_rand of a uniform random order) and, with
        perturbation on, the stratified samples' uniforms."""
        b, H, W = batch["image"].shape[:3]
        eps = self.posterior_eps(b, generator)
        keys = torch.rand((b, H * W), generator=generator, device=self.device)
        pixels = keys.argsort(dim=1)[:, : self.n_rand]
        uniforms = (torch.rand((b, self.n_rand, self.n_samples), generator=generator,
                               device=self.device) if self.perturb > 0 else None)
        return TriplaneDraws(eps, pixels, uniforms)

    def stage1_loss(self, batch, step: int, draws: TriplaneDraws, sn_state):
        """The stage-1 loss of a batch (dict of `points`, `image`, `pose`):
        encode and decode the planes, render each scene's drawn rays and take
        20 x the sum of |rgb - target| over them, averaged over the scenes,
        plus the KL (its coefficient reads the micro-step `step`) and the
        spectral-norm regulariser.  -> (loss, metrics, new sn state)."""
        image, pose = batch["image"].float(), batch["pose"].float()
        b, H, W = image.shape[:3]
        with record_function("stage1/encode"):
            p_vae = compute_cast(dict(self.vae.named_parameters()), self.amp)
            z, posts = self.encode(batch["points"], draws.eps, p_vae)
        with record_function("stage1/decode"):
            planes = self.decode_planes(z, p_vae)
        with record_function("stage1/render"):
            p_mlp = compute_cast(dict(self.mlp.named_parameters()), self.amp)
            terms = []
            for i in range(b):
                rays_o, rays_d = get_rays(H, W, pose[i])
                idx = draws.pixels[i].to(self.device)
                u = None if draws.uniforms is None else draws.uniforms[i].to(self.device)
                rgb = self.render_rays({k: v[i : i + 1] for k, v in planes.items()},
                                       rays_o.reshape(-1, 3)[idx], rays_d.reshape(-1, 3)[idx],
                                       uniforms=u, params=p_mlp)
                terms.append(20.0 * (rgb - image[i].reshape(-1, 3)[idx]).abs().sum())
            recon = torch.stack(terms).mean()
        kld, kl_coeff, sn, sn_weight, new_sn = self.regularisers(posts, step, sn_state)
        loss = recon + kl_coeff * kld
        if self.lc.sn_reg:
            loss = loss + sn * sn_weight
        metrics = {"loss": loss, "recon": recon, "kl": kld, "kl_coeff": kl_coeff, "sn": sn}
        return loss, metrics, new_sn

    # --------------------------------------------------------- sampling

    def sample_latents(self, batch: int, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM -> z (batch, C, r, r) fp32; `noise` (batch, C, r, r) is the
        initial latent, else it is drawn from `generator`."""
        return ddim_sample_unet(self.gd, self.unet, self.mixing_logit,
                                self.latent_noise_shape(batch), noise=noise,
                                generator=generator, device=self.device)

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
        return self.render_nerfs(self.sample_latents(batch, noise=noise, generator=generator),
                                 n_views, H, W)

    @torch.inference_mode()
    def render_nerfs(self, z: torch.Tensor, n_views: int = 8, H: int = 128,
                     W: int = 128) -> torch.Tensor:
        """Each scene of DDIM latents z rendered along the spherical camera
        path: (b, n_views, H, W, 3) fp32 (not clipped)."""
        poses = self.spherical_poses(n_views)
        return torch.stack([self.render_camera_path(z[b : b + 1], poses, H, W)
                            for b in range(z.shape[0])])
