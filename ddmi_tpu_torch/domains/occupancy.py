"""3D occupancy domain (counterpart of
ddmi_tpu/domains/occupancy.py::OccupancyPipeline): sampling
(`sample_latents`, `decode_pyramids`, `logits_from_pyramids`,
`decode_logits_fn`), reconstruction (`encode_latents`,
`occupancy_logits`), and both training stages (domains/triplane.py).

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

Stage 1 (`stage1_loss`): the cloud through the pointnet (fp32), the
encoder and the sampled posteriors, the decode and INR3D at the 2048 query
points, then the binary cross-entropy of the fp32 logits against the
occupancies, summed over the points and averaged over the batch, plus the
annealed KL and the spectral-norm regulariser.  Under model.amp the VAE
computes in bf16 and INR3D in fp32 on its bf16 weights and fp32 points.
Stage 2 trains the UNet on the frozen encode of the batch's `inputs`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ddmi_tpu_torch.core.convocc_config import (
    encoder_name,
    generation_kwargs,
    load_convocc_config,
    pointnet_kwargs,
    voxel_encoder_kwargs,
)
from ddmi_tpu_torch.core.amp import compute_cast, method_call
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, ddim_sample_unet
from ddmi_tpu_torch.domains.triplane import TriplaneDraws, TriplaneTraining
from ddmi_tpu_torch.geometry.generation import generate_meshes_batched, refine_mesh
from ddmi_tpu_torch.nn.inr import INR3D
from ddmi_tpu_torch.nn.pointnet import LocalPoolPointnet, LocalVoxelEncoder
from ddmi_tpu_torch.nn.triplane_vae import TriplaneAutoencoder
from ddmi_tpu_torch.nn.unet import UNet


class OccupancyPipeline(TriplaneTraining, nn.Module):
    """The models of one occupancy config: `unet` + `mixing_logit` (1, C, 1,
    1) (stage 2); `pointnet`, `vae` (encoder, posterior convs and decoder)
    and `mlp` (INR3D) (stage 1).  A batch is a dict: `inputs` (b, n, 3)
    the surface cloud, `points` (b, m, 3) the query points and `occ` (b,
    m) their occupancies (data/shapenet.py).  The encoder's and the mesh
    extraction's settings come from `data.conv_config` (configs/convocc/
    pointcloud/shapenet_3plane.yaml, read from the working directory as the
    JAX package reads it; its `voxel_simple_local` encoder is
    LocalVoxelEncoder), else the pointnet's from `model.pointnet` and the
    extraction keeps its defaults.

    Parameters are initialised on `device` (the card unless the caller asks
    for the CPU) from `seed`; `load_state_dicts` replaces them with trained
    ones (reference state_dict layouts, see interop.py).  `cast(dtype)`
    casts every model parameter but `mixing_logit`, which stays fp32."""

    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__()
        m = cfg.model
        if m.DiT:  # the JAX pipeline ignores the key and builds its UNet
            raise ValueError("model.DiT selects the MDTv2 denoiser of the image domain; the "
                             "occupancy pipeline denoises with its UNet")
        self.cfg = cfg
        dd = m.ddconfig
        self.generation_kwargs = generation_kwargs({})
        encoder = LocalPoolPointnet
        if cfg.data.conv_config:
            conv_cfg = load_convocc_config(cfg.data.conv_config)
            if encoder_name(conv_cfg) == "voxel_simple_local":
                encoder, pn_kwargs = LocalVoxelEncoder, voxel_encoder_kwargs(conv_cfg)
            else:
                pn_kwargs = pointnet_kwargs(conv_cfg)
            self.generation_kwargs = generation_kwargs(conv_cfg)
        else:
            enc = m.extra.get("pointnet", {})
            pn_kwargs = dict(c_dim=enc.get("c_dim", dd.in_channels),
                             hidden_dim=enc.get("hidden_dim", 256),
                             plane_resolution=enc.get("plane_resolution", dd.resolution),
                             n_blocks=enc.get("n_blocks", 7))
        self.latent_res = dd.resolution // 2 ** (len(dd.ch_mult) - 1)
        self.amp = bool(m.amp)
        self.lc = m.lossconfig
        device = resolve_device(device)
        cuda = [device.index or 0] if device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda, device_type="cuda"):
            torch.manual_seed(seed)
            with device:
                self.unet = UNet(m.unetconfig)
                self.pointnet = encoder(**pn_kwargs)
                self.vae = TriplaneAutoencoder(dd, embed_dim=m.embed_dim, with_encoder=True)
                # its plane features are the decoder's out_ch wide (flax
                # infers the width from its input; the repo configs set
                # latent_dim to the same)
                self.mlp = INR3D(dataclasses.replace(m.mlpconfig, latent_dim=dd.out_ch))
        d = m.ddpmconfig
        self.mixing_logit = nn.Parameter(
            torch.full((1, d.channels, 1, 1), float(d.mixed_init), device=device))
        self.gd = GaussianDiffusion.from_config(d).to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.mixing_logit.device

    def init_stage1(self, steps_per_epoch: int = 1000):
        """See LatentTraining.init_stage1.  With the voxel encoder
        (`voxel_simple_local`) it raises ValueError, where the JAX
        pipeline's init_stage1 fails too: it initialises the encoder on a
        (1, 64, 3) point cloud, which LocalVoxelEncoder cannot take."""
        if isinstance(self.pointnet, LocalVoxelEncoder):
            raise ValueError("the occupancy pipeline trains its encoder on point clouds "
                             "(b, n, 3); voxel_simple_local takes voxel grids (b, r, r, r)")
        return super().init_stage1(steps_per_epoch)

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

    # ------------------------------------------------------------ stage 1

    def draw_stage1(self, batch, generator: Optional[torch.Generator] = None) -> TriplaneDraws:
        """One micro-step's draws: the three posteriors' eps."""
        return TriplaneDraws(self.posterior_eps(batch["inputs"].shape[0], generator))

    def stage1_loss(self, batch, step: int, draws: TriplaneDraws, sn_state):
        """The stage-1 loss of a batch (dict of `inputs`, `points`, `occ`):
        the binary cross-entropy of INR3D's fp32 logits at the query points,
        summed over the points and averaged over the batch, plus the KL
        (its coefficient reads the micro-step `step`) and the spectral-norm
        regulariser.  -> (loss, metrics, new sn state)."""
        with record_function("stage1/encode"):
            p_vae = compute_cast(dict(self.vae.named_parameters()), self.amp)
            z, posts = self.encode(batch["inputs"], draws.eps, p_vae)
        with record_function("stage1/decode"):
            pyramids = method_call(self.vae, p_vae, "decode", z)
        with record_function("stage1/inr"):
            p_mlp = compute_cast(dict(self.mlp.named_parameters()), self.amp)
            logits = method_call(self.mlp, p_mlp, "forward", batch["points"], pyramids).float()
        bce = F.binary_cross_entropy_with_logits(
            logits, batch["occ"].float(), reduction="none").sum(-1).mean()
        kld, kl_coeff, sn, sn_weight, new_sn = self.regularisers(posts, step, sn_state)
        loss = bce + kl_coeff * kld
        if self.lc.sn_reg:
            loss = loss + sn * sn_weight
        metrics = {"loss": loss, "bce": bce, "kl": kld, "kl_coeff": kl_coeff, "sn": sn}
        return loss, metrics, new_sn

    @torch.no_grad()
    def occupancy_logits(self, cloud: torch.Tensor, query_points: torch.Tensor,
                         eps: Sequence[torch.Tensor]) -> torch.Tensor:
        """Encode a point cloud (a posterior draw per plane from `eps`),
        decode it and evaluate the logits at query_points (b, n, 3) (the
        stage-1 eval hook's IoU)."""
        pyramids = self.decode_pyramids(self.encode_latents(cloud, eps))
        return self.mlp(query_points.to(self.device), pyramids)

    # ------------------------------------------------------------ stage 2

    def sample_latents(self, batch: int, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM -> z (batch, C, r, r) fp32; `noise` (batch, C, r, r) is the
        initial latent, else it is drawn from `generator`."""
        return ddim_sample_unet(self.gd, self.unet, self.mixing_logit,
                                self.latent_noise_shape(batch), noise=noise,
                                generator=generator, device=self.device)

    @torch.no_grad()
    def decode_pyramids(self, z: torch.Tensor):
        """z (b, 3 * embed_dim, r, r) -> the (xy, yz, xz) HDBF pyramids, each
        a list of NCHW planes coarse to fine (not inference tensors:
        refinement differentiates the logits through them).  The decode
        runs in the promotion of z's and the VAE's dtypes, as flax promotes:
        fp32 latents on bf16 parameters decode in fp32 on the bf16-valued
        weights (the decode's own, upcast for the call), as the JAX
        occupancy service decodes its fp32 DDIM latents."""
        z = z.to(self.device)
        dt = torch.promote_types(z.dtype, self.vae_dtype)
        if dt == self.vae_dtype:
            return self.vae.decode(z)
        params = {k: v.to(dt) for k, v in self.vae.named_parameters()
                  if k.startswith(("post_quant_conv", "decoder."))}
        return method_call(self.vae, params, "decode", z.to(dt))

    def logits_from_pyramids(self, points: torch.Tensor, pyramids) -> torch.Tensor:
        """Occupancy logits at points (b, n, 3) given decoded pyramids
        (differentiable in points)."""
        return self.mlp(points, pyramids)

    def decode_logits_fn(self, z: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
        """fn(points (b, n, 3)) -> logits, on the pyramids decoded once from
        z."""
        pyramids = self.decode_pyramids(z)
        return lambda points: self.logits_from_pyramids(points, pyramids)

    def extract_meshes(self, z: torch.Tensor, count: Optional[int] = None,
                       **mesh_kwargs) -> List:
        """Latents z (g, C, r, r) -> [(verts, faces)] of the first `count`
        (all when None): the pyramids decoded once, then every mesh
        extracted in lockstep, one INR3D call per round for the group
        (geometry/generation.py::generate_meshes_batched); the slots past
        `count` are padding and get no octree.  `mesh_kwargs` (threshold,
        resolution0, upsampling_steps, simplify_nfaces, refinement_step,
        points_batch_size, workers, ...) default to `generation_kwargs`.
        With refinement_step > 0 each mesh is refined on its own pyramids,
        its Dirichlet draws from a generator seeded 0, as the JAX package
        keys every mesh's refinement with PRNGKey(0)."""
        g = z.shape[0]
        count = g if count is None else count
        mk = {**self.generation_kwargs, **mesh_kwargs}
        steps = int(mk.pop("refinement_step", 0) or 0)
        pyr = self.decode_pyramids(z)

        def eval_group(pts: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                logits = self.logits_from_pyramids(torch.from_numpy(pts).to(self.device), pyr)
            return logits.float().cpu().numpy()

        meshes = generate_meshes_batched(eval_group, g, active=[i < count for i in range(g)],
                                         **mk)[:count]
        for i, (verts, tris) in enumerate(meshes):
            if steps > 0 and len(tris):
                pyr_i = tuple([p[i : i + 1] for p in levels] for levels in pyr)
                gen = torch.Generator(device=self.device).manual_seed(0)
                verts = refine_mesh(
                    verts, tris, lambda p, pyr_i=pyr_i: self.logits_from_pyramids(p, pyr_i),
                    threshold=mk.get("threshold", 0.2), steps=steps, generator=gen,
                    device=self.device)
                meshes[i] = (verts, tris)
        return meshes
