"""Training shared by the two point-cloud domains, occupancy and NeRF
(counterpart of the stage-1 and stage-2 halves of
ddmi_tpu/domains/{occupancy,nerf}.py).

Both encode a point cloud with the pointnet into (xy, yz, xz) feature
planes, take the triplane VAE's three posteriors and sample them, packed
[xy | xz | yz] on the channel axis.  Stage 1 trains the pointnet, the VAE
and the INR together on the domain's reconstruction term plus the summed
KL of the three posteriors (annealed or constant) and the spectral-norm
regulariser of the VAE; stage 2 trains the UNet on the frozen encoder's
latents.  Under model.amp the VAE and the INR compute on bf16 casts of
their fp32 masters while the pointnet computes in fp32 (its cell indices
need exact coordinates); stage 2's frozen encode casts every stage-1
module, so the pointnet computes in fp32 on bf16-rounded weights (flax's
promotion), the VAE in bf16, and the latents return fp32.

Every draw is explicit (`TriplaneDraws`), so that a test can feed the JAX
package's own.  Each stage of a stage-1 micro-step runs in a profiler range
named `stage1/<stage>` (encode, decode, and the domain's inr or render,
sn, backward, optimizer).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from ddmi_tpu_torch.core.amp import method_call
from ddmi_tpu_torch.core.sn_reg import norm_scale_loss, spectral_norm_loss
from ddmi_tpu_torch.domains.image import (
    LatentTraining, Stage1State, stage1_kl_coeff, stage1_sn_weight,
)
from ddmi_tpu_torch.parallel.mesh import reduce_grads


@dataclasses.dataclass
class TriplaneDraws:
    """The random draws of one stage-1 micro-step: `eps` the three
    posteriors' standard-normal fp32 noise in plane order (xy, yz, xz),
    each (b, embed_dim, r, r); for NeRF, `pixels` (b, N_rand) the flat
    pixel indices of each scene's rays, drawn without replacement, and
    `uniforms` (b, N_rand, N_samples) the stratified samples' uniforms in
    [0, 1) (None: no perturbation)."""

    eps: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    pixels: Optional[torch.Tensor] = None
    uniforms: Optional[torch.Tensor] = None


class TriplaneTraining(LatentTraining):
    """LatentTraining for a pipeline with `pointnet`, a TriplaneAutoencoder
    `vae` with its encoder, and an INR `mlp`.  The pipeline brings
    `stage1_loss(batch, step, draws, sn_state) -> (loss, metrics, new sn
    state)`, `draw_stage1(batch, generator)` and `cloud_key`, the batch
    entry that holds the point cloud."""

    stage1_modules = ("pointnet", "vae", "mlp")
    stage2_bf16_modules = ("pointnet", "vae")
    stage1_warmup_only = False
    gan = None
    cloud_key = "inputs"

    @property
    def vae_dtype(self) -> torch.dtype:
        return self.vae.post_quant_conv_xy.weight.dtype

    def posterior_shapes(self, b: int):
        """The NCHW shapes of the (xy, yz, xz) posteriors."""
        e, r = self.cfg.model.embed_dim, self.latent_res
        return ((b, e, r, r),) * 3

    def posterior_eps(self, b: int, generator: Optional[torch.Generator] = None):
        """Standard-normal fp32 draws for the three posteriors, from
        `generator`, in plane order."""
        return tuple(torch.randn(s, generator=generator, device=self.device)
                     for s in self.posterior_shapes(b))

    stage2_eps = posterior_eps

    def latent_noise_shape(self, batch: int):
        """The shape of the DDIM's initial latent for a batch."""
        return (batch, self.cfg.model.ddpmconfig.channels, self.latent_res, self.latent_res)

    def stage2_z_shape(self, b: int):
        return (b, 3 * self.cfg.model.embed_dim, self.latent_res, self.latent_res)

    def encode(self, cloud: torch.Tensor, eps, p_vae: Optional[dict] = None):
        """The pointnet's feature planes, cast to the VAE's compute dtype,
        through the encoder and the posteriors sampled with `eps` (plane
        order); `p_vae` (name -> tensor) replaces the VAE's parameters, as
        training's amp casts do.  -> (z (b, 3 * embed_dim, r, r) packed
        [xy | xz | yz] in the VAE's compute dtype, the posteriors)."""
        fea = self.pointnet(cloud.to(self.device))
        dt = next(iter(p_vae.values())).dtype if p_vae is not None else self.vae_dtype
        planes = (fea["xy"].to(dt), fea["yz"].to(dt), fea["xz"].to(dt))
        posts = (self.vae.encode(planes) if p_vae is None
                 else method_call(self.vae, p_vae, "encode", planes))
        xy, yz, xz = (p.sample(e.to(self.device)) for p, e in zip(posts, eps))
        return torch.cat([xy, xz, yz], dim=1), posts

    @torch.no_grad()
    def encode_latents(self, cloud: torch.Tensor, eps=None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z = the channel-concat posterior samples [xy | xz | yz], fp32 (b,
        3 * embed_dim, r, r).  `eps` holds the three draws' standard-normal
        noise in plane order (xy, yz, xz), each (b, embed_dim, r, r); without
        it they are drawn from `generator`.  The pointnet's feature planes
        enter the encoder in the VAE's dtype."""
        if eps is None:
            eps = self.posterior_eps(cloud.shape[0], generator)
        return self.encode(cloud, eps)[0].float()

    def stage2_latents(self, batch, eps=None, generator: Optional[torch.Generator] = None):
        """The frozen encode of a stage-2 batch's point cloud."""
        return self.encode_latents(batch[self.cloud_key], eps, generator)

    def regularisers(self, posts, step: int, sn_state):
        """The stage-1 terms beside the reconstruction: the KL summed over
        the three posteriors (fp32, averaged over the batch) with its
        coefficient at micro-step `step`, and the spectral-norm regulariser
        of the VAE's fp32 masters with its weight.  -> (kl, kl_coeff, sn, sn
        weight, new sn state)."""
        lc = self.lc
        kld = sum(p.kl().float() for p in posts).mean()
        kl_coeff = stage1_kl_coeff(lc, self._stage1_total_iters, step)
        new_sn, sn = sn_state, torch.zeros((), device=self.device)
        if lc.sn_reg:
            with record_function("stage1/sn"):
                sn, new_sn = spectral_norm_loss(self.vae, sn_state)
                sn = sn + norm_scale_loss(self.vae)
        return kld, kl_coeff, sn, stage1_sn_weight(lc, kl_coeff), new_sn

    def stage1_train_step(self, state: Stage1State, batch,
                          generator: Optional[torch.Generator] = None,
                          host_generator: Optional[torch.Generator] = None,
                          draws: Optional[TriplaneDraws] = None):
        """One micro-step: the loss and its gradients, then the optimizer;
        the draws are `draws` or made by `draw_stage1` from `generator`
        (`host_generator`, the image domain's crop stream, has nothing to
        draw here).  Advances state.step.  -> (state, metrics of detached
        scalars)."""
        del host_generator
        if draws is None:
            draws = self.draw_stage1(batch, generator)
        loss, metrics, sn = self.stage1_loss(batch, state.step, draws, state.sn)
        with record_function("stage1/backward"):
            loss.backward()
        with record_function("stage1/optimizer"):
            params = list(state.params.values())
            reduce_grads(params)
            state.opt.update(params, [p.grad if p.grad is not None else torch.zeros_like(p)
                                      for p in params])
            for p in params:
                p.grad = None
        state.sn = sn
        state.step += 1
        return state, {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
