"""Video domain (counterpart of ddmi_tpu/domains/video.py::VideoPipeline):
sampling (DDIM over the [xy | xt | yt] latent tokens with the
TriplaneUNet, the triplane decode, the INR render one frame at a time),
stage-1 D2C-VAE training (TimeSformer encode -> three plane posteriors ->
decode -> the INR render of every frame, L1 over the clip, the summed
triplane KL, LPIPS on one drawn frame, the spectral-norm regulariser and,
for the adversarial configs, the 2D + 3D PatchGAN pair), reconstruction,
and stage-2 training (the frozen encoder's sampled tokens, the diffusion
loss through the TriplaneUNet, AdamW, EMA).

Clips are (b, t, h, w, 3) in [0, 1] at the pipeline's boundary.  Every
random draw of a micro-step is explicit (`VideoDraws`), so that a test can
feed the JAX package's own.  Each stage of a stage-1 micro-step runs in a
profiler range named `stage1/<stage>` (encode, decode, inr, lpips, sn,
backward, gan, optimizer), as in the image domain.  Under autograd the
render runs one frame at a time under a checkpoint (JAX:
lax.map(jax.checkpoint(render_frame))): at batch 2 a 256^2 frame is
131,072 tokens through the width-256 INR, and the whole clip's activations
would be 16 times that.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ddmi_tpu_torch.core.amp import compute_cast, method_call, rounded_cast
from ddmi_tpu_torch.core.coords import symmetrize, unsymmetrize
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.core.sn_reg import norm_scale_loss, spectral_norm_loss
from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, ddim_sample_unet
from ddmi_tpu_torch.domains.image import (
    LatentTraining, Stage1State, stage1_kl_coeff, stage1_sn_weight,
)
from ddmi_tpu_torch.losses.gan import GANLoss3D
from ddmi_tpu_torch.nn.inr import INRVideo
from ddmi_tpu_torch.nn.unet_triplane import TriplaneUNet
from ddmi_tpu_torch.nn.video_vae import VideoAutoencoder, cat_planes, is_encode_key
from ddmi_tpu_torch.ops.resample import pixel_center_lin
from ddmi_tpu_torch.parallel.mesh import reduce_grads


def video_axes(t: int, h: int, w: int, device=None):
    """Pixel-centre axes (ts, ys, xs), each [-(n-1)/n, (n-1)/n], as the
    reference passes them at train and eval time."""
    return tuple(pixel_center_lin(k, device=device) for k in (t, h, w))


@dataclasses.dataclass
class VideoDraws:
    """The random draws of one stage-1 micro-step: `eps` the three
    posteriors' standard-normal fp32 noise (xy (b, E, r, r), yt and xt (b,
    E, t, r)), `lpips_frame` (b,) the frame of each clip LPIPS compares,
    `gan_frame` (b,) the frame of each clip the 2D discriminator sees
    (adversarial configs)."""

    eps: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    lpips_frame: torch.Tensor
    gan_frame: Optional[torch.Tensor] = None


class VideoPipeline(LatentTraining, nn.Module):
    """The models of one video config: `unet` (TriplaneUNet) +
    `mixing_logit` (1, 1, C) (stage 2), `vae` (the whole VITAutoencoder) +
    `mlp` (INRVideo) (stage 1), and `gan` (GANLoss3D) for the adversarial
    stage-1 configs.

    Parameters are initialised on `device` (the card unless the caller asks
    for the CPU) from `seed`; `load_state_dicts` replaces them with trained
    ones (reference state_dict layouts, see interop.py).  `cast(dtype)`
    casts every model parameter but `mixing_logit`, which stays fp32.
    `perceptual` is the LPIPS of stage-1 training
    (evals/lpips.py::build_perceptual), or None to train without it."""

    stage1_warmup_only = False

    def __init__(self, cfg, device="cuda", seed: int = 0,
                 perceptual: Optional[nn.Module] = None):
        super().__init__()
        m = cfg.model
        if m.DiT:  # the JAX pipeline ignores the key and builds its UNet
            raise ValueError("model.DiT selects the MDTv2 denoiser of the image domain; the "
                             "video pipeline denoises with its UNet")
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
                self.vae = VideoAutoencoder(m.ddconfig, m.embed_dim, self.frames,
                                            with_encoder=True)
                self.mlp = INRVideo(m.mlpconfig)
                self.gan = (GANLoss3D(m.ddconfig.in_channels, disc_weight=m.lossconfig.disc_weight)
                            if m.lossconfig.adversarial else None)
        self.perceptual = perceptual
        self.amp = bool(m.amp)
        self.lc = m.lossconfig
        d = m.ddpmconfig
        self.mixing_logit = nn.Parameter(
            torch.full((1, 1, d.channels), float(d.mixed_init), device=device))
        self.gd = GaussianDiffusion.from_config(d).to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.mixing_logit.device

    def load_state_dicts(self, unet=None, vae=None, mlp=None, mixing_logit=None) -> None:
        """Load port state_dicts (strict); `mixing_logit` is (1, 1, C).  A
        `vae` state_dict of the decode half alone (the sampling checkpoints)
        leaves the encode half as it is."""
        if vae is not None and not any(map(is_encode_key, vae)):
            vae = {**{k: v for k, v in self.vae.state_dict().items() if is_encode_key(k)}, **vae}
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

    def sample_latents(self, batch: int, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM -> z (batch, n_latent_tokens, C) fp32, the DDIM of
        `sample_videos`; `noise` is the initial latent, else it is drawn
        from `generator`."""
        return ddim_sample_unet(self.gd, self.unet, self.mixing_logit,
                                self.latent_noise_shape(batch), noise=noise,
                                generator=generator, device=self.device)

    def latent_noise_shape(self, batch: int):
        """The shape of the DDIM's initial latent for a batch."""
        return (batch, self.n_latent_tokens, self.cfg.model.ddpmconfig.channels)

    @torch.inference_mode()
    def sample_videos(self, batch: int, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM + triplane decode + INR render -> (batch, frames, res, res,
        out_ch) in [0, 1], fp32.  `noise` (batch, n_latent_tokens, C) is the
        initial latent; without it the latent is drawn from `generator`."""
        return self.decode_videos(self.sample_latents(batch, noise, generator))

    @torch.inference_mode()
    def decode_videos(self, z: torch.Tensor) -> torch.Tensor:
        """Triplane decode + INR render of DDIM latents -> (b, frames, res,
        res, out_ch) in [0, 1], fp32."""
        batch = z.shape[0]
        hdbf = self.vae.decode(z.to(self.vae.post_xy.weight.dtype))
        # one frame at a time, as the JAX package's lax.map: the whole voxel
        # grid (16 x 256^2 tokens at batch 2) would hold every MLP
        # activation at once
        out = torch.stack([self.render(hdbf, f).float() for f in range(self.frames)], dim=1)
        vid = out.reshape(batch, self.frames, self.res, self.res, -1)
        return unsymmetrize(vid.clamp(-1.0, 1.0))

    # ------------------------------------------------------------ stage 1

    def posterior_shapes(self, b: int):
        """The NCHW shapes of the (xy, yt, xt) posteriors."""
        r, t, e = self.vae.down_res, self.vae.frames, self.cfg.model.embed_dim
        return (b, e, r, r), (b, e, t, r), (b, e, t, r)

    def stage2_eps(self, b: int, generator: Optional[torch.Generator] = None):
        """The three posteriors' eps as `encode_latents` draws them."""
        return [torch.randn(s, generator=generator, device=self.device)
                for s in self.posterior_shapes(b)]

    def stage2_z_shape(self, b: int):
        return (b, self.n_latent_tokens, self.cfg.model.embed_dim)

    def draw_stage1(self, b: int, generator: Optional[torch.Generator] = None) -> VideoDraws:
        """One micro-step's draws for a batch of b clips, from `generator`:
        the three posteriors' eps, the LPIPS frames and, for the adversarial
        configs, the GAN frames."""
        eps = tuple(torch.randn(s, generator=generator, device=self.device)
                    for s in self.posterior_shapes(b))
        frame = lambda: torch.randint(0, self.frames, (b,), generator=generator,
                                      device=self.device)
        return VideoDraws(eps, frame(), frame() if self.gan is not None else None)

    def _render(self, p_mlp, hdbf, grad: bool) -> torch.Tensor:
        """Every frame of the INR render -> (b, t, h * w, out_ch) fp32; one
        frame at a time, each under a checkpoint when `grad`."""
        ts, ys, xs = video_axes(self.frames, self.res, self.res, self.device)

        def frame(i):
            return method_call(self.mlp, p_mlp, "forward", hdbf, (ts[i : i + 1], ys, xs))

        outs = [(checkpoint(frame, i, use_reentrant=False) if grad else frame(i)).float()
                for i in range(self.frames)]
        return torch.stack(outs, dim=1)

    def stage1_loss(self, x: torch.Tensor, step: int, draws: VideoDraws, sn_state):
        """The stage-1 loss of clips x (b, t, h, w, 3) in [0, 1]: encode ->
        posterior samples -> [xy | xt | yt] -> decode -> the INR render of
        every frame, then the sum over (t, h, w, c) of |output - x|
        averaged over the batch, plus the annealed KL (summed over the three
        planes, averaged over the batch), LPIPS on the drawn frame of each
        clip and the spectral-norm regulariser on the fp32 masters.  Under
        model.amp the VAE computes on bf16 casts of its parameters with a
        bf16 input, and the INR in fp32 on the bf16 roundings of its
        parameters (flax promotes them against the fp32 coordinates); the
        output is fp32.  -> (loss, metrics, new sn state, (target,
        output))."""
        lc = self.lc
        x = symmetrize(x.float())
        b = x.shape[0]
        grad = torch.is_grad_enabled()
        with record_function("stage1/encode"):
            p_vae = compute_cast(dict(self.vae.named_parameters()), self.amp)
            # the INR computes in fp32 on bf16-rounded weights: JAX's fp32
            # coordinates promote its bf16 weights
            p_mlp = rounded_cast(dict(self.mlp.named_parameters()), self.amp)
            xin = x.to(torch.bfloat16) if self.amp else x
            posts = method_call(self.vae, p_vae, "encode", xin)
            xy, yt, xt = (p.sample(e) for p, e in zip(posts, draws.eps))
        with record_function("stage1/decode"):
            hdbf = method_call(self.vae, p_vae, "decode", cat_planes(xy, xt, yt))
        with record_function("stage1/inr"):
            output = self._render(p_mlp, hdbf, grad).reshape(x.shape[:4] + (-1,))

        recon = (output - x).abs().sum(dim=(1, 2, 3, 4)).mean()
        kld = sum(p.kl().float() for p in posts).mean()
        kl_coeff = stage1_kl_coeff(lc, self._stage1_total_iters, step)
        loss = recon + kl_coeff * kld
        p_loss = torch.zeros((), device=x.device)
        if self.perceptual is not None:
            with record_function("stage1/lpips"):
                rows = torch.arange(b, device=x.device)
                fi = draws.lpips_frame.to(x.device)
                p_loss = self.perceptual(x[rows, fi], output[rows, fi]).mean()
            loss = loss + lc.perceptual_weight * p_loss
        new_sn, sn = sn_state, torch.zeros((), device=x.device)
        if lc.sn_reg:
            with record_function("stage1/sn"):
                sn, new_sn = spectral_norm_loss(self.vae, sn_state)
                sn = sn + norm_scale_loss(self.vae)
            loss = loss + sn * stage1_sn_weight(lc, kl_coeff)
        metrics = {"loss": loss, "recon": recon, "kl": kld, "kl_coeff": kl_coeff,
                   "lpips": p_loss, "sn": sn}
        return loss, metrics, new_sn, (x, output)

    def stage1_train_step(self, state: Stage1State, x: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          host_generator: Optional[torch.Generator] = None,
                          draws: Optional[VideoDraws] = None):
        """One micro-step: the loss and its gradients, then the optimizer
        (and for the adversarial configs the discriminators' loss, gradient
        and optimizer, from the same forward); the draws are `draws` or
        made by `draw_stage1` from `generator` (`host_generator`, the image
        domain's crop stream, has nothing to draw here).  Advances
        state.step.  -> (state, metrics of detached scalars)."""
        del host_generator
        if draws is None:
            draws = self.draw_stage1(x.shape[0], generator)
        loss, metrics, sn, (target, output) = self.stage1_loss(x, state.step, draws, state.sn)
        if self.gan is None:
            with record_function("stage1/backward"):
                loss.backward()
        else:
            frames = draws.gan_frame.to(x.device)
            with record_function("stage1/gan"):
                # the generator's gradient with respect to the discriminators
                # is not taken (JAX discards it)
                self.gan.requires_grad_(False)
                g_gan = self.gan.generator_loss(target, output, frames)
            with record_function("stage1/backward"):
                (loss + g_gan).backward()
            with record_function("stage1/gan"):
                self.gan.requires_grad_(True)
                d_loss = self.gan.discriminator_loss(target, output, frames)
                d_loss.backward()
                disc = list(state.disc.values())
                reduce_grads(disc)
                state.disc_opt.update(disc, [p.grad for p in disc])
                for p in disc:
                    p.grad = None
            metrics = dict(metrics, g_gan=g_gan, d_loss=d_loss)
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

    def _vae_input(self, x: torch.Tensor):
        """Clips in [0, 1] -> the VAE's input in [-1, 1] and the VAE's
        parameters to compute with: bf16 casts under model.amp, else the
        parameters' own dtype."""
        dtype = torch.bfloat16 if self.amp else self.vae.post_xy.weight.dtype
        p_vae = {k: v.to(dtype) for k, v in self.vae.named_parameters()}
        return symmetrize(x.to(self.device).float()).to(dtype), p_vae

    @torch.no_grad()
    def reconstruct(self, x: torch.Tensor, eps=None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Clips x (b, t, h, w, 3) in [0, 1] -> encoded, sampled with `eps`
        (the three posteriors' draws, from `generator` when not given),
        decoded and rendered frame by frame -> (b, t, res, res, out_ch) in
        [0, 1], fp32.  Under model.amp the VAE computes on bf16 casts of its
        parameters (on the card the decoder's long attentions then take the
        flash kernel)."""
        xin, p_vae = self._vae_input(x)
        posts = method_call(self.vae, p_vae, "encode", xin)
        if eps is None:
            eps = [torch.randn(s, generator=generator, device=self.device)
                   for s in self.posterior_shapes(x.shape[0])]
        xy, yt, xt = (p.sample(e.to(self.device)) for p, e in zip(posts, eps))
        hdbf = method_call(self.vae, p_vae, "decode", cat_planes(xy, xt, yt))
        p_mlp = dict(self.mlp.named_parameters())
        out = self._render(p_mlp, hdbf, grad=False)
        vid = out.reshape(x.shape[0], self.frames, self.res, self.res, -1)
        return unsymmetrize(vid.clamp(-1.0, 1.0))

    # ------------------------------------------------------------ stage 2

    @torch.no_grad()
    def encode_latents(self, x, eps=None, generator: Optional[torch.Generator] = None):
        """The frozen stage-1 encode: clips (b, t, h, w, 3) in [0, 1] ->
        posteriors (bf16 under model.amp) sampled with `eps` (xy, yt, xt;
        drawn from `generator` in that order when not given) -> fp32 tokens
        [xy | xt | yt] (b, n, embed_dim)."""
        xin = symmetrize(x.to(self.device).float()).to(self.vae.post_xy.weight.dtype)
        posts = self.vae.encode(xin)
        if eps is None:
            eps = [torch.randn(p.mean.shape, generator=generator, device=self.device)
                   for p in posts]
        xy, yt, xt = (p.sample(e.to(self.device)) for p, e in zip(posts, eps))
        return cat_planes(xy, xt, yt).float()
