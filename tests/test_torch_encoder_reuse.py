"""Encoder-propagation ("turbo") sampling in the PyTorch port against the
JAX package: the UNet's and the TriplaneUNet's `cache=` / `return_cache=`
split, `ddim_sample_encoder_reuse`, and one sampling pipeline per domain
with `encoder_reuse` 2, on the same weights (converted by
ddmi_tpu_torch/interop.py) and the same initial noise.

Tolerances: the splits are exact (the reuse call on the cache just made
gives the full call's output bit for bit); reuse = 1 equals `ddim_sample`
bit for bit; at reuse 2 and 3 the port's latents lie within 1e-4 x
max(1, max|JAX|) of JAX's (fp32 on both sides, sums in other orders); the
pipelines within the bars their exact paths are held to
(tests/test_torch_slice.py, test_torch_occupancy.py): 1e-3 of a pixel in
[0, 1], and 1e-3 x max(1, max|JAX|) for latents.  The video pipeline is
held at its latents (`sample_latents`, the DDIM of `sample_videos`): its
decode and render do not depend on the sampler and
tests/test_torch_video.py holds them against JAX's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.interop import (
    mlp_image_from_jax,
    triplane_unet_from_jax,
    unet_from_jax,
    vae_from_jax,
)

torch.set_num_threads(2)

# NFE 5 leaves a tail at reuse 2 (5 = 2 x 2 + 1) and at reuse 3 (3 + 2); the
# video and 3D pipelines run NFE 4 (two groups), which costs JAX one
# compile fewer
NFE = 5
UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=[2],
            channel_mult=[1, 2], num_head_channels=16)
DDPM = dict(timesteps=20, sampling_timesteps=NFE, mixed_init=-6.0)
IMAGE = {
    "model": {"use_fp16": False, "embed_dim": 4, "params": {
        "unetconfig": dict(UNET, image_size=4, in_channels=4, out_channels=4),
        "ddconfig": dict(z_channels=8, resolution=16, out_ch=8, ch=32, ch_mult=[1, 1, 2],
                         num_res_blocks=1, hdbf_resolutions=[8, 4], attn_type="vanilla"),
        "mlpconfig": dict(ch=32, latent_dim=8),
        "ddpmconfig": dict(DDPM, image_size=4, channels=4)}},
    "data": {"domain": "image", "test_resolution": 16},
}
VIDEO = {
    "model": {"use_fp16": False, "embed_dim": 8, "params": {
        "unetconfig": dict(UNET, in_channels=8, out_channels=8),
        "ddconfig": dict(double_z=True, timesformer_channels=64, patch_size=8, splits=1,
                         resolution=32, z_channels=32, in_channels=3, out_ch=8, ch=32,
                         ch_mult=[1, 1, 2], num_res_blocks=1, attn_resolutions=[],
                         hdbf_resolutions=[8, 16], inter_attn_resolutions=[4, 16, 32],
                         attn_type="vanilla-multihead"),
        "mlpconfig": dict(in_ch=3, out_ch=3, ch=32, latent_dim=8),
        "ddpmconfig": dict(DDPM, channels=8, sampling_timesteps=4)}},
    "data": {"domain": "video", "frames": 4},
}
THREED = dict(use_fp16=False, embed_dim=8, params={
    "unetconfig": dict(UNET, image_size=8, in_channels=24, out_channels=24),
    "ddpmconfig": dict(DDPM, image_size=8, channels=24, sampling_timesteps=4)})
OCC = {"model": {**THREED, "pointnet": {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 32,
                                        "n_blocks": 2},
                 "params": {**THREED["params"],
                            "ddconfig": dict(double_z=True, z_channels=32, resolution=32,
                                             in_channels=8, out_ch=8, ch=32, ch_mult=[1, 2, 4],
                                             num_res_blocks=1, attn_resolutions=[],
                                             hdbf_resolutions=[8, 16],
                                             inter_attn_resolutions=[32, 16]),
                            "mlpconfig": dict(in_ch=3, out_ch=1, ch=32, latent_dim=8)}},
       "data": {"domain": "occupancy"}}
NERF = {"model": {**THREED, "pointnet": {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 16,
                                         "n_blocks": 2},
                  "params": {**THREED["params"],
                             "ddconfig": dict(double_z=True, z_channels=32, resolution=16,
                                              in_channels=8, out_ch=8, ch=32, ch_mult=[1, 2],
                                              num_res_blocks=1, attn_resolutions=[],
                                              hdbf_resolutions=[], inter_attn_resolutions=[16]),
                             "mlpconfig": dict(in_ch=3, out_ch=4, ch=32, latent_dim=8, D=2, W=32,
                                               skips=[1], multires=4, multires_views=2,
                                               N_samples=8)}},
        "data": {"domain": "nerf"}}


def _reuse(cfg, k):
    cfg = copy.deepcopy(cfg)
    cfg["model"]["params"]["ddpmconfig"]["encoder_reuse"] = k
    return cfg


def _random_tree(init_fn, seed, zero=("noise",)):
    """Seeded random parameters of the shapes init_fn() makes, without
    running the init (jax.eval_shape): kernels N(0, 1 / fan_in), the rest
    N(0, 0.05^2) about 0 (norm scales about 1); leaves under a `zero` key
    stay 0 (the INR's NoiseInjection: JAX and the port draw its noise from
    other generators)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [str(getattr(p, "key", p)) for p in path]
        if any(k in zero for k in keys):
            return np.zeros(s.shape, np.float32)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if keys[-1] == "kernel":
            return x / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))
        return (1.0 if keys[-1] == "scale" else 0.0) + 0.05 * x

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _unet_params(jpipe, x_shape, seed):
    k = jax.random.PRNGKey(0)
    return _random_tree(lambda: jpipe.unet.init(k, jnp.zeros(x_shape),
                                                jnp.zeros((1,), jnp.int32))["params"], seed)


@pytest.fixture(scope="module")
def image():
    """The JAX image pipeline and random parameters, and the port's
    state_dicts of them."""
    from ddmi_tpu.domains.image import ImagePipeline

    jcfg = jax_config(IMAGE)
    jpipe = ImagePipeline(jcfg)
    s1 = _random_tree(lambda: jpipe.init_stage1_params(jax.random.PRNGKey(0)), 1)
    s2 = {"unet": _unet_params(jpipe, (1, 4, 4, 4), 2),
          "mixing_logit": np.random.default_rng(3).standard_normal((1, 1, 1, 4))
          .astype(np.float32)}
    m = jcfg.model
    sds = {"unet": unet_from_jax(s2["unet"], m.unetconfig),
           "vae": vae_from_jax(s1["vae"], m.ddconfig),
           "mlp": mlp_image_from_jax(s1["mlp"], m.mlpconfig),
           "mixing_logit": _nchw(s2["mixing_logit"])}
    return jpipe, s1, s2, sds


@pytest.fixture(scope="module")
def jax_reuse(image):
    """JAX's ddim_sample_encoder_reuse latents on the image UNet at a
    reuse, from the initial noise NOISE (made once per reuse)."""
    from ddmi_tpu.diffusion.process import ddim_sample_encoder_reuse as jax_reuse

    jpipe, _, s2, _ = image
    p, made = s2["unet"], {}

    def latents(reuse):
        if reuse not in made:
            made[reuse] = np.asarray(jax_reuse(
                jpipe.gd, lambda x, t: jpipe.unet.apply({"params": p}, x, t, return_cache=True),
                lambda x, t, c: jpipe.unet.apply({"params": p}, x, t, cache=c),
                jnp.asarray(s2["mixing_logit"]), NOISE.shape, jax.random.PRNGKey(0), reuse,
                noise=jnp.asarray(NOISE)))
        return made[reuse]

    return latents


NOISE = np.random.default_rng(4).standard_normal((2, 4, 4, 4)).astype(np.float32)


def _port(cls, cfg, sds):
    pipe = cls(config_from_dict(cfg), device="cpu")
    pipe.load_state_dicts(**sds)
    return pipe


def _image_port(cfg, sds):
    from ddmi_tpu_torch.domains.image import ImagePipeline

    return _port(ImagePipeline, cfg, sds)


def _triplane_unet():
    from ddmi_tpu_torch.core.config import UNetConfig
    from ddmi_tpu_torch.nn.unet_triplane import TriplaneUNet

    u = {k: tuple(v) if isinstance(v, list) else v for k, v in UNET.items()}
    torch.manual_seed(0)
    return TriplaneUNet(UNetConfig(**u, in_channels=8, out_channels=8,
                                   plane_sizes=((4, 4), (4, 4), (4, 4))))


@pytest.mark.parametrize("kind", ["unet", "triplane"])
def test_unet_split_is_exact(image, kind):
    """The full forward with return_cache gives the plain forward's output,
    and the reuse call on the cache just made gives it again, bit for bit."""
    if kind == "unet":
        net = _image_port(IMAGE, image[3]).unet
        x = torch.randn(2, 4, 4, 4, generator=torch.Generator().manual_seed(1))
    else:
        net = _triplane_unet()
        with torch.no_grad():  # the zero-initialised output layers carry weight
            for p in net.parameters():
                if not p.any():
                    p.normal_(0.0, 0.05)
        x = torch.randn(2, 48, 8, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([7, 3])
    with torch.inference_mode():
        plain = net(x, t)
        full, cache = net(x, t, return_cache=True)
        reused = net(x, t, cache=cache)
        again = net(x, torch.tensor([12, 0]), cache=cache)
    assert float(plain.abs().max()) > 0
    assert torch.equal(full, plain) and torch.equal(reused, plain)
    assert not torch.equal(again, plain)  # the reuse path reads the timestep


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_reuse_one_is_ddim_sample(image, eta):
    """reuse = 1 gives ddim_sample's latents bit for bit (with eta > 0 the
    step draws come from the same generator in the same order); reuse < 1
    raises."""
    import dataclasses

    from ddmi_tpu_torch.diffusion.process import ddim_sample, ddim_sample_encoder_reuse

    pipe = _image_port(IMAGE, image[3])
    gd = dataclasses.replace(pipe.gd, ddim_sampling_eta=eta)
    noise = torch.randn(2, 4, 4, 4, generator=torch.Generator().manual_seed(2))
    full = lambda x, t: pipe.unet(x, t, return_cache=True)
    reuse = lambda x, t, c: pipe.unet(x, t, cache=c)
    want = ddim_sample(gd, pipe.unet, pipe.mixing_logit, noise.shape, noise=noise,
                       generator=torch.Generator().manual_seed(3))
    got = ddim_sample_encoder_reuse(gd, full, reuse, pipe.mixing_logit, noise.shape, 1,
                                    noise=noise, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, want)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="reuse must be >= 1"):
            ddim_sample_encoder_reuse(gd, full, reuse, pipe.mixing_logit, noise.shape, bad,
                                      noise=noise)


@pytest.mark.parametrize("reuse", [2, 3])
def test_encoder_reuse_matches_jax(image, jax_reuse, reuse):
    """ddim_sample_encoder_reuse at NFE 5 (a tail of full steps after the
    groups) against JAX's on the same UNet and noise, within 1e-4; and it
    departs from the exact sampler."""
    from ddmi_tpu_torch.diffusion.process import ddim_sample, ddim_sample_encoder_reuse

    pipe = _image_port(IMAGE, image[3])
    noise = NOISE
    ref = jax_reuse(reuse)
    got = ddim_sample_encoder_reuse(pipe.gd, lambda x, t: pipe.unet(x, t, return_cache=True),
                                    lambda x, t, c: pipe.unet(x, t, cache=c),
                                    pipe.mixing_logit, (2, 4, 4, 4), reuse, noise=_nchw(noise))
    _close(_nhwc(got), ref, 1e-4, f"reuse {reuse}")
    exact = ddim_sample(pipe.gd, pipe.unet, pipe.mixing_logit, (2, 4, 4, 4), noise=_nchw(noise))
    assert float((got - exact).abs().max()) > 1e-3


def _decoded(pipe):
    """Record the latents pipe.vae.decode receives."""
    seen, decode = [], pipe.vae.decode
    pipe.vae.decode = lambda z: seen.append(z.clone()) or decode(z)
    return seen


def test_image_pipeline_turbo_matches_jax(image, jax_reuse):
    """sample_images with encoder_reuse 2: its pixels against JAX's, and
    the latents it decodes against JAX's encoder-reuse DDIM on the same
    noise (the render flattens the difference turbo makes, the latents
    keep it)."""
    jpipe, s1, s2, sds = image
    noise = NOISE
    jpipe.cfg.model.ddpmconfig.extra["encoder_reuse"] = 2
    try:
        ref = np.asarray(jpipe.sample_images(s2, s1, jax.random.PRNGKey(2), batch=2,
                                             resolution=16, noise=jnp.asarray(noise)))
    finally:
        jpipe.cfg.model.ddpmconfig.extra.pop("encoder_reuse")
    z_ref = jax_reuse(2)
    pipe = _image_port(_reuse(IMAGE, 2), sds)
    z = _decoded(pipe)
    got = pipe.sample_images(2, 16, noise=_nchw(noise)).numpy()
    assert float(ref.std()) > 1e-2
    _close(got, ref, 1e-3, "turbo pixels")
    _close(_nhwc(z[0]), z_ref, 1e-3, "turbo latents")
    exact = _image_port(IMAGE, sds)
    z_exact = _decoded(exact)
    exact.sample_images(2, 16, noise=_nchw(noise))
    assert float((z[0] - z_exact[0]).abs().max()) > 1e-3  # turbo changed the samples


def test_video_pipeline_turbo_matches_jax():
    """VideoPipeline.sample_latents (the TriplaneUNet through the cache
    split) against the DDIM call of JAX's VideoPipeline.sample_videos."""
    from ddmi_tpu.diffusion.process import ddim_sample_unet as jax_ddim_unet
    from ddmi_tpu.domains.video import VideoPipeline as JaxPipe
    from ddmi_tpu_torch.domains.video import VideoPipeline

    jcfg = jax_config(_reuse(VIDEO, 2))
    jpipe = JaxPipe(jcfg)
    n = jpipe.n_latent_tokens
    s2 = {"unet": _unet_params(jpipe, (1, n, 8), 6),
          "mixing_logit": np.random.default_rng(7).standard_normal((1, 1, 8)).astype(np.float32)}
    noise = np.random.default_rng(8).standard_normal((2, n, 8)).astype(np.float32)
    # the call sample_videos makes, with the reuse it reads from the config
    ref = jax_ddim_unet(jpipe.gd, jpipe.unet, s2["unet"], s2["mixing_logit"], noise.shape,
                        jax.random.PRNGKey(0), noise=jnp.asarray(noise),
                        encoder_reuse=int(jcfg.model.ddpmconfig.extra["encoder_reuse"]))
    sds = {"unet": triplane_unet_from_jax(s2["unet"], jpipe.unet.cfg),
           "mixing_logit": torch.from_numpy(s2["mixing_logit"])}
    pipe = _port(VideoPipeline, _reuse(VIDEO, 2), sds)
    assert pipe.n_latent_tokens == n
    got = pipe.sample_latents(2, noise=torch.from_numpy(noise))
    _close(got.numpy(), ref, 1e-3, "video turbo latents")
    exact = _port(VideoPipeline, VIDEO, sds).sample_latents(2, noise=torch.from_numpy(noise))
    assert float((got - exact).abs().max()) > 1e-3


@pytest.mark.parametrize("domain", ["occupancy", "nerf"])
def test_3d_pipeline_turbo_matches_jax(domain):
    """OccupancyPipeline / NeRFPipeline.sample_latents with encoder_reuse 2
    against the JAX pipeline's."""
    if domain == "occupancy":
        from ddmi_tpu.domains.occupancy import OccupancyPipeline as JaxPipe
        from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline as Pipe
        cfg = OCC
    else:
        from ddmi_tpu.domains.nerf import NeRFPipeline as JaxPipe
        from ddmi_tpu_torch.domains.nerf import NeRFPipeline as Pipe
        cfg = NERF
    jpipe = JaxPipe(jax_config(_reuse(cfg, 2)))
    s2 = {"unet": _unet_params(jpipe, (1, 8, 8, 24), 9),
          "mixing_logit": np.random.default_rng(10).standard_normal((1, 1, 1, 24))
          .astype(np.float32)}
    noise = np.random.default_rng(11).standard_normal((2, 8, 8, 24)).astype(np.float32)
    ref = jpipe.sample_latents(s2, jax.random.PRNGKey(0), 2, noise=jnp.asarray(noise))
    sds = {"unet": unet_from_jax(s2["unet"], jpipe.cfg.model.unetconfig),
           "mixing_logit": torch.from_numpy(s2["mixing_logit"])}
    got = _port(Pipe, _reuse(cfg, 2), sds).sample_latents(2, noise=_nchw(noise))
    _close(_nhwc(got), ref, 1e-3, f"{domain} turbo latents")
    exact = _port(Pipe, cfg, sds).sample_latents(2, noise=_nchw(noise))
    assert float((got - exact).abs().max()) > 1e-3
