"""The UNet's variants and the samplers of the PyTorch port against the
JAX package on the CPU, in fp32: the SpatialTransformer
(nn/transformer.py), the scale-shift, class-conditional and
spatial-transformer UNets (nn/unet.py) with the JAX UNet's three
ValueErrors, classifier-free-guided DDIM, the ancestral `p_sample_loop`
on JAX's step draws (T = 20), `sample`'s dispatch, and the config
loader's new keys.  JAX parameters are `jax.eval_shape` shapes filled
with seeded normal draws (zero-init outputs included), carried across by
`interop.unet_from_jax`.  Each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import UNetConfig as JaxUNetConfig
from ddmi_tpu.diffusion import process as jproc
from ddmi_tpu.diffusion.schedule import make_schedule as jax_schedule
from ddmi_tpu.nn.unet import UNet as JaxUNet
from ddmi_tpu_torch.core.config import UNetConfig
from ddmi_tpu_torch.diffusion import process
from ddmi_tpu_torch.diffusion.schedule import make_schedule
from ddmi_tpu_torch.interop import unet_from_jax
from ddmi_tpu_torch.nn.unet import UNet

torch.set_num_threads(2)

UNET = dict(image_size=8, in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=16)
VARIANTS = {
    "scale_shift": dict(use_scale_shift_norm=True),
    "labels": dict(num_classes=7),
    "transformer": dict(use_spatial_transformer=True, context_dim=12, transformer_depth=2),
}
B, CTX = 2, (5, 12)


def fill(shapes, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _kwargs(variant, y, ctx, xp=jnp):
    kw = {}
    if variant == "labels":
        kw["y"] = xp.asarray(y)
    if variant == "transformer":
        kw["cond"] = xp.asarray(ctx)
    return kw


@pytest.fixture(scope="module")
def unets():
    """Each variant: the JAX UNet, its filled parameters and the port's
    UNet on them."""
    out = {}
    y, ctx = np.array([1, 5]), np.zeros((B,) + CTX, np.float32)
    for i, (name, extra) in enumerate(VARIANTS.items()):
        jcfg = JaxUNetConfig(**UNET, **extra)
        ju = JaxUNet(jcfg)
        init = lambda k: ju.init(k, jnp.zeros((B, 8, 8, 4)), jnp.zeros((B,), jnp.int32),
                                 **_kwargs(name, y, ctx))
        params = fill(jax.eval_shape(init, jax.random.PRNGKey(0))["params"], i)
        cfg = UNetConfig(**UNET, **extra)
        port = UNet(cfg)
        port.load_state_dict(unet_from_jax(params, cfg))
        out[name] = (ju, params, port)
    return out


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((B,) + CTX).astype(np.float32)
    return x, np.array([3, 15]), np.array([1, 5]), ctx


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_spatial_transformer_matches_jax():
    """SpatialTransformer (depth 2) with a context and with none (attn2
    then attends to the tokens): within 1e-5 of max |JAX|."""
    from ddmi_tpu.nn.transformer import SpatialTransformer as JaxST
    from ddmi_tpu_torch.interop import _spatial_transformer
    from ddmi_tpu_torch.nn.transformer import SpatialTransformer

    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 4, 4, 64)).astype(np.float32)
    for context_dim in (12, None):
        ctx = rng.standard_normal((B, 5, 12)).astype(np.float32) if context_dim else None
        jst = JaxST(64, 4, 16, depth=2, context_dim=context_dim)
        p = fill(jax.eval_shape(lambda k: jst.init(k, jnp.asarray(x), ctx),
                                jax.random.PRNGKey(0))["params"], 1)
        ref = np.asarray(jst.apply({"params": p}, jnp.asarray(x), ctx))
        st = SpatialTransformer(64, 4, 16, depth=2, context_dim=context_dim)
        sd = {}
        _spatial_transformer(sd, "st", p, 2)
        st.load_state_dict({k[3:]: v for k, v in sd.items()})
        got = st(_nchw(x), None if ctx is None else torch.from_numpy(ctx))
        got = got.detach().permute(0, 2, 3, 1).numpy()
        assert np.abs(ref - x).max() > 0.1 and _rel(got, ref) <= 1e-5, context_dim


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_unet_variant_matches_jax(unets, variant):
    """The scale-shift, class-conditional and spatial-transformer UNets on
    the same weights, labels and context: within 1e-5 of max |JAX|; the
    labels and the context change the output."""
    ju, params, port = unets[variant]
    x, t, y, ctx = _inputs(1)
    ref = np.asarray(ju.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                              **_kwargs(variant, y, ctx)))
    kw = _kwargs(variant, torch.from_numpy(y), torch.from_numpy(ctx), torch)
    got = port(_nchw(x), torch.from_numpy(t), **kw).detach().permute(0, 2, 3, 1).numpy()
    assert _rel(got, ref) <= 1e-5
    if kw:
        other = {k: (v.flip(0) if k == "y" else v * 0) for k, v in kw.items()}
        moved = port(_nchw(x), torch.from_numpy(t), **other).detach().permute(0, 2, 3, 1)
        assert np.abs(moved.numpy() - got).max() > 1e-4


def test_unet_refuses_what_jax_refuses(unets):
    """The JAX UNet's three ValueErrors: a context without the spatial
    transformer, the transformer without context_dim, and missing labels;
    the triplane UNet takes neither option, and the video, NeRF and
    occupancy pipelines refuse model.DiT (MDTv2 serves the image domain)."""
    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline
    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline
    from ddmi_tpu_torch.domains.video import VideoPipeline
    from ddmi_tpu_torch.nn.unet_triplane import TriplaneUNet

    for pipeline in (VideoPipeline, NeRFPipeline, OccupancyPipeline):
        with pytest.raises(ValueError, match="image domain"):
            pipeline(config_from_dict({"model": {"DiT": True}}), device="cpu")

    x, t = torch.zeros(B, 4, 8, 8), torch.zeros(B, dtype=torch.long)
    with pytest.raises(ValueError, match="use_spatial_transformer is off"):
        unets["scale_shift"][2](x, t, cond=torch.zeros((B,) + CTX))
    with pytest.raises(ValueError, match="class labels y required"):
        unets["labels"][2](x, t)
    no_ctx = UNet(UNetConfig(**UNET, use_spatial_transformer=True))
    with pytest.raises(ValueError, match="requires unetconfig.context_dim"):
        no_ctx(x, t)
    with pytest.raises(ValueError, match="triplane"):
        TriplaneUNet(UNetConfig(**UNET, num_classes=3, plane_sizes=((8, 8),) * 3))


def _gd(mod, timesteps=20, sampling=4, w=1.5, mixed=True):
    sched = (jax_schedule if mod is jproc else make_schedule)("linear", timesteps, 0.0015, 0.0195)
    return mod.GaussianDiffusion(schedule=sched, mixed_prediction=mixed,
                                 sampling_timesteps=sampling, w=w)


def test_cfg_ddim_sample_matches_jax(unets):
    """Classifier-free-guided DDIM (4 steps, w = 1.5, mixed prediction) on
    the spatial-transformer UNet, the unconditional branch the same network
    on a zero context: within 1e-5 of max |JAX|; w = 0 is the conditional
    branch alone."""
    ju, params, port = unets["transformer"]
    x, _, _, ctx = _inputs(2)
    logit = np.random.default_rng(3).standard_normal((1, 1, 1, 4)).astype(np.float32)
    j = lambda c: (lambda xx, tt: ju.apply({"params": params}, xx, tt, cond=c))
    ref = np.asarray(jproc.ddim_sample(
        _gd(jproc), j(jnp.zeros_like(ctx)), jnp.asarray(logit), x.shape, jax.random.PRNGKey(0),
        noise=jnp.asarray(x), cond_model_fn=j(jnp.asarray(ctx))))
    p = lambda c: (lambda xx, tt: port(xx, tt, cond=c))
    tctx, tlogit = torch.from_numpy(ctx), _nchw(logit)
    got = process.ddim_sample(_gd(process), p(tctx * 0), tlogit, None, noise=_nchw(x),
                              cond_model_fn=p(tctx))
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) <= 1e-5
    w0 = process.ddim_sample(_gd(process, w=0.0), p(tctx * 0), tlogit, None, noise=_nchw(x),
                             cond_model_fn=p(tctx))
    cond = process.ddim_sample(_gd(process), p(tctx), tlogit, None, noise=_nchw(x))
    torch.testing.assert_close(w0, cond, rtol=0, atol=1e-5)
    assert (got - cond).abs().max() > 1e-4


def test_p_sample_loop_and_sample_dispatch_match_jax(unets):
    """The ancestral loop (T = 20, mixed prediction, x0 clipped) on the
    scale-shift UNet with JAX's per-step draws fed in: within 1e-5 of max
    |JAX|.  `sample` dispatches to DDIM when sampling_timesteps < T and to
    the ancestral loop at T, and refuses guidance there."""
    ju, params, port = unets["scale_shift"]
    x, _, _, _ = _inputs(4)
    logit = np.random.default_rng(5).standard_normal((1, 1, 1, 4)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    jfn = lambda xx, tt: ju.apply({"params": params}, xx, tt)
    jgd = dataclasses.replace(_gd(jproc, sampling=20), clip_denoised=True)
    ref = np.asarray(jproc.sample(jgd, jfn, jnp.asarray(logit), x.shape, key,
                                  noise=jnp.asarray(x)))
    rng, _ = jax.random.split(key)
    draws = []
    for _ in range(20):
        rng, sub = jax.random.split(rng)
        draws.append(_nchw(jax.random.normal(sub, x.shape, jnp.float32)))
    gd = dataclasses.replace(_gd(process, sampling=20), clip_denoised=True)
    got = process.sample(gd, port, _nchw(logit), None, noise=_nchw(x), step_noise=draws)
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) <= 1e-5
    loop = process.p_sample_loop(gd, port, _nchw(logit), None, noise=_nchw(x),
                                 step_noise=torch.stack(draws))
    assert torch.equal(loop, got)
    ddim = dataclasses.replace(gd, sampling_timesteps=4)
    assert torch.equal(process.sample(ddim, port, _nchw(logit), None, noise=_nchw(x)),
                       process.ddim_sample(ddim, port, _nchw(logit), None, noise=_nchw(x)))
    with pytest.raises(ValueError, match="DDIM only"):
        process.sample(gd, port, _nchw(logit), None, noise=_nchw(x), cond_model_fn=port)


def test_config_loader_reads_the_new_keys(tmp_path):
    """A YAML with a ditconfig section, the UNet's context_dim,
    transformer_depth and dropout, and ddpmconfig.w gives the values JAX's
    load_config gives."""
    import yaml

    from ddmi_tpu.core.config import load_config as jax_load
    from ddmi_tpu_torch.core.config import load_config

    raw = {"model": {"DiT": True, "params": {
        "ditconfig": {"input_size": 32, "patch_size": 4, "hidden_size": 384, "depth": 6,
                      "num_heads": 6, "mask_ratio": 0.3, "decode_layer": 2, "mlp_ratio": 2,
                      "cross_plane": True},
        "unetconfig": {"use_spatial_transformer": True, "context_dim": 512,
                       "transformer_depth": 2, "dropout": 0.1, "num_classes": 10,
                       "use_scale_shift_norm": True},
        "ddpmconfig": {"w": 3, "sampling_timesteps": 100}}}}
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(raw))
    got, want = load_config(str(path)).model, jax_load(str(path)).model
    assert got.DiT is want.DiT is True
    for f in dataclasses.fields(got.ditconfig):
        assert getattr(got.ditconfig, f.name) == getattr(want.ditconfig, f.name), f.name
    for name in ("use_spatial_transformer", "context_dim", "transformer_depth", "dropout",
                 "num_classes", "use_scale_shift_norm"):
        assert getattr(got.unetconfig, name) == getattr(want.unetconfig, name), name
    assert got.ddpmconfig.w == want.ddpmconfig.w == 3.0
    assert process.GaussianDiffusion.from_config(got.ddpmconfig).w == 3.0
