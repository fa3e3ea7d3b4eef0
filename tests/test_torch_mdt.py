"""The MDTv2 denoiser of the PyTorch port (ddmi_tpu_torch/nn/mdt.py) and
the image pipeline with `model.DiT`, against the JAX package on the CPU.

The tiny DiT of tests/test_mdt_gan.py (input 8, patch 2, hidden 32, depth
4, 4 heads, MLP ratio 2).  JAX parameters are `jax.eval_shape` shapes
filled with seeded normal draws (no flax init runs, and the zero-init
adaLN and output layers are perturbed so that no branch is vacuous),
carried to the port by `interop.mdt_from_jax`.  The masked path's (B, L)
uniform draws are JAX's own, fed to the port.  Each test states its
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import DiTConfig as JaxDiT
from ddmi_tpu.nn.mdt import MDTv2 as JaxMDT
from ddmi_tpu_torch.core.config import DiTConfig
from ddmi_tpu_torch.interop import mdt_from_jax
from ddmi_tpu_torch.nn.mdt import MDTv2, _rel_pos_index

torch.set_num_threads(2)

DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=4, num_heads=4,
           mlp_ratio=2.0, decode_layer=2)
VARIANTS = {"plain": {}, "masked": {"mask_ratio": 0.3}, "cross": {"cross_plane": True}}
B = 2


def fill(shapes, seed, scale=0.1):
    """Seeded N(0, scale^2) arrays in the shapes of a jax.eval_shape tree."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _mdt(variant):
    kw = {**DIT, **VARIANTS[variant]}
    jm = JaxMDT(JaxDiT(**kw))
    c = 12 if kw.get("cross_plane") else 4
    x = jnp.zeros((B, 8, 8, c))
    t = jnp.zeros((B,), jnp.int32)
    init = (lambda k: jm.init(k, x, t, enable_mask=True, rng=k)) if "mask_ratio" in kw \
        else (lambda k: jm.init(k, x, t))
    params = fill(jax.eval_shape(init, jax.random.PRNGKey(0))["params"], 1)
    port = MDTv2(DiTConfig(**kw))
    port.load_state_dict(mdt_from_jax(params, port.cfg))
    return jm, params, port, c


@pytest.fixture(scope="module")
def models():
    return {v: _mdt(v) for v in VARIANTS}


def _inputs(c, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 8, 8, c)).astype(np.float32)
    return x, np.array([3, 700]), torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


def test_rel_pos_index_matches_jax():
    from ddmi_tpu.nn.mdt import _rel_pos_index as jax_index

    for h, w in ((4, 4), (3, 5), (1, 2)):
        np.testing.assert_array_equal(_rel_pos_index(h, w), jax_index(h, w))
    with torch.device("meta"):  # the index buffer lands on the construction device
        m = MDTv2(DiTConfig(**DIT, mask_ratio=0.3))
    assert m.de_blocks[0].attn.rel_pos_bias.relative_position_index.is_meta


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mdt_forward_matches_jax(models, variant):
    """fp32 forwards on the same weights: the unmasked one of each variant,
    and the masked training path on JAX's mask draw (for the masked
    variant); max |err| <= 1e-5 max |JAX|.  A masked module's parameter
    keys add `mask_token` and `sideblocks.0` to the unmasked ones."""
    jm, params, port, c = models[variant]
    x, t, xt = _inputs(c)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    got = _nhwc(port(xt, torch.from_numpy(t)))
    assert got.shape == ref.shape == (B, 8, 8, c) and np.abs(ref).max() > 0.1
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    extra = {k for k in port.state_dict() if k.startswith(("mask_token", "sideblocks."))}
    assert bool(extra) == (variant == "masked")
    if variant == "masked":
        key = jax.random.PRNGKey(7)
        ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                  enable_mask=True, rng=key))
        noise = np.array(jax.random.uniform(key, (B, port.num_tokens())))
        got = _nhwc(port(xt, torch.from_numpy(t), mask_noise=torch.from_numpy(noise)))
        assert port.keep_count() == int(16 * 0.6)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_mdt_masked_gradients_match_jax(models):
    """The masked path's fp32 parameter gradients of sum(out * w) against
    jax.grad: cosine >= 0.99999 for every parameter."""
    jm, params, port, c = models["masked"]
    x, t, xt = _inputs(c, 4)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    key = jax.random.PRNGKey(8)
    noise = np.array(jax.random.uniform(key, (B, port.num_tokens())))

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t), enable_mask=True, rng=key)
        return jnp.sum(out * w)

    ref = mdt_from_jax(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)),
                       port.cfg)
    port.zero_grad()
    out = port(xt, torch.from_numpy(t), mask_noise=torch.from_numpy(noise))
    (out * torch.from_numpy(np.ascontiguousarray(w.transpose(0, 3, 1, 2)))).sum().backward()
    grads = dict(port.named_parameters())
    assert set(ref) == set(grads)
    for k, r in ref.items():
        g = grads[k].grad.flatten().double()
        r = r.flatten().double()
        cos = float(g @ r / (g.norm() * r.norm()))
        assert cos >= 0.99999, (k, cos)


def test_mdt_amp_forward_matches_jax_amp(models):
    """The bf16 policy (core/amp.py::amp_denoiser: bf16 weights, a bf16
    input) on the plain variant: only the patch embedding, the position add
    and the first norm compute in bf16, the rest in fp32 on bf16-rounded
    weights, as flax promotes.  The port's amp forward lies no farther from
    JAX's amp forward than JAX's amp forward lies from its fp32 one."""
    from ddmi_tpu.core.amp import amp_denoiser as jax_amp
    from ddmi_tpu_torch.core.amp import amp_denoiser

    jm, params, port, c = models["plain"]
    x, t, xt = _inputs(c, 6)
    fn = jax_amp(lambda p, xx, tt: jm.apply({"params": p}, xx, tt), params, True)
    ref_amp = np.asarray(fn(jnp.asarray(x), jnp.asarray(t)))
    ref32 = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    got = amp_denoiser(port, True)(xt, torch.from_numpy(t))
    assert got.dtype == torch.float32
    jax_gap = np.abs(ref_amp - ref32).max()
    assert 0 < np.abs(_nhwc(got) - ref_amp).max() <= jax_gap


# ----------------------------------------------------------- the pipeline

PIPE_CFG = {
    "model": {
        "DiT": True, "use_fp16": False, "amp": False, "embed_dim": 4,
        "params": {
            "ditconfig": {**DIT, "mask_ratio": 0.3},
            "ddconfig": dict(z_channels=8, resolution=32, out_ch=8, ch=32, ch_mult=[1, 1, 2],
                             num_res_blocks=1, hdbf_resolutions=[16, 8], attn_type="vanilla"),
            "mlpconfig": dict(ch=32, latent_dim=8),
            "ddpmconfig": dict(image_size=8, channels=4, sampling_timesteps=4),
        },
    },
    "data": {"domain": "image", "test_resolution": 16},
}


@pytest.fixture(scope="module")
def pipes():
    """The JAX ImagePipeline on the DiT config with filled parameters (the
    INR's noise weights stay 0: the two sides draw that noise from
    different generators), and the port's on the same weights."""
    from ddmi_tpu.core.config import config_from_dict as jax_cfg
    from ddmi_tpu.domains.image import ImagePipeline as JaxPipeline
    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.interop import mlp_image_from_jax, vae_from_jax

    jpipe = JaxPipeline(jax_cfg(PIPE_CFG))
    s1 = fill(jax.eval_shape(jpipe.init_stage1_params, jax.random.PRNGKey(0)), 2)
    for blk in s1["mlp"].values():
        for conv in blk.values() if isinstance(blk, dict) else ():
            if isinstance(conv, dict) and "noise" in conv:
                conv["noise"] = jax.tree_util.tree_map(np.zeros_like, conv["noise"])
    s2 = fill(jax.eval_shape(jpipe.init_stage2_params, jax.random.PRNGKey(1)), 3)
    cfg = config_from_dict(PIPE_CFG)
    pipe = ImagePipeline(cfg, device="cpu", seed=0)
    m = cfg.model
    pipe.load_state_dicts(
        unet=mdt_from_jax(s2["unet"], m.ditconfig), vae=vae_from_jax(s1["vae"], m.ddconfig),
        mlp=mlp_image_from_jax(s1["mlp"], m.mlpconfig),
        mixing_logit=np.transpose(s2["mixing_logit"], (0, 3, 1, 2)))
    return jpipe, s1, s2, pipe


def test_dit_pipeline_parameters_and_turbo_refused(pipes):
    """With model.DiT the pipeline's denoiser is MDTv2: its parameters are
    JAX's (init_stage2_params, through the masked path when mask_ratio is
    set) key for key and shape for shape, without `mask_token` and
    `sideblocks` when mask_ratio is None; encoder reuse raises ValueError."""
    import copy

    from ddmi_tpu.core.config import config_from_dict as jax_cfg
    from ddmi_tpu.domains.image import ImagePipeline as JaxPipeline
    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.image import ImagePipeline

    _, _, s2, pipe = pipes
    assert isinstance(pipe.unet, MDTv2) and pipe.masked_denoiser
    want = {k: tuple(v.shape) for k, v in mdt_from_jax(s2["unet"], pipe.cfg.model.ditconfig).items()}
    assert {k: tuple(v.shape) for k, v in pipe.unet.state_dict().items()} == want
    raw = copy.deepcopy(PIPE_CFG)
    raw["model"]["params"]["ditconfig"]["mask_ratio"] = None
    raw["model"]["params"]["ddpmconfig"]["encoder_reuse"] = 2
    jp = JaxPipeline(jax_cfg(raw))
    tree = jax.eval_shape(jp.init_stage2_params, jax.random.PRNGKey(1))["unet"]
    plain = ImagePipeline(config_from_dict(raw), device="cpu")
    assert not plain.masked_denoiser
    keys = set(plain.unet.state_dict())
    assert keys == set(mdt_from_jax(fill(tree, 0), plain.cfg.model.ditconfig))
    assert keys == {k for k in want if not k.startswith(("mask_token", "sideblocks."))}
    with pytest.raises(ValueError, match="encoder_reuse"):
        plain.sample_images(1, 16)


def test_dit_stage2_loss_matches_jax(pipes):
    """stage2_loss with the masked MDTv2 against JAX's stage2_loss on JAX's
    own draws (the posterior eps, t, the diffusion noise and the mask's
    uniforms, rebuilt from its key split): within 1e-5 relative."""
    jpipe, s1, s2, pipe = pipes
    x = np.random.default_rng(9).random((B, 40, 40, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = float(jax.jit(jpipe.stage2_loss)(s2, s1, jnp.asarray(x), key)[0])
    k_enc, k_diff, k_mask = jax.random.split(key, 3)
    k_t, k_n = jax.random.split(k_diff)
    shape = (B, 8, 8, 4)
    draws = {
        "eps": jax.random.normal(k_enc, shape, jnp.float32),
        "t": jax.random.randint(k_t, (B,), 0, 1000),
        "noise": jax.random.normal(k_n, shape),
        "mask_noise": jax.random.uniform(k_mask, (B, 16)),
    }
    draws = {k: torch.from_numpy(np.array(v.transpose(0, 3, 1, 2) if v.ndim == 4 else v))
             for k, v in draws.items()}
    loss, _ = pipe.stage2_loss(torch.from_numpy(x), **draws)
    assert abs(loss.item() - ref) <= 1e-5 * abs(ref)


def test_dit_sample_images_matches_jax(pipes):
    """sample_images through MDTv2 (4 DDIM steps, decode, render) on the
    same initial latent: pixels within 1e-4."""
    jpipe, s1, s2, pipe = pipes
    noise = np.random.default_rng(12).standard_normal((B, 8, 8, 4)).astype(np.float32)
    as_jnp = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    ref = np.asarray(jpipe.sample_images(as_jnp(s2), as_jnp(s1), jax.random.PRNGKey(2), batch=B,
                                         resolution=16, noise=jnp.asarray(noise)))
    got = pipe.sample_images(B, 16, noise=torch.from_numpy(
        np.ascontiguousarray(noise.transpose(0, 3, 1, 2)))).numpy()
    assert got.shape == ref.shape == (B, 16, 16, 3) and ref.std() > 1e-3
    assert np.abs(got - ref).max() <= 1e-4
