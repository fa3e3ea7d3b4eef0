"""The video slice's modules in the PyTorch port against the JAX package,
on the CPU, at small sizes: the TimeSformer's rotary tables and blocks,
the TimeSformer and the pooling transformer, the MEA with JAX's keywords
and its gradient, the decoder's 1D attention block under autograd on both
of its routes, the 2D + 3D PatchGAN pair, and SyntheticVideos
(tests/test_torch_video_train.py holds the helpers and the stage-1 and
stage-2 losses).  Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu_torch.interop import (
    discriminator3d_from_jax, timesformer_from_jax, vit_transformer_from_jax,
)
from test_torch_video_train import (
    B, RES, T, _np, _randomize, _random_tree, _rel, grad_check, jit_optimized,
)

torch.set_num_threads(1)


def test_rotary_tables_and_rotation_match_jax():
    """rotary_frame_emb, rotary_axial_emb (linspace(-1, 1), base-2 logspace)
    and apply_rot_emb (interleaved pairs) against JAX: within 1e-5 (fp32
    sinusoids of phases up to 5 pi computed in another order)."""
    from ddmi_tpu.nn import vit as jvit
    from ddmi_tpu_torch.nn import vit

    for got, ref in ((vit.rotary_frame_emb(16, 64), jvit.rotary_frame_emb(16, 64)),
                     (vit.rotary_axial_emb(8, 6, 64), jvit.rotary_axial_emb(8, 6, 64))):
        for g, r in zip(got, ref):
            assert g.dtype == torch.float32 and g.shape == r.shape
            assert np.abs(_np(g) - np.asarray(r)).max() <= 1e-5
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((2, 3, 48, 64)).astype(np.float32) for _ in range(2))
    rot = jvit.rotary_axial_emb(8, 6, 64)
    jq, jk = jvit.apply_rot_emb(jnp.asarray(q), jnp.asarray(k), rot)
    tq, tk = vit.apply_rot_emb(torch.from_numpy(q), torch.from_numpy(k),
                               tuple(torch.from_numpy(np.asarray(a)) for a in rot))
    assert np.abs(_np(tq) - np.asarray(jq)).max() <= 1e-5
    assert np.abs(_np(tk) - np.asarray(jk)).max() <= 1e-5
    x = rng.standard_normal((3, 8)).astype(np.float32)
    assert np.array_equal(_np(vit.rotate_every_two(torch.from_numpy(x))),
                          np.asarray(jvit.rotate_every_two(jnp.asarray(x))))


def _dense_sd(p, key, sd, bias=True):
    sd[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(p["kernel"]).T))
    if bias:
        sd[key + ".bias"] = torch.from_numpy(np.asarray(p["bias"]))


@pytest.mark.parametrize("case", ["geglu", "mlp", "time", "space"])
def test_vit_blocks_match_jax(case):
    """FeedForwardGEGLU (exact-erf GELU), FeedForwardMLP and DividedAttention
    over the time and the space axis (q scaled before the regrouping and the
    rotary), on JAX's random weights: within 1e-4 relative, and the input
    gradient against jax.grad."""
    from ddmi_tpu.nn import vit as jvit
    from ddmi_tpu_torch.nn import vit

    f, n, dim = 4, 16, 32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, f * n, dim)).astype(np.float32)
    sd = {}
    if case in ("geglu", "mlp"):
        jm = jvit.FeedForwardGEGLU(dim) if case == "geglu" else jvit.FeedForwardMLP(dim, 48)
        tm = vit.FeedForwardGEGLU(dim) if case == "geglu" else vit.FeedForwardMLP(dim, 48)
        p = _random_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
        _dense_sd(p["Dense_0"], "net.0", sd)
        _dense_sd(p["Dense_1"], "net.3", sd)
        jfn = lambda p, a: jm.apply({"params": p}, a)
        tfn = tm
    else:
        rot = (jvit.rotary_frame_emb(f, 16) if case == "time"
               else jvit.rotary_axial_emb(4, 4, 16))
        jm, tm = jvit.DividedAttention(dim, 2, 16), vit.DividedAttention(dim, 2, 16)
        p = _random_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), case, f, n, rot)["params"],
                         2)
        _dense_sd(p["to_qkv"], "to_qkv", sd, bias=False)
        _dense_sd(p["to_out"], "to_out.0", sd)
        jfn = lambda p, a: jm.apply({"params": p}, a, case, f, n, rot)
        trot = tuple(torch.from_numpy(np.asarray(a)) for a in rot)
        tfn = lambda a: tm(a, case, f, n, trot)
    tm.load_state_dict(sd, strict=True)
    w = rng.standard_normal(x.shape[:2] + (dim,)).astype(np.float32)
    ref, jg = jax.value_and_grad(lambda a: (jfn(p, a) * w).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tfn(xt)
    (out * torch.from_numpy(w)).sum().backward()
    assert _rel(_np(out), np.asarray(jfn(p, jnp.asarray(x)))) <= 1e-5
    assert _rel(_np(xt.grad), np.asarray(jg)) <= 1e-4


def test_timesformer_and_pooling_transformer_match_jax():
    """TimeSformerEncoder (depth 2, 4 frames of 32^2, patch 8) and the
    pooling Transformer on JAX's random weights through the bridge: values
    within 1e-4 relative; the TimeSformer's input gradient through its
    per-layer checkpoints against jax.grad."""
    from ddmi_tpu.nn import vit as jvit
    from ddmi_tpu_torch.nn import vit

    rng = np.random.default_rng(2)
    video = rng.uniform(-1, 1, (2, T, RES, RES, 3)).astype(np.float32)
    jm = jvit.TimeSformerEncoder(dim=64, num_frames=T, image_size=RES, patch_size=8, depth=2)
    p = _random_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(video))["params"], 3)
    tm = vit.TimeSformerEncoder(dim=64, patch_size=8, depth=2)
    tm.load_state_dict(timesformer_from_jax(jax.tree_util.tree_map(np.asarray, p)), strict=True)
    w = rng.standard_normal((2, T * 16, 64)).astype(np.float32)
    jfn = lambda a: (jm.apply({"params": p}, a) * w).sum()
    ref, jg = jax.value_and_grad(jfn)(jnp.asarray(video))
    vt = torch.from_numpy(video).requires_grad_()
    out = tm(vt)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    assert _rel(_np(out), np.asarray(jm.apply({"params": p}, jnp.asarray(video)))) <= 1e-4
    assert abs(loss.item() - float(ref)) <= 1e-4 * abs(float(ref))
    assert _rel(_np(vt.grad), np.asarray(jg)) <= 1e-4

    tokens = rng.standard_normal((6, 5, 64)).astype(np.float32)
    jt = jvit.Transformer(64, depth=4, heads=4, dim_head=8, mlp_dim=512)
    pt = _random_tree(jt.init(jax.random.PRNGKey(1), jnp.asarray(tokens))["params"], 4)
    tt = vit.Transformer(64, depth=4, heads=4, dim_head=8, mlp_dim=512)
    tt.load_state_dict(vit_transformer_from_jax(jax.tree_util.tree_map(np.asarray, pt)),
                       strict=True)
    assert _rel(_np(tt(torch.from_numpy(tokens))),
                np.asarray(jt.apply({"params": pt}, jnp.asarray(tokens)))) <= 1e-5


@pytest.mark.parametrize("kw,n", [
    ({}, 300),
    (dict(kv_chunk=128, q_chunk=96, scale=0.3, dense_max=64), 300),
    (dict(kv_chunk=1024, q_chunk=256, scale=1.0, dense_max=512), 1100),
])
def test_mea_attention_keywords_and_gradients_match_jax(kw, n):
    """ddmi_tpu_torch.ops.mea.attention with JAX's keywords, dense and
    streamed at a ragged n (JAX pads it with a key mask; the port cuts the
    last chunk short), and its q/k/v gradients against jax.grad: within
    1e-5 relative."""
    from ddmi_tpu.ops.mea import attention as jax_mea
    from ddmi_tpu_torch.ops import mea

    rng = np.random.default_rng(n)
    q, k, v, w = (rng.standard_normal((2, 3, n, 16)).astype(np.float32) for _ in range(4))
    fn = lambda q, k, v: (jax_mea(q, k, v, **kw) * w).sum()
    ref, jg = jax.value_and_grad(fn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = mea.attention(*ts, **kw)
    assert _rel(_np(out), np.asarray(jax_mea(*map(jnp.asarray, (q, k, v)), **kw))) <= 1e-5
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, jg):
        assert _rel(_np(t.grad), np.asarray(g)) <= 1e-5


@pytest.mark.parametrize("route", ["flash", "mea"])
def test_attn_block_1d_expand_under_autograd_matches_jax(route, monkeypatch):
    """AttnBlock1DExpand (2 heads of C = 32) with a gradient recorded: at
    n = 1024 on the flash route (its plain versions on the CPU), and at
    n = 3072 with FLASH_TRAIN_MAX_TOKENS lowered to 2048 on the streamed
    MEA route; the loss within 1e-4 relative, the input gradient within
    1e-4 relative and the weight gradients at the fp32 gradient bars,
    against jax.grad of the JAX block (the MEA on the CPU).  (k's bias has
    no gradient: softmax ignores a shift of every score in a row.)"""
    from ddmi_tpu.nn.attention1d import AttnBlock1DExpand as JaxBlock
    from ddmi_tpu_torch.interop import _attn1d
    from ddmi_tpu_torch.nn import attention1d
    from ddmi_tpu_torch.ops import flash_attention, mea

    n = 1024 if route == "flash" else 3072
    if route == "mea":
        monkeypatch.setattr(attention1d, "FLASH_TRAIN_MAX_TOKENS", 2048)
    calls = {"flash": 0, "mea": 0}
    for mod, name in ((flash_attention, "flash_attention"), (mea, "attention")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _k="flash" if mod is flash_attention else "mea", **kw):
            calls[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((1, n, 32)).astype(np.float32)
    w = rng.standard_normal((1, n, 32)).astype(np.float32)
    jm = JaxBlock(num_heads=2)
    p = _random_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 6)
    sd = {}
    _attn1d(sd, "", jax.tree_util.tree_map(np.asarray, p))
    tm = attention1d.AttnBlock1DExpand(32, num_heads=2)
    tm.load_state_dict({k[1:]: v for k, v in sd.items()}, strict=True)
    ref, (gp, gx) = jax.value_and_grad(
        lambda p, a: (jm.apply({"params": p}, a) * w).sum(), argnums=(0, 1))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss = (tm(xt) * torch.from_numpy(w)).sum()
    loss.backward()
    assert calls == {"flash": int(route == "flash"), "mea": int(route == "mea")}
    assert abs(loss.item() - float(ref)) <= 1e-4 * abs(float(ref))
    assert _rel(_np(xt.grad), np.asarray(gx)) <= 1e-4
    gsd = {}
    _attn1d(gsd, "", jax.tree_util.tree_map(np.asarray, gp))
    params = dict(tm.named_parameters())
    grad_check({k: _np(params[k[1:]].grad) for k in gsd}, {k: _np(v) for k, v in gsd.items()})


def test_gan_loss_3d_matches_jax_both_ways():
    """GANLoss3D's generator loss (2D PatchGAN on the drawn frame + 3D
    PatchGAN on the clip, feature matching against detached real taps) and
    discriminator loss on JAX's discriminators (zero leaves randomised),
    on 2 clips of 4 x 16^2: values within 1e-5 relative, the generator
    loss's gradient in the reconstruction and the discriminator loss's in
    each of the discriminators' parameters at the fp32 gradient bars
    against jax.grad (the biases of the convs before a batch norm have no
    gradient: theirs is roundoff on both sides).  The discriminator loss
    and its gradients are JAX's in float64: XLA's fp32 gradients of the 3D
    convolutions on the CPU lie up to 0.12 x max|g| from float64 here (the
    port's fp32 ones within 4e-6)."""
    from ddmi_tpu.losses.gan import GANLoss3D as JaxGAN
    from ddmi_tpu_torch.interop import discriminator3d_to_jax
    from ddmi_tpu_torch.losses.gan import GANLoss3D

    x, r = (np.random.default_rng(s).uniform(-1, 1, (B, T, 16, 16, 3)).astype(np.float32)
            for s in (8, 9))
    fi = np.array([3, 1])
    jm = JaxGAN(disc_weight=0.5)
    p = _randomize(jax.jit(jm.init, static_argnums=3)(
        jax.random.PRNGKey(11), jnp.asarray(x), jnp.asarray(r), False)["params"], 10, 0.02)
    tm = GANLoss3D(3, disc_weight=0.5)
    tm.load_state_dict(discriminator3d_from_jax(p), strict=True)
    g_ref, g_grad = jit_optimized(jax.value_and_grad(
        lambda a: jm.apply({"params": p}, jnp.asarray(x), a, True, jnp.asarray(fi))))(
        jnp.asarray(r))
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))
        d_ref, d_grad = jit_optimized(jax.value_and_grad(
            lambda q: jm.apply({"params": q}, f64(x), f64(r), False, jnp.asarray(fi))))(
            jax.tree_util.tree_map(f64, p))
        d_grad = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), d_grad)
    rt = torch.from_numpy(r).requires_grad_()
    g = tm.generator_loss(torch.from_numpy(x), rt, torch.from_numpy(fi))
    g.backward()
    assert abs(g.item() - float(g_ref)) <= 1e-5 * abs(float(g_ref))
    grad_check({"r": rt.grad.numpy()}, {"r": np.asarray(g_grad)})
    tm.zero_grad()
    d = tm.discriminator_loss(torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(fi))
    d.backward()
    assert abs(d.item() - float(d_ref)) <= 1e-5 * abs(float(d_ref))
    ref_g = discriminator3d_from_jax(d_grad)
    top = max(float(np.abs(v.numpy()).max()) for v in ref_g.values())
    for k, q in tm.named_parameters():
        if k.split(".")[1:] in (["convs", "1", "bias"], ["convs", "2", "bias"],
                                ["convs", "3", "bias"]):
            # a bias just before a batch norm cannot change the loss: its
            # gradient is roundoff on both sides
            assert np.abs(q.grad.numpy()).max() <= 1e-5 * top, k
        elif not ref_g[k].any():
            # the 2D logits conv's bias: the hinge's real and fake terms
            # cancel while every logit lies inside (-1, 1)
            assert not q.grad.any(), k
        else:
            grad_check({k: q.grad.numpy()}, {k: ref_g[k].numpy()})


def test_synthetic_videos_match_jax_bit_for_bit():
    from ddmi_tpu.data.video import SyntheticVideos as JaxVideos
    from ddmi_tpu_torch.data.video import SyntheticVideos

    for a, b in zip(SyntheticVideos(2, frames=5, resolution=24, length=3, seed=4),
                    JaxVideos(2, frames=5, resolution=24, length=3, seed=4)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
