"""The ConvONet's ops and blocks in the port against the JAX package, on the
same weights (converted by ddmi_tpu_torch/interop.py) and the same numpy
inputs, on the CPU: resample's zeros padding, grid_sample_3d and
grid_sample_nchw_like, upfirdn (up, down, negative pads, blur,
upsample_2d, downsample_2d), the StyleGAN blocks at k > 1 (EqualConv2d,
ModulatedConv plain, upsampling and downsampling, ToRGB's upsampled skip,
ConvLayer), the channels-last GroupNorm, and UNet2D / UNet3D.

Tolerance: fp32 on both sides, sums in other orders: max|diff| <= 1e-5 *
max(1, max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu_torch import interop

torch.set_num_threads(1)

REL = 1e-5


def _close(got, ref, what="", rel=REL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ resample


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_separable_grid_sample_matches_jax(align_corners, padding_mode):
    from ddmi_tpu.ops import resample as jr
    from ddmi_tpu_torch.ops import resample as tr

    rng = np.random.default_rng(0)
    plane = _rand(rng, 2, 7, 9, 3)  # NHWC for JAX
    xs = rng.uniform(-1.3, 1.3, 11).astype(np.float32)
    ys = rng.uniform(-1.3, 1.3, 5).astype(np.float32)
    ref = jr.separable_grid_sample(jnp.asarray(plane), jnp.asarray(xs), jnp.asarray(ys),
                                   align_corners, padding_mode)
    got = tr.separable_grid_sample(_t(plane).permute(0, 3, 1, 2), _t(xs), _t(ys),
                                   align_corners, padding_mode)
    _close(got, ref, "separable_grid_sample")
    m_ref = jr.interp_matrix_1d(jnp.asarray(xs), 9, align_corners, padding_mode)
    _close(tr.interp_matrix_1d(_t(xs), 9, align_corners, padding_mode), m_ref, "matrix")
    _close(tr.pixel_center_lin(6), jr.pixel_center_lin(6), "pixel_center_lin")
    with pytest.raises(NotImplementedError):
        tr.interp_matrix_1d(_t(xs), 9, align_corners, "reflection")


# --------------------------------------------------------------- grid sample


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_3d_matches_jax(align_corners, padding_mode):
    """F.grid_sample and the differentiable eight-gather form both."""
    from ddmi_tpu.ops.grid_sample import grid_sample_3d as jgs
    from ddmi_tpu_torch.ops.grid_sample import grid_sample_3d, trilinear_gather

    rng = np.random.default_rng(1)
    feat = _rand(rng, 2, 4, 5, 6, 3)
    grid = rng.uniform(-1.2, 1.2, (2, 50, 3)).astype(np.float32)
    ref = jgs(jnp.asarray(feat), jnp.asarray(grid), align_corners, padding_mode)
    _close(grid_sample_3d(_t(feat), _t(grid), align_corners, padding_mode), ref, "3d")
    g = _t(grid).requires_grad_(True)
    _close(grid_sample_3d(_t(feat), g, align_corners, padding_mode), ref, "3d gather")
    _close(trilinear_gather(_t(feat), _t(grid), align_corners, padding_mode), ref, "gather")


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_nchw_like_matches_jax(padding_mode):
    from ddmi_tpu.ops.grid_sample import grid_sample_nchw_like as jgs
    from ddmi_tpu_torch.ops.grid_sample import bilinear_gather, grid_sample_nchw_like

    rng = np.random.default_rng(2)
    feat = _rand(rng, 2, 3, 6, 7)
    grid = rng.uniform(-1.2, 1.2, (2, 4, 5, 2)).astype(np.float32)
    for ac in (False, True):
        ref = jgs(jnp.asarray(feat), jnp.asarray(grid), ac, padding_mode)
        _close(grid_sample_nchw_like(_t(feat), _t(grid), ac, padding_mode), ref, "nchw")
        flat = bilinear_gather(_t(feat).permute(0, 2, 3, 1), _t(grid).reshape(2, 20, 2), ac,
                               padding_mode)
        _close(flat.reshape(2, 4, 5, 3).permute(0, 3, 1, 2), ref, "bilinear_gather")


# ------------------------------------------------------------------- upfirdn


@pytest.mark.parametrize("up, down, pad", [(1, 1, (1, 2)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                           (2, 2, (0, 0)), (3, 1, (-1, -2)), (1, 1, (-1, 2))])
def test_upfirdn2d_matches_jax(up, down, pad):
    from ddmi_tpu.ops import upfirdn as ju
    from ddmi_tpu_torch.ops import upfirdn as tu

    rng = np.random.default_rng(up * 10 + down)
    x = _rand(rng, 2, 9, 8, 3)
    k = ju.make_fir_kernel((1, 3, 3, 1))
    _close(tu.make_fir_kernel((1, 3, 3, 1)), k, "fir kernel")
    ref = ju.upfirdn2d(jnp.asarray(x), k, up, down, pad)
    _close(tu.upfirdn2d(_t(x), tu.make_fir_kernel((1, 3, 3, 1)), up, down, pad), ref, "upfirdn")


def test_blur_upsample_downsample_match_jax():
    from ddmi_tpu.ops import upfirdn as ju
    from ddmi_tpu_torch.ops import upfirdn as tu

    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 8, 8, 4)
    jk, tk = ju.make_fir_kernel((1, 3, 3, 1)), tu.make_fir_kernel((1, 3, 3, 1))
    _close(tu.blur(_t(x), tk, (2, 1)), ju.blur(jnp.asarray(x), jk, (2, 1)), "blur")
    _close(tu.blur(_t(x), tk, (2, 2), upsample_factor=2),
           ju.blur(jnp.asarray(x), jk, (2, 2), upsample_factor=2), "blur x2")
    _close(tu.upsample_2d(_t(x), tk), ju.upsample_2d(jnp.asarray(x), jk), "upsample_2d")
    _close(tu.downsample_2d(_t(x), tk), ju.downsample_2d(jnp.asarray(x), jk), "downsample_2d")


# ------------------------------------------------------------------ StyleGAN


def _perturbed(tree, seed):
    """Every leaf of a flax tree replaced by seeded values of its shape
    (modulation biases near 1, so the styles stay away from 0)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(path[-1].key)
        v = rng.standard_normal(np.shape(a)).astype(np.float32)
        return 1.0 + 0.1 * v if (name == "bias" and "modulation" in str(path)) else v

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("k, demod, up, down", [(3, True, False, False), (3, False, False, False),
                                                (3, True, True, False), (1, True, True, False),
                                                (3, True, False, True), (1, False, False, True)])
def test_modulated_conv_matches_jax(k, demod, up, down):
    from ddmi_tpu.nn.stylegan import ModulatedConv as JMC
    from ddmi_tpu_torch.nn.stylegan import ModulatedConv

    rng = np.random.default_rng(k * 4 + up * 2 + down)
    x, style = _rand(rng, 2, 8, 8, 6), _rand(rng, 2, 5)
    jm = JMC(4, k, demodulate=demod, upsample=up, downsample=down)
    params = _perturbed(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, style)["params"], k)
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(style))
    m = ModulatedConv(6, 4, 5, demod, kernel_size=k, upsample=up, downsample=down)
    m.load_state_dict(interop.modulated_conv_from_jax(params))
    with torch.no_grad():
        got = m(_t(x), _t(style))
    _close(got, ref, "ModulatedConv")


def test_equal_conv2d_conv_layer_and_torgb_match_jax():
    from ddmi_tpu.nn import stylegan as js
    from ddmi_tpu_torch.nn import stylegan as ts

    rng = np.random.default_rng(7)
    x, style = _rand(rng, 2, 8, 8, 6), _rand(rng, 2, 5)
    je = js.EqualConv2d(4, 3, stride=2, padding=1)
    p = _perturbed(jax.eval_shape(je.init, jax.random.PRNGKey(0), x)["params"], 1)
    te = ts.EqualConv2d(6, 4, 3, stride=2, padding=1)
    te.load_state_dict(interop.equal_conv2d_from_jax(p))
    with torch.no_grad():
        _close(te(_t(x)), je.apply({"params": p}, jnp.asarray(x)), "EqualConv2d")

    # ConvLayer at k 3: activated with the fused bias, and with the scaled
    # LeakyReLU (no bias)
    for bias in (True, False):
        jc = js.ConvLayer(4, 3, activate=True, use_bias=bias)
        p = _perturbed(jax.eval_shape(jc.init, jax.random.PRNGKey(0), x)["params"], 2)
        tc = ts.ConvLayer(6, 4, kernel_size=3, activate=True, bias=bias)
        sd = {f"0.{k}": v for k, v in interop.equal_conv2d_from_jax(p["EqualConv2d_0"]).items()}
        if bias:
            sd["1.bias"] = _t(p["act_bias"])
        tc.load_state_dict(sd)
        with torch.no_grad():
            _close(tc(_t(x)), jc.apply({"params": p}, jnp.asarray(x)), f"ConvLayer {bias}")

    # ToRGB: the 1x1 modulated conv on NHWC planes plus the 2x FIR-upsampled skip
    skip = _rand(rng, 2, 4, 4, 3)
    jt = js.ToRGB(3)
    p = _perturbed(jax.eval_shape(jt.init, jax.random.PRNGKey(0), x, style, skip)["params"], 3)
    tt = ts.ToRGB(6, 3, 5)
    sd = {f"conv.{k}": v for k, v in interop.modulated_conv_from_jax(p["conv"]).items()}
    sd["bias"] = _t(np.asarray(p["bias"]).reshape(1, -1, 1, 1))
    tt.load_state_dict(sd)
    with torch.no_grad():
        got = tt(_t(x), _t(style), _t(skip))
    _close(got, jt.apply({"params": p}, jnp.asarray(x), jnp.asarray(style), jnp.asarray(skip)),
           "ToRGB skip")


# ---------------------------------------------------------------- GroupNorm


def test_fast_group_norm_matches_jax():
    from ddmi_tpu.ops import fused as jf
    from ddmi_tpu_torch.ops import fused as tf

    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 5, 6, 32, scale=2.0) + 0.5
    jm, tm = jf.FastGroupNorm(num_groups=8), tf.FastGroupNorm(32, num_groups=8)
    p = _perturbed(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"], 4)
    tm.load_state_dict(interop.fast_group_norm_from_jax(p))
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply({"params": p}, jnp.asarray(x)), "FastGroupNorm")
    mean, var = jf.group_norm_stats_mxu(jnp.asarray(x), 8)
    tmean, tvar = tf.group_norm_stats_mxu(_t(x), 8)
    _close(tmean, mean, "mean")
    _close(tvar, var, "var")


# -------------------------------------------------------------------- UNets


@pytest.mark.parametrize("merge_mode", ["concat", "add"])
def test_unet2d_matches_jax(merge_mode):
    from ddmi_tpu.nn.conv_unet import UNet2D as J
    from ddmi_tpu_torch.nn.conv_unet import UNet2D

    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 8, 8, 5)
    jm = J(4, depth=3, start_filts=4, merge_mode=merge_mode)
    p = _perturbed(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"], 5)
    tm = UNet2D(4, 5, depth=3, start_filts=4, merge_mode=merge_mode)
    tm.load_state_dict(interop.unet2d_from_jax(p, 3))
    with torch.no_grad():
        got = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jm.apply({"params": p}, jnp.asarray(x)), "UNet2D")


def test_unet3d_matches_jax():
    from ddmi_tpu.nn.conv_unet import UNet3D as J
    from ddmi_tpu_torch.nn.conv_unet import UNet3D

    rng = np.random.default_rng(6)
    x = _rand(rng, 1, 8, 8, 8, 3)
    jm = J(4, f_maps=4, num_levels=3)
    p = _perturbed(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"], 6)
    tm = UNet3D(4, 3, f_maps=4, num_levels=3)
    tm.load_state_dict(interop.unet3d_from_jax(p, 3))
    with torch.no_grad():
        got = tm(_t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    _close(got, jm.apply({"params": p}, jnp.asarray(x)), "UNet3D")
