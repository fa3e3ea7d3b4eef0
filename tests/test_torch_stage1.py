"""The modules of the ported stage-1 image training against the JAX package,
on the CPU, on the same weights (carried by ddmi_tpu_torch/interop.py) and
the same numpy inputs and draws: the multiscale transform and the KL
warm-up, DiagonalGaussian.kl, grid_sample_2d and INRImage at arbitrary
coordinates, LinAttnBlock, the spectral-norm regulariser, LPIPS, the
PatchGAN losses, DiffAugment, the learning-rate schedules and the
fp32-mu AdamW inside MultiSteps, and the config reader on the d2c-vae
configs.

Tolerances (fp32 on both sides, sums in other orders): values within 1e-5
relative (Frobenius, or max|err| <= 1e-5 * max(1, max|ref|) where stated);
gradients with a cosine >= 0.99999 and max|err| <= 1e-4 * max|ref|; the
bf16 LPIPS trunk within 1e-2 relative (bf16 roundings of 13 convolutions
in another order); coordinates and integer draws exact.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _grad_close(got, ref, what=""):
    """Gradient agreement: cosine >= 0.99999 and max|err| <= 1e-4 max|ref|."""
    g, r = np.asarray(got, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    cos = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r)))
    err = float(np.abs(g - r).max() / np.abs(r).max())
    assert cos >= 0.99999 and err <= 1e-4, (what, cos, err)


def _randomize(tree, seed, scale=0.05):
    """Seeded random values for every all-zero leaf of a JAX params tree."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(np.shape(a))).astype(np.float32)
        if not np.any(np.asarray(a)) else np.asarray(a, np.float32), tree)


# ------------------------------------------------------------ coordinates


@pytest.mark.parametrize("key", [0, 4, 3])
def test_multiscale_transform_matches_jax_on_its_draws(key):
    """multiscale_image_transform on the JAX function's own draws (p and the
    crop offsets, as it splits its key), at anchor 16 on 32 x 32 inputs:
    the keys take the three branches between them.  Target and y_anchor
    within 1e-5 * max(1, max|ref|), coordinates within 1e-6 (linspace in
    another library), the scale exact."""
    from ddmi_tpu.core.coords import multiscale_image_transform as jax_ms
    from ddmi_tpu_torch.core.coords import multiscale_image_transform

    size, res_m, res_h = 16, 24, 32
    rng = jax.random.PRNGKey(key)
    x = np.random.default_rng(key).uniform(-1.2, 1.2, (2, 32, 32, 3)).astype(np.float32)
    ref = jax_ms(jnp.asarray(x), rng, size, True)
    rp, ri, rj, ri2, rj2 = jax.random.split(rng, 5)
    draws = (float(jax.random.uniform(rp)),
             int(jax.random.randint(ri, (), 0, res_h - size)),
             int(jax.random.randint(rj, (), 0, res_h - size)),
             int(jax.random.randint(ri2, (), 0, res_m - size)),
             int(jax.random.randint(rj2, (), 0, res_m - size)))
    got = multiscale_image_transform(torch.from_numpy(x), size, True, draws)
    for g, r in ((got[0], ref[0]), (got[3], ref[3])):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-5 * max(1.0, np.abs(r).max())
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-6)
    assert got[2] == float(ref[2])
    branch = 0 if draws[0] <= 0.3 else (1 if draws[0] <= 0.6 else 2)
    assert got[2] == (1.0, float(np.float32(1 / 1.5)), 0.5)[branch]


def test_multiscale_keys_cover_every_branch():
    """The three keys of the test above take the three branches."""
    ps = [float(jax.random.uniform(jax.random.split(jax.random.PRNGKey(k), 5)[0]))
          for k in (0, 4, 3)]
    assert sorted(0 if p <= 0.3 else (1 if p <= 0.6 else 2) for p in ps) == [0, 1, 2], ps


def test_multiscale_off_and_host_draw_ranges():
    """multiscale False returns the anchor resize and the full grid; the
    port's own draws stay in JAX's ranges."""
    from ddmi_tpu.core.coords import pixel_center_grid as jax_grid
    from ddmi_tpu_torch.core.coords import draw_multiscale, multiscale_image_transform

    x = torch.rand(1, 32, 32, 3) * 2 - 1
    t, c, s, y = multiscale_image_transform(x, 16, False)
    assert t is y and s == 1.0
    np.testing.assert_allclose(c.numpy(), np.asarray(jax_grid(16)), rtol=0, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        p, i, j, i2, j2 = draw_multiscale(16, g)
        assert 0 <= p < 1 and 0 <= i < 16 and 0 <= j < 16 and 0 <= i2 < 8 and 0 <= j2 < 8


@pytest.mark.parametrize("step", [0, 1, 7, 50, 4500, 5000, 9000])
def test_linear_kl_coeff_matches_jax(step):
    """The annealed KL coefficient at the celebahq portions over 5000
    micro-steps, exact in fp32."""
    from ddmi_tpu.core.coords import linear_kl_coeff as jax_kl
    from ddmi_tpu_torch.core.coords import linear_kl_coeff

    total = jnp.maximum(5000, 1)
    ref = jax_kl(jnp.int32(step), 0.9 * total, 0.0001 * total, 0.0001, 0.5)
    f32 = np.float32
    got = linear_kl_coeff(step, f32(0.9) * f32(5000), f32(0.0001) * f32(5000), 0.0001, 0.5)
    assert got == float(ref), (got, float(ref))


def test_diagonal_gaussian_kl_matches_jax():
    """KL to N(0, I) summed over (C, H, W): within 1e-5 relative."""
    from ddmi_tpu.nn.distributions import DiagonalGaussian as JaxDG
    from ddmi_tpu_torch.nn.distributions import DiagonalGaussian

    m = np.random.default_rng(0).standard_normal((3, 6, 6, 8)).astype(np.float32) * 3
    ref = np.asarray(JaxDG.from_moments(jnp.asarray(m)).kl())
    got = DiagonalGaussian.from_moments(_nchw(m)).kl().numpy()
    assert _rel(got, ref) <= 1e-5


# ------------------------------------------------------------ INR sampling


@pytest.mark.parametrize("align", [False, True])
def test_grid_sample_2d_matches_jax(align):
    """grid_sample_2d with border padding, both align_corners settings, at
    points inside, on and beyond the border: within 1e-5 * max(1,
    max|ref|); the differentiable gather path agrees too."""
    from ddmi_tpu.ops.grid_sample import grid_sample_2d as jax_gs
    from ddmi_tpu_torch.ops.grid_sample import grid_sample_2d

    rng = np.random.default_rng(int(align))
    feat = rng.standard_normal((2, 9, 7, 5)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 40, 2)).astype(np.float32)
    grid[:, :4] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]
    ref = np.asarray(jax_gs(jnp.asarray(feat), jnp.asarray(grid), align_corners=align))
    got = grid_sample_2d(torch.from_numpy(feat), torch.from_numpy(grid), align_corners=align)
    tol = 1e-5 * max(1.0, np.abs(ref).max())
    assert np.abs(got.numpy() - ref).max() <= tol
    g = torch.from_numpy(grid).requires_grad_()
    assert np.abs(grid_sample_2d(torch.from_numpy(feat), g, align).detach().numpy()
                  - ref).max() <= tol


def _inr_pair(seed, ch=64, latent=8):
    from ddmi_tpu.core.config import MLPConfig
    from ddmi_tpu.nn.inr import INRImage as JaxINR
    from ddmi_tpu_torch.core.config import MLPConfig as TorchMLP
    from ddmi_tpu_torch.interop import mlp_image_from_jax
    from ddmi_tpu_torch.nn.inr import INRImage

    jm = JaxINR(MLPConfig(in_ch=2, out_ch=3, ch=ch, latent_dim=latent))
    pyr = [jnp.zeros((1, r, r, latent)) for r in (4, 8, 16)]
    k = jax.random.PRNGKey(seed)
    params = _randomize(jm.init({"params": k, "noise": k}, jnp.zeros((1, 5, 2)), pyr, 1.0)
                        ["params"], seed)
    tm = INRImage(TorchMLP(in_ch=2, out_ch=3, ch=ch, latent_dim=latent))
    tm.load_state_dict(mlp_image_from_jax(params, tm.cfg))
    return jm, params, tm


class _FeedNoise:
    """A flax interceptor that hands each NoiseInjection the next of the
    given draws, cast to its input's dtype, as the module casts its own."""

    def __init__(self, draws):
        self.draws = iter(draws)

    def __call__(self, next_fun, args, kwargs, context):
        from ddmi_tpu.nn.stylegan import NoiseInjection

        if isinstance(context.module, NoiseInjection) and context.method_name == "__call__":
            kwargs = dict(kwargs, noise=jnp.asarray(next(self.draws)).astype(args[0].dtype))
        return next_fun(*args, **kwargs)


def test_inr_image_at_arbitrary_coords_matches_jax():
    """INRImage at arbitrary points (the stage-1 path: coords (1, n, 2)
    broadcast over the batch, singleplane_pe) on JAX's weights with every
    zero-init leaf randomised and the same twelve NoiseInjection draws, at
    a scale of 1 / 1.5: outputs within 1e-5 * max(1, max|ref|), and the
    gradients with respect to the planes and the parameters (cosine,
    max|err|)."""
    from ddmi_tpu.nn.inr import singleplane_pe
    from ddmi_tpu_torch.ops.grid_sample import grid_sample_2d

    jm, params, tm = _inr_pair(0)
    rng = np.random.default_rng(5)
    pyr = [rng.standard_normal((2, r, r, 8)).astype(np.float32) for r in (4, 8, 16)]
    coords = rng.uniform(-1.05, 1.05, (1, 30, 2)).astype(np.float32)
    noise = [rng.standard_normal((2, 30, 1)).astype(np.float32) for _ in range(12)]
    si = float(np.float32(1 / 1.5))
    np.testing.assert_allclose(
        grid_sample_2d(torch.from_numpy(pyr[1]), torch.from_numpy(np.repeat(coords, 2, 0)),
                       align_corners=False).numpy(),
        np.asarray(singleplane_pe(jnp.asarray(pyr[1]), jnp.asarray(np.repeat(coords, 2, 0)))),
        rtol=0, atol=1e-5)

    def jax_fn(p, planes):
        with fnn.intercept_methods(_FeedNoise(noise)):
            return jm.apply({"params": p}, jnp.asarray(coords), planes, si)

    jpyr = [jnp.asarray(a) for a in pyr]
    ref_out = np.asarray(jax.jit(jax_fn)(params, jpyr))
    gp, gh = jax.jit(jax.grad(lambda p, h: jax_fn(p, h).sum() * 0.1, argnums=(0, 1)))(
        params, jpyr)
    planes = [_nchw(a).requires_grad_() for a in pyr]
    out = tm(planes, si, coords=torch.from_numpy(coords),
             generator=iter(torch.from_numpy(a) for a in noise))
    assert np.abs(out.detach().numpy() - ref_out).max() <= 1e-5 * max(1, np.abs(ref_out).max())
    (out.sum() * 0.1).backward()
    for t, r in zip(planes, gh):
        _grad_close(_nhwc(t.grad), r, "planes")
    from ddmi_tpu_torch.interop import mlp_image_from_jax

    ref_g = mlp_image_from_jax(jax.tree_util.tree_map(np.asarray, gp), tm.cfg)
    for k, p in tm.named_parameters():
        if np.abs(ref_g[k].numpy()).max() > 0:
            _grad_close(p.grad.numpy(), ref_g[k].numpy(), k)


# ----------------------------------------------------------------- the VAE


def test_linear_attention_vae_matches_jax():
    """A VAE with attn_type linear (LinAttnBlock at 8 x 8 and in both mid
    blocks) on JAX's weights (every zero-init leaf randomised): the
    posterior mean and logvar and every decoded HDBF plane within 1e-5 *
    max(1, max|ref|); and the block alone against JAX's LinAttnBlock."""
    from ddmi_tpu.core.config import DDConfig
    from ddmi_tpu.nn.vae import Autoencoder as JaxAE, LinAttnBlock as JaxLin
    from ddmi_tpu_torch.core.config import DDConfig as TorchDD
    from ddmi_tpu_torch.interop import vae_from_jax
    from ddmi_tpu_torch.nn.vae import Autoencoder, LinAttnBlock

    kw = dict(z_channels=8, resolution=16, out_ch=8, ch=32, ch_mult=(1, 2), num_res_blocks=1,
              attn_resolutions=(8,), hdbf_resolutions=(8,), attn_type="linear")
    jm = JaxAE(DDConfig(**kw), embed_dim=4)
    k = jax.random.PRNGKey(0)
    params = _randomize(jm.init({"params": k}, jnp.zeros((1, 16, 16, 3)), k)["params"], 1)
    assert "LinAttnBlock_0" in params["encoder"] and "LinAttnBlock_1" in params["decoder"]
    tm = Autoencoder(TorchDD(**kw), embed_dim=4)
    tm.load_state_dict(vae_from_jax(params, tm.cfg))
    x = np.random.default_rng(2).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    ref = jax.jit(lambda a: jm.apply({"params": params}, a, method=jm.encode))(jnp.asarray(x))
    with torch.no_grad():
        got = tm.encode(_nchw(x))
        for g, r in ((got.mean, ref.mean), (got.logvar, ref.logvar)):
            r = np.asarray(r)
            assert np.abs(_nhwc(g) - r).max() <= 1e-5 * max(1, np.abs(r).max())
        z = np.asarray(ref.mean)
        ref_h = jax.jit(lambda a: jm.apply({"params": params}, a, method=jm.decode))(
            jnp.asarray(z))
        for g, r in zip(tm.decode(_nchw(z)), ref_h):
            r = np.asarray(r)
            assert np.abs(_nhwc(g) - r).max() <= 1e-5 * max(1, np.abs(r).max())
    blk = JaxLin()
    h = np.random.default_rng(3).standard_normal((2, 5, 7, 32)).astype(np.float32)
    bp = _randomize(blk.init(k, jnp.zeros((1, 5, 7, 32)))["params"], 4)
    lin = LinAttnBlock(32)
    lin.load_state_dict({"to_qkv.weight": torch.from_numpy(
        np.transpose(bp["to_qkv"]["kernel"], (3, 2, 0, 1))),
        "to_out.weight": torch.from_numpy(np.transpose(bp["to_out"]["kernel"], (3, 2, 0, 1))),
        "to_out.bias": torch.from_numpy(bp["to_out"]["bias"])})
    r = np.asarray(blk.apply({"params": bp}, jnp.asarray(h)))
    with torch.no_grad():
        assert np.abs(_nhwc(lin(_nchw(h))) - r).max() <= 1e-5 * max(1, np.abs(r).max())


# ------------------------------------------------------- the SN regulariser


def _sn_vae():
    """A VAE whose groups hold several matrices (ten 3x3 convs of 32 -> 32
    and more), so that the order within a group matters, on JAX weights."""
    from ddmi_tpu.core.config import DDConfig
    from ddmi_tpu.nn.vae import Autoencoder as JaxAE
    from ddmi_tpu_torch.core.config import DDConfig as TorchDD
    from ddmi_tpu_torch.interop import vae_from_jax
    from ddmi_tpu_torch.nn.vae import Autoencoder

    kw = dict(z_channels=8, resolution=16, out_ch=8, ch=32, ch_mult=(1, 1, 2),
              num_res_blocks=2, attn_resolutions=(), hdbf_resolutions=(4, 8))
    jm = JaxAE(DDConfig(**kw), embed_dim=4)
    k = jax.random.PRNGKey(3)
    params = _randomize(jm.init({"params": k}, jnp.zeros((1, 16, 16, 3)), k)["params"], 5)
    tm = Autoencoder(TorchDD(**kw), embed_dim=4)
    tm.load_state_dict(vae_from_jax(params, tm.cfg))
    return params, tm


def test_spectral_norm_regulariser_matches_jax():
    """init_sn_state's groups and shapes equal JAX's; with JAX's (u, v)
    carried across, spectral_norm_loss's value within 1e-5 relative, its
    refreshed (u, v) within 1e-5 relative per group, and its gradient
    (and norm_scale_loss's) within the gradient bar; the port's own init,
    run from JAX's first draws, reaches JAX's (u, v) within 1e-4."""
    from ddmi_tpu.core.sn_reg import _collect_conv_mats, init_sn_state as jax_init
    from ddmi_tpu.core.sn_reg import norm_scale_loss as jax_ns
    from ddmi_tpu.core.sn_reg import spectral_norm_loss as jax_sn
    from ddmi_tpu_torch.core.sn_reg import (
        conv_matrices, init_sn_state, norm_scale_loss, spectral_norm_loss,
    )
    from ddmi_tpu_torch.interop import sn_state_from_jax, vae_from_jax

    params, tm = _sn_vae()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax.jit(jax_init)(jp, jax.random.PRNGKey(7))
    order = list(_collect_conv_mats(jp))  # JAX's group order (jit sorts the state's keys)
    assert order == list(conv_matrices(tm))
    assert max(len(m) for m in conv_matrices(tm).values()) >= 5
    mine = init_sn_state(tm, torch.Generator().manual_seed(0))
    for k, (u, v) in state.items():
        assert mine[k][0].shape == u.shape and mine[k][1].shape == v.shape

    def loss_fn(p):
        sn, new = jax_sn(p, state)
        return sn + jax_ns(p), new

    (ref, new), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    got, got_state = spectral_norm_loss(tm, sn_state_from_jax(state))
    total = got + norm_scale_loss(tm)
    assert abs(total.item() - float(ref)) <= 1e-5 * abs(float(ref))
    for k, (u, v) in new.items():
        assert _rel(got_state[k][0].numpy(), u) <= 1e-5 and _rel(got_state[k][1].numpy(), v) <= 1e-5
    total.backward()
    ref_g = vae_from_jax(jax.tree_util.tree_map(np.asarray, grads), tm.cfg)
    for k, p in tm.named_parameters():
        if np.abs(ref_g[k].numpy()).max() > 0:
            _grad_close(p.grad.numpy(), ref_g[k].numpy(), k)

    # the init's power iteration from JAX's own first draws
    rng = jax.random.PRNGKey(7)
    draws = []
    for key in order:
        rng, r1, r2 = jax.random.split(rng, 3)
        u0, v0 = state[key]
        draws += [torch.from_numpy(np.asarray(jax.random.normal(r1, u0.shape))),
                  torch.from_numpy(np.asarray(jax.random.normal(r2, v0.shape)))]
    own = init_sn_state(tm, draws=iter(draws))
    for k, (u, v) in state.items():
        assert _rel(own[k][0].numpy(), u) <= 1e-4 and _rel(own[k][1].numpy(), v) <= 1e-4


# ------------------------------------------------------------------ LPIPS


@pytest.mark.parametrize("bf16", [False, True])
def test_lpips_matches_jax(bf16):
    """LPIPS on random VGG weights (JAX's init, carried across; lin weights
    randomised) at 32 x 32: the distance per sample within 1e-5 relative in
    fp32 and 1e-2 with the trunk in bf16 on both sides; the fp32 gradient
    with respect to the second input within the gradient bar."""
    from ddmi_tpu.evals.lpips import LPIPS as JaxLPIPS
    from ddmi_tpu_torch.evals.lpips import LPIPS
    from ddmi_tpu_torch.interop import lpips_from_jax

    dt = jnp.bfloat16 if bf16 else jnp.float32
    jm = JaxLPIPS(dtype=dt)
    x0 = jnp.zeros((1, 32, 32, 3))
    params = jm.init(jax.random.PRNGKey(0), x0, x0)["params"]
    rng = np.random.default_rng(1)
    params = dict(jax.tree_util.tree_map(np.asarray, params))
    for i in range(5):
        params[f"lin{i}"] = rng.uniform(0.1, 1.0, params[f"lin{i}"].shape).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(x.shape), -1, 1).astype(np.float32)
    tm = LPIPS(dtype=torch.bfloat16 if bf16 else torch.float32)
    tm.load_state_dict(lpips_from_jax(params))
    fn = jax.jit(lambda b: jm.apply({"params": params}, jnp.asarray(x), b).sum())
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(y)))
    yt = torch.from_numpy(y).requires_grad_()
    got = tm(torch.from_numpy(x), yt)
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert _rel(got.detach().numpy(), ref) <= (1e-2 if bf16 else 1e-5)
    if not bf16:
        got.sum().backward()
        _grad_close(yt.grad.numpy(), jax.jit(jax.grad(fn))(jnp.asarray(y)), "d lpips / d y")


def test_build_perceptual_without_weights_warns_and_loads_a_file(tmp_path):
    """Without data.extra.lpips_pth the VGG is random and a warning says so;
    with a file (here the port's own state in the reference layout) its
    weights load, the trunk in bf16 under model.amp."""
    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.evals.lpips import LPIPS, build_perceptual

    cfg = config_from_dict({"model": {"amp": True}, "data": {"domain": "image"}})
    with pytest.warns(UserWarning, match="LPIPS weights not found"):
        m = build_perceptual(cfg, "cpu")
    assert m.net.features[0].weight.dtype == torch.bfloat16
    src = LPIPS()
    sd = {k.replace("net.", "", 1): v for k, v in src.state_dict().items()}
    sd["lin0.model.1.weight"] = torch.full_like(sd["lin0.model.1.weight"], 0.5)
    torch.save(sd, tmp_path / "vgg.pth")
    cfg = config_from_dict({"model": {"amp": False},
                            "data": {"domain": "image",
                                     "extra": {"lpips_pth": str(tmp_path / "vgg.pth")}}})
    m = build_perceptual(cfg, "cpu")
    assert torch.equal(m.net.features[28].weight, src.net.features[28].weight)
    assert torch.equal(m.lin0.model[1].weight, sd["lin0.model.1.weight"])


# ---------------------------------------------------------------- the GAN


def test_patchgan_losses_match_jax():
    """GANLoss2D (hinge, disc_weight 0.5) with the scale channel at 32 x 32
    on JAX's weights (scale offsets and biases randomised): the generator
    and discriminator losses within 1e-5 relative, the generator loss's
    gradient with respect to the reconstructions and the discriminator
    loss's with respect to the discriminator's parameters within the
    gradient bar; the train-mode batch norm holds no running statistics."""
    from ddmi_tpu.losses.gan import GANLoss2D as JaxGAN
    from ddmi_tpu_torch.interop import discriminator_from_jax
    from ddmi_tpu_torch.losses.gan import GANLoss2D

    jm = JaxGAN(disc_weight=0.5)
    d0 = jnp.zeros((1, 32, 32, 3))
    params = _randomize(jm.init(jax.random.PRNGKey(11), d0, d0, False, 1.0)["params"], 2, 0.02)
    tm = GANLoss2D(3, disc_weight=0.5)
    tm.load_state_dict(discriminator_from_jax(params))
    assert not list(tm.buffers())
    rng = np.random.default_rng(3)
    x, r = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    scale = 0.5
    g_ref, g_grad = jax.jit(jax.value_and_grad(
        lambda rr: jm.apply({"params": params}, jnp.asarray(x), rr, True, scale)))(
        jnp.asarray(r))
    d_ref, d_grad = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(r), False, scale)))(
        jax.tree_util.tree_map(jnp.asarray, params))
    rt = torch.from_numpy(r).requires_grad_()
    g = tm.generator_loss(torch.from_numpy(x), rt, scale)
    assert abs(g.item() - float(g_ref)) <= 1e-5 * abs(float(g_ref))
    g.backward()
    _grad_close(rt.grad.numpy(), g_grad, "d g_loss / d recon")
    tm.zero_grad()
    d = tm.discriminator_loss(torch.from_numpy(x), rt, scale)
    assert abs(d.item() - float(d_ref)) <= 1e-5 * abs(float(d_ref))
    d.backward()
    ref_g = discriminator_from_jax(jax.tree_util.tree_map(np.asarray, d_grad))
    top = max(float(np.abs(g.numpy()).max()) for g in ref_g.values())
    for k, p in tm.named_parameters():
        if k in ("discriminator.convs.1.bias", "discriminator.convs.2.bias",
                 "discriminator.convs.3.bias"):
            # a bias just before a batch norm cannot change the loss: its
            # gradient is roundoff on both sides
            assert np.abs(p.grad.numpy()).max() <= 1e-5 * top, k
        else:
            _grad_close(p.grad.numpy(), ref_g[k].numpy(), k)


@pytest.mark.parametrize("policy", [("color",), ("translation",), ("cutout",),
                                    ("color", "translation", "cutout")])
def test_diffaugment_matches_jax_on_its_draws(policy):
    """diff_augment on the draws JAX's diff_augment makes from its key (the
    same splits), on 2 x 16 x 12 x 3 images: within 1e-6 * max(1,
    max|ref|)."""
    from ddmi_tpu.losses.diffaugment import diff_augment as jax_da
    from ddmi_tpu_torch.losses.diffaugment import diff_augment

    x = np.random.default_rng(0).uniform(-1, 1, (2, 16, 12, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    ref = np.asarray(jax_da(jnp.asarray(x), rng, policy=policy))
    draws, b, h, w = [], 2, 16, 12
    steps = {"color": 3, "translation": 1, "cutout": 1}
    for p in policy:
        for s in range(steps[p]):
            rng, sub = jax.random.split(rng)
            if p == "color":
                draws.append(torch.from_numpy(np.asarray(
                    jax.random.uniform(sub, (b, 1, 1, 1))).reshape(b)))
            elif p == "translation":
                r1, r2 = jax.random.split(sub)
                sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
                draws.append(tuple(torch.from_numpy(np.asarray(a)).long() for a in (
                    jax.random.randint(r1, (b,), -sh, sh + 1),
                    jax.random.randint(r2, (b,), -sw, sw + 1))))
            else:
                r1, r2 = jax.random.split(sub)
                ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
                draws.append(tuple(torch.from_numpy(np.asarray(a)).long().reshape(b) for a in (
                    jax.random.randint(r1, (b, 1, 1), 0, h + (1 - ch % 2)),
                    jax.random.randint(r2, (b, 1, 1), 0, w + (1 - cw % 2)))))
    got = diff_augment(torch.from_numpy(x), policy, draws).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max())


def test_diffaugment_draws_are_in_range():
    from ddmi_tpu_torch.losses.diffaugment import draw_diffaugment

    g = torch.Generator().manual_seed(1)
    d = draw_diffaugment((64, 16, 12, 3), ("color", "translation", "cutout"), g)
    assert len(d) == 5 and all(0 <= float(u.min()) and float(u.max()) < 1 for u in d[:3])
    (tx, ty), (cy, cx) = d[3], d[4]
    assert tx.abs().max() <= 2 and ty.abs().max() <= 2 and tx.abs().max() == 2
    assert cy.min() >= 0 and cy.max() <= 16 and cx.min() >= 0 and cx.max() <= 12


# ---------------------------------------------------------------- optimizers


@pytest.mark.parametrize("cosine", [True, False])
def test_schedules_match_optax(cosine):
    """warmup_cosine_decay_schedule and linear_schedule against optax at
    every count through the end of the decay: within 1e-6 relative to the
    peak (fp32, cos in another library)."""
    from ddmi_tpu_torch.core.optim import linear_schedule, warmup_cosine_decay_schedule

    if cosine:
        mine, ref = (warmup_cosine_decay_schedule(0.0, 3e-4, 7, 40),
                     optax.warmup_cosine_decay_schedule(0.0, 3e-4, 7, 40))
    else:
        mine, ref = linear_schedule(0.0, 3e-4, 7), optax.linear_schedule(0.0, 3e-4, 7)
    for c in range(0, 45):
        assert abs(mine(c) - float(ref(jnp.int32(c)))) <= 1e-6 * 3e-4, c
    assert mine(0) == 0.0


@pytest.mark.parametrize("lr_scheduler", [True, False])
def test_stage1_optimizer_matches_optax_with_accumulation(lr_scheduler):
    """stage1_adamw (fp32 mu, MultiSteps k = 3, the warm-up schedule from 0)
    against ImagePipeline.stage1_optimizer's optax chain over 12 micro-steps
    of random gradients: the parameters are bit-unchanged through
    micro-step 5 (the inner optimizer's first update has rate 0) and change
    at 6, 9 and 12 only, while the moments change at 3; parameters,
    moments and accumulator within 1e-5 relative at every micro-step."""
    from ddmi_tpu.core.config import config_from_dict as jax_cfg
    from ddmi_tpu.domains.image import ImagePipeline as JaxPipe
    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.core.optim import stage1_adamw

    d = {"model": {"lr": 2e-3, "params": {"lossconfig": dict(
        gradient_accumulate_every=3, epochs=4, warmup_epochs=1, lr_scheduler=lr_scheduler)}},
        "data": {"domain": "image"}}
    spe = 9
    tx = JaxPipe(jax_cfg(d)).stage1_optimizer(spe)
    rng = np.random.default_rng(0)
    shapes = [(4, 3, 3, 3), (7,), (5, 6)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = stage1_adamw(config_from_dict(d), tp, spe)
    assert opt.inner.mu[0].dtype == torch.float32
    prev = [p.clone() for p in tp]
    for step in range(1, 13):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.from_numpy(g) for g in grads])
        changed = any(not torch.equal(a, b) for a, b in zip(tp, prev))
        assert changed == (step % 3 == 0 and step > 3), step
        prev = [p.clone() for p in tp]
        for a, b in zip(tp, jp):
            assert _rel(a.numpy(), b) <= 1e-5, step
        inner = state.inner_opt_state[0]
        for a, b in zip(opt.inner.mu + opt.inner.nu, list(inner.mu) + list(inner.nu)):
            assert _rel(a.numpy(), b) <= 1e-5 or not np.any(np.asarray(b)), step
        for a, b in zip(opt.acc, state.acc_grads):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6, step
    assert opt.inner.count == 4 and int(state.gradient_step) == 4


def test_disc_optimizer_matches_optax():
    """The discriminator's AdamW (b1 0.5, b2 0.9, constant lr, fp32 mu, no
    accumulation) changes the parameters at every step, within 1e-5
    relative of optax over 6 steps."""
    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.core.optim import disc_adamw

    cfg = config_from_dict({"model": {"lr": 1e-3}})
    tx = optax.adamw(1e-3, b1=0.5, b2=0.9, weight_decay=0.0)
    rng = np.random.default_rng(1)
    p = rng.standard_normal((6, 5)).astype(np.float32)
    jp, tp = jnp.asarray(p), [torch.from_numpy(p.copy())]
    opt, state = disc_adamw(cfg, tp), tx.init(jnp.asarray(p))
    for _ in range(6):
        g = rng.standard_normal((6, 5)).astype(np.float32)
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        before = tp[0].clone()
        opt.update(tp, [torch.from_numpy(g)])
        assert not torch.equal(before, tp[0])
        assert _rel(tp[0].numpy(), jp) <= 1e-5


def test_port_config_reader_matches_jax_on_the_d2c_vae_configs():
    """The port's reader gives the JAX package's values for every loss field
    it reads, and for ddconfig and mlpconfig, on the celebahq stage-1
    configs."""
    import dataclasses

    from ddmi_tpu.core.config import load_config as jax_load
    from ddmi_tpu_torch.core.config import load_config

    for name in ("d2c-vae/celebahq.yaml", "d2c-vae/celebahq_gan.yaml"):
        path = os.path.join(ROOT, "configs", name)
        ours, ref = load_config(path), jax_load(path)
        for sub in ("lossconfig", "ddconfig", "mlpconfig"):
            a, b = getattr(ours.model, sub), getattr(ref.model, sub)
            for f in dataclasses.fields(a):
                if f.name != "extra":
                    assert getattr(a, f.name) == getattr(b, f.name), (name, sub, f.name)
        assert (ours.model.lr, ours.model.amp, ours.data.batch_size) == (
            ref.model.lr, ref.model.amp, ref.data.batch_size)
        assert ours.data.save_pth == ref.data.save_pth
