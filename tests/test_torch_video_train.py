"""Video training of the PyTorch port against the JAX package, on the CPU,
at a small config: clips of 4 frames at 32 x 32 (batch 2), a TimeSformer
of width 64 (the module's own depth 8, 8 heads of 64), pooling
transformers of width 64, a decoder at ch 64 (ch_mult [1, 1, 2, 2], so
each GroupNorm group holds more than one channel under amp) with the
cross-plane attention at every level, an INR of width 64, and a
TriplaneUNet at 32 channels.  The weights (every zero-init leaf
randomised), the spectral-norm vectors, the discriminators and LPIPS's
random VGG are JAX's, carried by ddmi_tpu_torch/interop.py; every draw of
a micro-step (the three posteriors' eps, the LPIPS and GAN frames, t and
the diffusion noise) is derived from JAX's own keys and fed to the port.

Here: the VAE's encode and forward, the SN regulariser over the video
VAE, the stage-1 loss and its gradients (fp32 and amp), reconstruction,
and the stage-2 loss and its gradients.  tests/test_torch_video_modules.py
holds the TimeSformer's modules, the MEA, the 1D attention block under
autograd, GANLoss3D and SyntheticVideos; tests/test_torch_video_steps.py
runs accumulation windows of the train steps; and
tests/test_torch_video_trainer.py the trainer, the eval hooks, the MEA's
saved memory and a run that never loads JAX.

Tolerances: fp32 values within 1e-4 relative (1e-5 for losses) and
gradients with a cosine >= 0.99999 and max|err| <= 1e-4 * max|ref| (sums
in other orders); under model.amp (bf16 on both sides, roundings in other
orders) the loss within 1e-2 relative, the gradient cosine >= 0.999 and
max|err| <= 0.1 * max|ref|, with the bf16 compute dtypes checked layer by
layer.  SyntheticVideos and the bridge are bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.interop import (
    discriminator3d_from_jax, lpips_from_jax, mlp_video_from_jax, sn_state_from_jax,
    video_vae_from_jax,
)

torch.set_num_threads(1)

B, T, RES, R, E, SPE = 2, 4, 32, 4, 4, 4


def _cfg(amp=False, adversarial=False, **loss):
    lc = dict(gradient_accumulate_every=2, epochs=4, warmup_epochs=1, adversarial=adversarial,
              save_and_sample_every=1, disc_weight=0.5, **loss)
    return {
        "seed": 3,
        "model": {"use_fp16": amp, "amp": amp, "lr": 1e-3, "embed_dim": E, "params": {
            "lossconfig": lc,
            "ddconfig": dict(double_z=True, timesformer_channels=64, splits=1, patch_size=8,
                             resolution=RES, z_channels=8, in_channels=3, out_ch=8, ch=64,
                             ch_mult=[1, 1, 2, 2], num_res_blocks=1, attn_resolutions=[],
                             hdbf_resolutions=[8, 16], inter_attn_resolutions=[4, 8, 16, 32],
                             attn_type="vanilla-multihead"),
            "mlpconfig": dict(in_ch=2, out_ch=3, ch=64, latent_dim=8),
            "unetconfig": dict(triplane=True, in_channels=E, model_channels=32, out_channels=E,
                               attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
                               num_head_channels=32),
            "ddpmconfig": dict(image_size=R, channels=E, sampling_timesteps=4)}},
        "data": {"domain": "video", "batch_size": B, "frames": T, "test_resolution": RES},
    }


def _np(t):
    return t.detach().float().numpy()


def jit_optimized(fn):
    """jax.jit(fn), compiled once per argument signature with XLA's CPU
    backend optimisations on.  tests/conftest.py turns them off for the
    whole suite, which makes compiles quick but leaves XLA's CPU
    convolutions (the 3D ones above all) about ten times slower to run: a
    train step these tests run several times pays for its optimised
    compile.  The program is the same; only its machine code differs."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = (jax.tree_util.tree_structure(args), tuple(
            (np.shape(a), jnp.result_type(a), getattr(a, "weak_type", False))
            for a in jax.tree_util.tree_leaves(args)))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options={
                "xla_backend_optimization_level": 2,
                "xla_llvm_disable_expensive_passes": False})
        return compiled[key](*args)

    return call


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _randomize(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(np.shape(a))).astype(np.float32)
        if not np.any(np.asarray(a)) else np.asarray(a, np.float32), tree)


def _random_tree(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


def _nchw(a):
    """JAX channel-last (b, h, w, c) -> port NCHW (b, c, h, w)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def _video(seed, b=B):
    return np.random.default_rng(seed).random((b, T, RES, RES, 3)).astype(np.float32)


def jax_eps(rng_post, b=B):
    """The eps JAX's VideoAutoencoder draws from its key, port layout."""
    r1, r2, r3 = jax.random.split(rng_post, 3)
    return tuple(_nchw(jax.random.normal(k, s, jnp.float32))
                 for k, s in ((r1, (b, R, R, E)), (r2, (b, T, R, E)), (r3, (b, T, R, E))))


def stage1_draws(rng, adversarial=False):
    """The draws JAX's stage-1 step makes from its key, for the port; ->
    (draws, the key JAX's stage1_loss is called with)."""
    from ddmi_tpu_torch.domains.video import VideoDraws

    gan = None
    if adversarial:
        rng, rng_f = jax.random.split(rng)
        gan = torch.from_numpy(np.asarray(jax.random.randint(rng_f, (B,), 0, T))).long()
    rng_post, rng_frame = jax.random.split(rng)
    fi = torch.from_numpy(np.asarray(jax.random.randint(rng_frame, (B,), 0, T))).long()
    return VideoDraws(jax_eps(rng_post), fi, gan), rng


class Setup:
    """A JAX VideoPipeline and the port's on the same state: JAX's stage-1
    state (zero leaves randomised, the pre_* moments layers scaled by 0.1,
    the SN vectors drawn for these weights) with LPIPS on a random VGG.  The scaling keeps the posterior's
    logvar within about +-1, as in a trained VAE: at the random init it
    reaches +-11, where one bf16 rounding of it moves the std by up to 3%,
    so that JAX's own amp loss lies 3.4% from its fp32 loss.  With `base` (a
    Setup of the same config but for amp) its JAX parameters, LPIPS
    parameters and SN state are taken, whose values amp does not change,
    and JAX's inits are not compiled and run again."""

    def __init__(self, amp=False, adversarial=False, perceptual=True, base=None, **loss):
        from ddmi_tpu.core.sn_reg import init_sn_state
        from ddmi_tpu.domains.image import Stage1State
        from ddmi_tpu.domains.video import VideoPipeline as JaxPipe
        from ddmi_tpu.evals.lpips import LPIPS as JaxLPIPS, PerceptualLoss
        from ddmi_tpu_torch.domains.video import VideoPipeline
        from ddmi_tpu_torch.evals.lpips import LPIPS

        d = _cfg(amp, adversarial, **loss)
        self.d = d
        jcfg, cfg = jax_config(d), config_from_dict(d)
        self.pp, pfn = None, None
        if perceptual:
            lp = JaxLPIPS(dtype=jnp.bfloat16 if amp else jnp.float32)
            x0 = jnp.zeros((1, 32, 32, 3))
            self.pp = base.pp if base is not None else jax.jit(lp.init)(
                jax.random.PRNGKey(5), x0, x0)["params"]
            pfn = PerceptualLoss(lambda p, t, o: lp.apply({"params": p}, t, o), self.pp)
        self.jpipe = JaxPipe(jcfg, perceptual_fn=pfn)
        self.jpipe._stage1_total_iters = SPE * d["model"]["params"]["lossconfig"]["epochs"]
        if base is not None:
            params = base.jstate.params
        else:
            # JAX's init_stage1, with its inits compiled (eager flax init of
            # the depth-8 TimeSformer takes most of a minute on the CPU)
            params = _randomize(jax.jit(self.jpipe.init_stage1_params)(jax.random.PRNGKey(0)), 1)
            for plane in ("xy", "xt", "yt"):
                params["vae"][f"pre_{plane}"] = jax.tree_util.tree_map(
                    lambda a: a * 0.1, params["vae"][f"pre_{plane}"])
        disc = disc_opt = None
        if adversarial:
            dummy = jnp.zeros((1, T, 32, 32, 3))
            disc = _randomize(jax.jit(lambda k: self.jpipe.gan.init(k, dummy, dummy, False))(
                jax.random.PRNGKey(11))["params"], 2, 0.02)
            disc_opt = self.jpipe.disc_optimizer().init(disc)
        self.tx = self.jpipe.stage1_optimizer(SPE)
        sn_state = (base.jstate.sn_state if base is not None
                    else jax.jit(init_sn_state)(params["vae"], jax.random.PRNGKey(7)))
        st = Stage1State(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=self.tx.init(params), sn_state=sn_state,
                         disc_params=disc, disc_opt_state=disc_opt)
        self.jstate = jax.tree_util.tree_map(jnp.asarray, st)
        lpips = None
        if perceptual:
            lpips = LPIPS(dtype=torch.bfloat16 if amp else torch.float32)
            lpips.load_state_dict(lpips_from_jax(jax.tree_util.tree_map(np.asarray, self.pp)))
        self.pipe = VideoPipeline(cfg, device="cpu", seed=0, perceptual=lpips)
        p = jax.tree_util.tree_map(np.asarray, st.params)
        self.cfg = cfg
        self.pipe.load_state_dicts(vae=video_vae_from_jax(p["vae"], cfg.model.ddconfig),
                                   mlp=mlp_video_from_jax(p["mlp"]))
        self.state = self.pipe.init_stage1(SPE)
        self.state.sn = sn_state_from_jax(jax.tree_util.tree_map(np.asarray, st.sn_state))
        if adversarial:
            self.pipe.gan.load_state_dict(discriminator3d_from_jax(
                jax.tree_util.tree_map(np.asarray, st.disc_params)))

    def port_names(self, tree):
        """A JAX {'vae', 'mlp'} tree -> {port parameter name: array}."""
        tree = jax.tree_util.tree_map(np.asarray, tree)
        out = {f"vae.{k}": v.numpy()
               for k, v in video_vae_from_jax(tree["vae"], self.cfg.model.ddconfig).items()}
        out.update({f"mlp.{k}": v.numpy() for k, v in mlp_video_from_jax(tree["mlp"]).items()})
        return out


@pytest.fixture(scope="module")
def s32():
    """The fp32 Setup the tests below share (JAX's init and compiles are
    most of this file's time)."""
    return Setup()


def grad_check(got, ref, cos_min=0.99999, err_max=1e-4):
    names = sorted(ref)
    assert sorted(got) == names
    g = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in names])
    r = np.concatenate([np.asarray(ref[k], np.float64).ravel() for k in names])
    cos = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r)))
    err = float(np.abs(g - r).max() / np.abs(r).max())
    assert cos >= cos_min and err <= err_max, (cos, err)
    return cos, err


# ---------------------------------------------------------------- the VAE


def test_video_vae_encode_and_forward_match_jax(s32):
    """VideoAutoencoder.encode -> the (xy, yt, xt) posteriors' means and
    logvars (the class token appended last and read at position 0; 'yt'
    pools h, 'xt' pools w; the moments split NCHW), and the forward on
    JAX's eps -> the three decoded pyramids [xy | xt | yt], all within 1e-4
    relative of JAX's."""
    jm, p, tm = s32.jpipe.vae, s32.jstate.params["vae"], s32.pipe.vae
    x = jnp.asarray(_video(3) * 2 - 1)
    rng = jax.random.PRNGKey(7)
    posts = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=jm.encode))(p, x)
    dec, _ = jax.jit(lambda p, x: jm.apply({"params": p}, x, rng, sample_posterior=True))(p, x)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(np.asarray(x)))
        assert [tuple(g.mean.shape) for g in got] == [(B, E, R, R), (B, E, T, R), (B, E, T, R)]
        for g, r in zip(got, posts):
            assert _rel(_np(g.mean), np.transpose(np.asarray(r.mean), (0, 3, 1, 2))) <= 1e-4
            assert _rel(_np(g.logvar), np.transpose(np.asarray(r.logvar), (0, 3, 1, 2))) <= 1e-4
        out, _ = tm(torch.from_numpy(np.asarray(x)), jax_eps(rng))
    for gp, rp in zip(out, dec):
        for g, r in zip(gp, rp):
            assert _rel(_np(g), np.transpose(np.asarray(r), (0, 3, 1, 2))) <= 1e-4


def test_sn_regulariser_over_the_video_vae_matches_jax(s32):
    """The spectral-norm groups of the video VAE (the 4-D conv kernels of
    JAX's tree in its sorted path order; no Dense kernel), the (u, v) JAX's
    init_sn_state draws, one spectral_norm_loss evaluation (sum and
    refreshed (u, v)) and norm_scale_loss over every GroupNorm scale (the
    decoder's and each 1D attention's): within 1e-5 relative."""
    from ddmi_tpu.core import sn_reg as jsn
    from ddmi_tpu_torch.core import sn_reg

    p, tm = s32.jstate.params["vae"], s32.pipe.vae
    state = jsn.init_sn_state(p, jax.random.PRNGKey(7))
    groups = sn_reg.conv_matrices(tm)
    ref_groups = jsn._collect_conv_mats(p)
    assert list(groups) == list(ref_groups)
    for key, mats in groups.items():
        assert len(mats) == len(ref_groups[key])
        for a, b in zip(mats, ref_groups[key]):
            assert np.array_equal(_np(a), np.asarray(b)), key
    loss, new = jsn.spectral_norm_loss(p, state)
    got, got_new = sn_reg.spectral_norm_loss(tm, sn_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state)))
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    for k, (u, v) in new.items():
        assert _rel(_np(got_new[k][0]), u) <= 1e-5 and _rel(_np(got_new[k][1]), v) <= 1e-5
    scales = [path for path, _ in jax.tree_util.tree_leaves_with_path(p)
              if path[-1].key == "scale" and "GroupNorm" in path[-2].key]
    assert sum(1 for _, _, kind in tm.jax_layout() if kind == "gn") == len(scales)
    ref_scale = float(jsn.norm_scale_loss(p))
    assert abs(sn_reg.norm_scale_loss(tm).item() - ref_scale) <= 1e-5 * abs(ref_scale)


# ---------------------------------------------------------------- stage 1


@pytest.mark.parametrize("amp", [False, True])
def test_stage1_loss_and_gradients_match_jax(amp, s32):
    """stage1_loss at micro-step 1 (encode, three posterior samples,
    decode, the per-frame INR render under checkpoints, L1 over the clip,
    the summed KL, LPIPS on the drawn frames, the SN regulariser) and its
    gradients against jax.value_and_grad of VideoPipeline.stage1_loss on
    the same weights, SN state and draws, on two keys (one under amp: the
    keys change only the draws); each term checked, and the refreshed SN
    vectors.  Under amp the policy is checked too:
    every layer of the VAE that holds a weight sees a bf16 weight and bf16
    inputs (the rotary's fp32 promotion is inside the attention, not at a
    layer's input), and the gradients land on the fp32 masters."""
    s = Setup(amp=True, base=s32) if amp else s32
    jp, pipe = s.jpipe, s.pipe
    loss_bar, cos_min, err_max = (1e-2, 0.999, 0.1) if amp else (1e-5, 0.99999, 1e-4)
    step = 1
    seen, hooks = {}, []

    def record(mod, args, kwargs):
        weights = {p.dtype for p in mod.parameters(recurse=False) if p.dim() >= 2}
        inputs = {t.dtype for t in (*args, *kwargs.values())
                  if torch.is_tensor(t) and t.is_floating_point()}
        seen.setdefault(mod, set()).update(weights | inputs)

    if amp:
        hooks = [m.register_forward_pre_hook(record, with_kwargs=True)
                 for m in pipe.vae.modules()
                 if any(p.dim() >= 2 for p in m.parameters(recurse=False))]

    def loss_fn(p, x, rng):
        return jp.stage1_loss(p, s.jstate.sn_state, x, rng, jnp.int32(step), s.pp)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    for key in (0,) if amp else (0, 1):
        x = _video(20 + key)
        rng = jax.random.PRNGKey(key)
        (ref, (metrics, new_sn, _)), grads = grad_fn(s.jstate.params, jnp.asarray(x), rng)
        draws, _ = stage1_draws(rng)
        loss, got, sn, _ = pipe.stage1_loss(torch.from_numpy(x), step, draws, s.state.sn)
        for k in ("recon", "kl", "lpips", "sn"):
            r = float(metrics[k])
            assert abs(float(got[k]) - r) <= loss_bar * abs(r), (key, k, float(got[k]), r)
        assert got["kl_coeff"] == float(metrics["kl_coeff"])
        assert abs(loss.item() - float(ref)) <= loss_bar * abs(float(ref)), (key, loss.item())
        loss.backward()
        params = s.state.params
        if amp:
            assert seen and all(d == {torch.bfloat16} for d in seen.values()), [
                (type(m).__name__, d) for m, d in seen.items() if d != {torch.bfloat16}]
            assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                       for p in params.values())
        grad_check({k: p.grad.numpy() for k, p in params.items()}, s.port_names(grads),
                   cos_min, err_max)
        for p in params.values():
            p.grad = None
        if not amp:
            for k, (u, v) in new_sn.items():
                assert _rel(_np(sn[k][0]), u) <= 1e-5 and _rel(_np(sn[k][1]), v) <= 1e-5
    for h in hooks:
        h.remove()


def test_reconstruct_matches_jax(s32):
    """reconstruct of 2 clips on JAX's posterior eps (fp32): within 1e-4 of
    JAX's pixels, in [0, 1]."""
    s = s32
    params = jax.tree_util.tree_map(np.asarray, s.jstate.params)
    x = _video(30)
    rng = jax.random.PRNGKey(9)
    ref = np.asarray(jax.jit(lambda p, a: s.jpipe.reconstruct(p, a, rng))(params, jnp.asarray(x)))
    got = s.pipe.reconstruct(torch.from_numpy(x), eps=jax_eps(rng))
    assert got.shape == (B, T, RES, RES, 3) and ref.shape == got.shape
    assert float(np.abs(_np(got) - ref).max()) <= 1e-4
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


# ---------------------------------------------------------------- stage 2


def stage2_setup(s):
    """JAX's stage-2 state (zero leaves randomised) beside the stage-1
    params of Setup `s`, and a port pipeline on both (a fresh one, as
    init_stage2 freezes the VAE) -> (JAX state, port pipeline, its state)."""
    from ddmi_tpu_torch.domains.video import VideoPipeline
    from ddmi_tpu_torch.interop import triplane_unet_from_jax

    st2 = jax.jit(lambda k: s.jpipe.init_stage2(k, SPE))(jax.random.PRNGKey(4))
    params = _randomize(st2.params, 12)
    st2 = st2.replace(params=params, ema_params=params)
    p = jax.tree_util.tree_map(np.asarray, params)
    pipe = VideoPipeline(s.cfg, device="cpu", seed=1)
    pipe.load_state_dicts(unet=triplane_unet_from_jax(p["unet"], s.jpipe.unet.cfg),
                          vae=s.pipe.vae.state_dict(), mlp=s.pipe.mlp.state_dict(),
                          mixing_logit=p["mixing_logit"])
    return jax.tree_util.tree_map(jnp.asarray, st2), pipe, pipe.init_stage2()


def stage2_draws(rng):
    """(eps, t, noise) JAX's stage2_loss draws from its key, port layout."""
    rng_enc, rng_diff = jax.random.split(rng)
    rng_t, rng_n = jax.random.split(rng_diff)
    n = R * R + 2 * T * R
    t = torch.from_numpy(np.asarray(jax.random.randint(rng_t, (B,), 0, 1000))).long()
    noise = torch.from_numpy(np.asarray(jax.random.normal(rng_n, (B, n, E), jnp.float32)))
    return jax_eps(rng_enc), t, noise


def unet_grads(pipe_unet_cfg, tree):
    from ddmi_tpu_torch.interop import triplane_unet_from_jax

    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    out = {f"unet.{k}": v.numpy()
           for k, v in triplane_unet_from_jax(tree["unet"], pipe_unet_cfg).items()}
    out["mixing_logit"] = np.asarray(tree["mixing_logit"])
    return out


def test_stage2_loss_and_gradients_match_jax(s32):
    """stage2_loss (the frozen encode sampled xy, yt, xt with keys r1, r2,
    r3 and laid out [xy | xt | yt], then the diffusion loss through the
    TriplaneUNet with the fp32 (1, 1, C) mixing logit) and its gradients
    against jax.value_and_grad, fp32: loss within 1e-5 relative, gradient
    cosine >= 0.99999."""
    s = s32
    jst, pipe, state = stage2_setup(s)
    p1 = s.jstate.params
    x = _video(40)
    rng = jax.random.PRNGKey(3)
    z_ref = jax.jit(s.jpipe.encode_latents)(p1, jnp.asarray(x), jax.random.split(rng)[0])
    (ref, _), grads = jax.jit(jax.value_and_grad(s.jpipe.stage2_loss, has_aux=True))(
        jst.params, p1, jnp.asarray(x), rng)
    eps, t, noise = stage2_draws(rng)
    z = pipe.encode_latents(torch.from_numpy(x), eps)
    assert _rel(_np(z), np.asarray(z_ref)) <= 1e-4
    loss, _ = pipe.stage2_loss(torch.from_numpy(x), t=t, noise=noise, eps=eps)
    assert abs(loss.item() - float(ref)) <= 1e-5 * abs(float(ref))
    loss.backward()
    assert state.params["mixing_logit"].dtype == torch.float32
    grad_check({k: p.grad.numpy() for k, p in state.params.items()},
               unet_grads(s.jpipe.unet.cfg, grads))
