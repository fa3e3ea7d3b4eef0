"""Occupancy training of the PyTorch port against the JAX package, on the
CPU, at the JAX tests' tiny config (tests/test_occupancy.py): planes of
32^2 from a pointnet of width 32 (3 blocks), a triplane VAE at ch 32
(ch_mult [1, 2, 4], the cross-plane blocks at 32^2 and 16^2, HDBF taps at
8^2 and 16^2), an INR3D of width 64, batches of 2 shapes with 300-point
clouds and 256 query points.  The weights are seeded random draws of JAX's
shapes (no leaf zero), carried by ddmi_tpu_torch/interop.py; every draw
of a micro-step (the three posteriors' eps, t and the diffusion noise) is
derived from JAX's own keys and fed to the port.

Here: the triplane VAE's spectral-norm layout and state, the stage-1 loss
and its gradients (fp32 and amp), three micro-steps with accumulation over
2 against optax, and the stage-2 loss.  tests/test_torch_occupancy_trainer.py
holds the loaders, the pointnet's gradients, the trainer and the eval
hooks; tests/test_torch_nerf_train.py the NeRF domain.  Both read this
file's helpers.

Tolerances: fp32 loss terms within 1e-5 relative, gradients within 1e-4
relative per tensor (sums in other orders; see check_grads for the
tensors whose gradient is zero up to roundoff); under model.amp (bf16 on
both sides, roundings in other orders, and the plane samples blended in
fp32 where JAX blends them in bf16) the terms within 1e-2 relative and the
gradient cosines >= 0.999, or as near as JAX's own amp gradient comes to
its fp32 one (check_grads); the loaders bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.interop import (
    mlp3d_from_jax, pointnet_from_jax, triplane_vae_from_jax, unet_from_jax,
)

torch.set_num_threads(1)

B, N_PTS, N_CLOUD, SPE = 2, 256, 300, 4
DD = dict(double_z=True, z_channels=32, resolution=32, in_channels=8, out_ch=8, ch=32,
          ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[],
          hdbf_resolutions=[8, 16], inter_attn_resolutions=[32, 16], attn_type="vanilla")
UNET = dict(image_size=8, in_channels=24, model_channels=32, out_channels=24, num_res_blocks=1,
            attention_resolutions=[2], channel_mult=[1, 2], num_head_channels=16)
DDPM = dict(timesteps=20, image_size=8, channels=24, sampling_timesteps=4, mixed_init=-6.0)


def occ_cfg(amp=False, attn_type="vanilla", **loss):
    lc = dict(epochs=2, warmup_epochs=1, gradient_accumulate_every=2, sn_reg=True,
              kl_anneal=True, sn_reg_weight_decay_anneal=True, lr_scheduler=False,
              save_and_sample_every=1, **loss)
    return {
        "seed": 3,
        "model": {"use_fp16": amp, "amp": amp, "lr": 1e-4, "embed_dim": 8,
                  "pointnet": {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 32,
                               "n_blocks": 3},
                  "params": {"lossconfig": lc, "ddconfig": dict(DD, attn_type=attn_type),
                             "unetconfig": UNET,
                             "ddpmconfig": DDPM,
                             "mlpconfig": dict(in_ch=3, out_ch=1, ch=64, latent_dim=8)}},
        "data": {"domain": "occupancy", "batch_size": B},
    }


def random_params(init_fn, seed):
    """Seeded random parameters of the shapes `init_fn()` makes, without
    running it (jax.eval_shape): kernels N(0, 1 / fan_in), biases
    N(0, 0.05^2), norm scales 1 + N(0, 0.05^2); no leaf is zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))
        return (1.0 if name == "scale" else 0.0) + 0.05 * x

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn)["params"])


def scale_quant(vae):
    """The quant layers scaled by 0.1, so that the posteriors' logvar stays
    near 0 as in a trained VAE: at random draws it reaches several units,
    where one bf16 rounding of it moves the std by percents and amp then
    lies percents from fp32 in JAX too."""
    return dict(vae, **{k: jax.tree_util.tree_map(lambda a: a * np.float32(0.1), v)
                        for k, v in vae.items() if k.startswith("quant_")})


def scale_lin_attn(tree):
    """Every LinAttnBlock's to_qkv kernel scaled by 0.1.  The block's output
    is quadratic in its input (no norm, no residual), so at random draws
    the stacked blocks reach logits of 1e5, where fp32's summation order
    moves the loss by percents on either side; a trained VAE keeps these
    kernels small."""
    if not isinstance(tree, dict):
        return tree
    return {k: (dict(v, to_qkv=jax.tree_util.tree_map(lambda a: a * np.float32(0.1),
                                                        v["to_qkv"]))
                if k.startswith("LinAttnBlock_") else scale_lin_attn(v))
            for k, v in tree.items()}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def jax_eps(rng, b, r, e):
    """The eps the JAX triplane VAE draws from its key (split in 3, plane
    order xy, yz, xz), port layout."""
    return tuple(nchw(jax.random.normal(k, (b, r, r, e), jnp.float32))
                 for k in jax.random.split(rng, 3))


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def check_terms(got, ref, tol):
    for k, r in ref.items():
        r = float(r)
        assert abs(float(got[k]) - r) <= tol * max(abs(r), 1e-6), (k, float(got[k]), r)


def check_grads(got, ref, ref32=None):
    """fp32 (ref32 None): each tensor within 1e-4 relative (L2), but a
    tensor whose gradient is zero up to roundoff (max|ref| <= 1e-6 of the
    largest: the k bias of an attention, the bias of a conv before a
    one-channel GroupNorm group) within 1e-6 of the largest absolutely.
    amp: the cosine (float64) of the whole set and of each module's (the
    pointnet's, the VAE's, the INR's) with JAX's amp gradient >= 0.999, or
    where JAX's own amp gradient lies farther from its fp32 one `ref32`,
    >= 1 - 2 (1 - that cosine): the pointnet runs fp32 on a gradient that
    comes back through the bf16 VAE, and an L1 loss's sign flips under
    bf16, so at these tiny configs JAX's amp-vs-fp32 cosines reach down to
    0.9974."""
    assert sorted(got) == sorted(ref)
    if ref32 is None:
        gmax = max(np.abs(r).max() for r in ref.values())
        for k, r in ref.items():
            if np.abs(r).max() <= 1e-6 * gmax:
                assert np.abs(got[k] - r).max() <= 1e-6 * gmax, k
            else:
                assert rel(got[k], r) <= 1e-4, (k, rel(got[k], r))
        return
    cos = lambda a, b: a @ b / np.linalg.norm(a) / np.linalg.norm(b)
    for part in ("", "pointnet.", "vae.", "mlp."):
        keys = [k for k in sorted(ref) if k.startswith(part)]
        flat = lambda d: np.concatenate([np.ravel(d[k]) for k in keys]).astype(np.float64)
        bar = min(0.999, 1 - 2 * (1 - cos(flat(ref), flat(ref32))))
        assert cos(flat(got), flat(ref)) >= bar, (part, cos(flat(got), flat(ref)), bar)


def check_window(now, ref_now, grads, lr):
    """Parameters after an accumulation window's update against JAX's: every
    element within 1e-4 x its tensor's max|ref|, but where the window's
    gradient is at roundoff level (<= 1e-6 of the largest; the bias of a
    conv before a one-channel GroupNorm group, an attention's k bias),
    Adam's first normalised step takes roundoff's sign and moves it by at
    most lr either way; the whole set within 1e-4 relative (L2)."""
    gmax = max(np.abs(g).max() for g in grads.values())
    for k, r in ref_now.items():
        d = np.abs(now[k] - r)
        noise = np.abs(grads[k]) <= 1e-6 * gmax
        assert d[~noise].max(initial=0.0) <= 1e-4 * np.abs(r).max(), k
        assert d[noise].max(initial=0.0) <= 2.02 * lr, k
    flat = lambda d: np.concatenate([np.ravel(d[k]) for k in sorted(ref_now)])
    assert rel(flat(now), flat(ref_now)) <= 1e-4


class Setup:
    """A JAX OccupancyPipeline and the port's on the same stage-1 weights
    (the quant layers scaled, `scale_quant`) and SN vectors (the port's,
    drawn by init_stage1, carried to JAX by sn_state_to_jax), with JAX's
    loss and gradient compiled once (`vg`)."""

    def __init__(self, amp=False, attn_type="vanilla"):
        from ddmi_tpu.domains.occupancy import OccupancyPipeline as JaxPipe
        from ddmi_tpu_torch.interop import sn_state_to_jax

        d = occ_cfg(amp, attn_type)
        self.jcfg, self.cfg = jax_config(d), config_from_dict(d)
        jp = self.jpipe = JaxPipe(self.jcfg)
        res, c = DD["resolution"], DD["in_channels"]
        planes = tuple(jnp.zeros((1, res, res, c)) for _ in range(3))
        pyr = lambda: [jnp.zeros((1, r, r, DD["out_ch"])) for r in (8, 16, 32)]
        key = jax.random.PRNGKey(0)
        self.params = {
            "pointnet": random_params(lambda: jp.pointnet.init(key, jnp.zeros((1, 64, 3))), 1),
            "vae": scale_lin_attn(scale_quant(random_params(
                lambda: jp.vae.init(key, planes, key), 2))),
            "mlp": random_params(lambda: jp.mlp.init(key, jnp.zeros((1, 8, 3)),
                                                     (pyr(), pyr(), pyr())), 3),
        }
        jp._stage1_total_iters = SPE * self.cfg.model.lossconfig.epochs
        self.pipe = self.new_pipe()
        self.state = self.pipe.init_stage1(SPE)
        self.sn = sn_state_to_jax(self.state.sn)
        self.vg = jax.jit(jax.value_and_grad(jp.stage1_loss, has_aux=True))

    def new_pipe(self):
        """A port pipeline on the setup's stage-1 weights."""
        from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline

        pipe = OccupancyPipeline(self.cfg, device="cpu", seed=0)
        pipe.load_state_dicts(**self.port_sds(self.params))
        return pipe

    def port_sds(self, tree):
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
        return {"pointnet": pointnet_from_jax(tree["pointnet"], 3),
                "vae": triplane_vae_from_jax(tree["vae"], self.cfg.model.ddconfig),
                "mlp": mlp3d_from_jax(tree["mlp"])}

    def port_names(self, tree):
        """A JAX {'pointnet', 'vae', 'mlp'} tree -> {port parameter name: array}."""
        return {f"{m}.{k}": v.numpy() for m, sd in self.port_sds(tree).items()
                for k, v in sd.items()}


def occ_batch(seed):
    from ddmi_tpu_torch.data.shapenet import SyntheticOccupancy

    return next(iter(SyntheticOccupancy(B, N_PTS, N_CLOUD, length=1, seed=seed)))


@pytest.fixture(scope="module")
def s32():
    return Setup()


def _loss_and_grads(s, batch, key, step):
    """JAX's stage-1 loss, terms, new SN state and gradients, and the port's
    on the same draws."""
    from ddmi_tpu_torch.domains.triplane import TriplaneDraws

    (_, (jm, jsn)), jg = s.vg(s.params, s.sn, batch, key, jnp.int32(step))
    draws = TriplaneDraws(jax_eps(key, B, 8, 8))
    loss, m, sn = s.pipe.stage1_loss({k: torch.from_numpy(v) for k, v in batch.items()}, step,
                                     draws, s.state.sn)
    loss.backward()
    grads = {k: p.grad.detach().numpy().copy() for k, p in s.state.params.items()}
    for p in s.state.params.values():
        p.grad = None
    return m, jm, sn, jsn, grads, s.port_names(jg)


@pytest.mark.parametrize("amp", [False, True])
def test_stage1_loss_and_gradients_match_jax(s32, amp):
    """stage1_loss (BCE summed over the query points, the annealed KL at
    micro-step 3, the annealed SN weight) and its gradients with respect to
    every pointnet, VAE and INR3D parameter against jax.value_and_grad of
    the JAX loss on the same weights, SN vectors and eps (check_grads); the
    refreshed SN vectors too.  Under amp the VAE runs bf16 and INR3D fp32
    on bf16 weights on both sides, and the pointnet fp32."""
    s = Setup(amp=True) if amp else s32
    batch, key = occ_batch(5), jax.random.PRNGKey(11)
    m, jm, sn, jsn, grads, ref = _loss_and_grads(s, batch, key, 3)
    check_terms(m, jm, 1e-2 if amp else 1e-5)
    ref32 = s32.port_names(s32.vg(s32.params, s32.sn, batch, key, jnp.int32(3))[1]) if amp \
        else None
    check_grads(grads, ref, ref32)
    for k, (u, v) in jsn.items():
        assert rel(sn[k][0].numpy(), u) <= 1e-5 and rel(sn[k][1].numpy(), v) <= 1e-5, k


def test_stage1_micro_steps_match_optax(s32):
    """Three stage1_train_step micro-steps with accumulation over 2 against
    JAX's loss gradients fed to optax's AdamW inside MultiSteps (constant
    rate 1e-4; JAX in float64, see Setup): each micro-step's terms within
    1e-5 relative; the parameters unchanged after micro-step 1, moved after
    2 and unchanged again after 3, and after the window held to JAX's as
    check_window holds them; the SN vectors within 1e-4 relative at every
    micro-step."""
    import copy

    import optax

    from ddmi_tpu_torch.domains.triplane import TriplaneDraws

    s = s32
    pipe = s.new_pipe()
    state = pipe.init_stage1(SPE)
    state.sn = copy.deepcopy(s.state.sn)
    tx = s.jpipe.stage1_optimizer(SPE)
    params, sn = s.params, s.sn
    opt = tx.init(params)
    update = jax.jit(lambda g, o, p: tx.update(g, o, p))
    prev = {k: v.detach().clone().numpy() for k, v in state.params.items()}
    window = None
    for step in range(3):
        batch, key = occ_batch(20 + step), jax.random.PRNGKey(30 + step)
        (_, (jm, sn)), g = s.vg(params, sn, batch, key, jnp.int32(step))
        window = g if step == 0 else jax.tree_util.tree_map(lambda a, b: (a + b) / 2, window, g)
        upd, opt = update(g, opt, params)
        params = optax.apply_updates(params, upd)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        state, m = pipe.stage1_train_step(state, tb, draws=TriplaneDraws(jax_eps(key, B, 8, 8)))
        check_terms(m, jm, 1e-5)
        now = {k: v.detach().clone().numpy() for k, v in state.params.items()}
        changed = [k for k in now if not np.array_equal(now[k], prev[k])]
        assert (len(changed) > 0) == (step == 1), (step, changed[:3])
        if step == 1:
            check_window(now, s.port_names(params), s.port_names(window), s.cfg.model.lr)
        prev = now
        for k, (u, v) in sn.items():
            assert rel(state.sn[k][0].numpy(), u) <= 1e-4 and rel(state.sn[k][1].numpy(), v) <= 1e-4
    assert state.step == 3 and state.opt.gradient_step == 1


def test_triplane_sn_layout_and_state_match_jax(s32):
    """The triplane VAE's conv matrices in JAX's groups and sorted-path
    order (the quant and post-quant Dense layers left out, as JAX's 4-D
    kernel filter leaves them), and init_sn_state on JAX's draws from key 7
    equal to JAX's state (one power iteration on both sides; the trainers
    take 40).  The regulariser's value (spectral_norm_loss +
    norm_scale_loss) and refreshed vectors are held in the loss test."""
    from ddmi_tpu.core.sn_reg import _collect_conv_mats, init_sn_state as jax_init
    from ddmi_tpu_torch.core.sn_reg import conv_matrices, init_sn_state

    s = s32
    ref = _collect_conv_mats(s.params["vae"])
    got = conv_matrices(s.pipe.vae)
    assert list(got) == list(ref)
    for k in ref:
        assert len(got[k]) == len(ref[k]), k
        for a, b in zip(got[k], ref[k]):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))

    def draws():
        rng = jax.random.PRNGKey(7)
        for mats in ref.values():
            n, (rows, cols) = len(mats), mats[0].shape
            rng, r1, r2 = jax.random.split(rng, 3)
            yield torch.from_numpy(np.asarray(jax.random.normal(r1, (n, rows))))
            yield torch.from_numpy(np.asarray(jax.random.normal(r2, (n, cols))))

    state = init_sn_state(s.pipe.vae, num_iter=1, draws=draws())
    jstate = jax.jit(jax_init, static_argnums=2)(s.params["vae"], jax.random.PRNGKey(7), 1)
    for k, (u, v) in jstate.items():
        assert rel(state[k][0].numpy(), u) <= 1e-5 and rel(state[k][1].numpy(), v) <= 1e-5, k


def test_stage2_loss_matches_jax(s32):
    """stage2_loss (the frozen encode: pointnet, encoder and posteriors
    sampled with JAX's keys, packed [xy | xz | yz]; then the diffusion loss
    through the UNet at JAX's t and noise) within 1e-5 relative, fp32."""
    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline

    s = s32
    jp = s.jpipe
    key = jax.random.PRNGKey(0)
    p2 = {"unet": random_params(lambda: jp.unet.init(key, jnp.zeros((1, 8, 8, 24)),
                                                      jnp.zeros((1,), jnp.int32)), 4),
          "mixing_logit": jnp.full((1, 1, 1, 24), -1.0, jnp.float32)}
    batch, rng = occ_batch(7), jax.random.PRNGKey(12)
    loss, aux = jax.jit(jp.stage2_loss)(p2, s.params, jax.tree_util.tree_map(jnp.asarray, batch),
                                        rng)
    rng_enc, rng_diff = jax.random.split(rng)
    rng_t, rng_n = jax.random.split(rng_diff)
    t = torch.from_numpy(np.asarray(jax.random.randint(rng_t, (B,), 0, 20))).long()
    noise = nchw(jax.random.normal(rng_n, (B, 8, 8, 24), jnp.float32))
    pipe = OccupancyPipeline(s.cfg, device="cpu", seed=1)
    pipe.load_state_dicts(unet=unet_from_jax(jax.tree_util.tree_map(np.asarray, p2["unet"]),
                                             s.cfg.model.unetconfig),
                          mixing_logit=np.full(24, -1.0, np.float32),
                          **s.port_sds(s.params))
    pipe.init_stage2()
    got, _ = pipe.stage2_loss({k: torch.from_numpy(v) for k, v in batch.items()}, t=t,
                              noise=noise, eps=jax_eps(rng_enc, B, 8, 8))
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss)), (float(got), float(loss))
