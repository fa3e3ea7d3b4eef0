"""Stage-2 image training of the PyTorch port against the JAX package, on
the CPU in fp32, at a tiny config: a UNet (mc 32, channel_mult [1, 2], one
res block) over 32 x 32 latents with attention at n = 1024, so that the
training tier (flash) is crossed, and a VAE encoder at resolution 128, ch 32.
Weights are shared through ddmi_tpu_torch/interop.py; inputs, timesteps,
diffusion noise and posterior eps come from numpy seeds and go to both
sides.  Each test states its tolerance.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config_from_dict
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.interop import unet_from_jax

torch.set_num_threads(1)

CFG = {
    "seed": 3,
    "model": {
        "use_fp16": False, "amp": False, "lr": 1e-3, "embed_dim": 4,
        "params": {
            "lossconfig": dict(gradient_accumulate_every=3, ema_update_every=2,
                               ema_decay=0.999),
            "unetconfig": dict(image_size=32, in_channels=4, model_channels=32,
                               out_channels=4, attention_resolutions=[1],
                               num_res_blocks=1, channel_mult=[1, 2],
                               num_head_channels=32),
            "ddconfig": dict(z_channels=8, resolution=128, out_ch=8, ch=32,
                             ch_mult=[1, 1, 2], num_res_blocks=1,
                             hdbf_resolutions=[64, 32], attn_type="vanilla"),
            "mlpconfig": dict(ch=32, latent_dim=8),
            "ddpmconfig": dict(image_size=32, channels=4),
        },
    },
    "data": {"domain": "image", "batch_size": 2},
}
B, LAT, STEPS = 2, 32, 6


def _perturb_zeros(module, seed):
    """Seeded N(0, 0.05^2) values for every all-zero parameter of a port
    module (output convs, proj_out, biases), so that no branch is skipped."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32)))


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _nchw(a):
    return np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2)))


# ------------------------------------------------------------- flash backward


@pytest.mark.parametrize("n", [512, 600])
def test_flash_backward_matches_jax_dense_vjp(n):
    """The flash Function's gradients on CPU tensors (flash_bwd_plain)
    against jax.vjp of the dense fp32 attention: max|err| <= 1e-5 *
    max|ref| for dq, dk, dv (the library kernel has no CPU mode)."""
    from ddmi_tpu.ops.pallas.attention import _dense_ref
    from ddmi_tpu_torch.ops import flash_attention

    rng = np.random.default_rng(n)
    q, k, v, do = (rng.standard_normal((2, 3, n, 32)).astype(np.float32) for _ in range(4))
    s = 32**-0.5
    _, vjp = jax.vjp(lambda a, b, c: _dense_ref(a, b, c, s), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    flash_attention.flash_attention(qt, kt, vt, s).backward(torch.from_numpy(do))
    for got, r in zip((qt.grad, kt.grad, vt.grad), ref):
        r = np.asarray(r)
        assert np.abs(got.numpy() - r).max() <= 1e-5 * np.abs(r).max()


# ------------------------------------------------------------ small modules


def test_encoder_posterior_matches_jax():
    """Autoencoder.encode: posterior mean and logvar within 1e-4 *
    max(1, max|ref|) (fp32, sums in another order)."""
    from ddmi_tpu.core.config import DDConfig
    from ddmi_tpu.nn.vae import Autoencoder
    from ddmi_tpu_torch.core.config import DDConfig as TorchDD
    from ddmi_tpu_torch.nn.vae import Autoencoder as TorchAE

    from ddmi_tpu.interop.reference_ckpt import convert_vae

    kw = dict(z_channels=8, resolution=32, out_ch=8, ch=32, ch_mult=(1, 2), num_res_blocks=1,
              attn_resolutions=(16,), hdbf_resolutions=(16,), attn_type="vanilla")
    torch.manual_seed(0)
    tm = TorchAE(TorchDD(**kw), embed_dim=4)
    _perturb_zeros(tm, 2)
    jm = Autoencoder(DDConfig(**kw), embed_dim=4)
    p = convert_vae(_numpy_sd(tm), DDConfig(**kw))
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = jm.apply({"params": p}, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(_nchw(x)))
    for g, r in ((got.mean, ref.mean), (got.logvar, ref.logvar)):
        r = _nchw(r)
        assert np.abs(g.numpy() - r).max() <= 1e-4 * max(1.0, np.abs(r).max())


@pytest.mark.parametrize("shape,size", [((2, 48, 40, 3), 16), ((1, 20, 20, 2), 64),
                                        ((2, 64, 64, 3), 37), ((1, 32, 32, 3), 32)])
def test_resize_antialias_matches_jax(shape, size):
    """resize_antialias against jax.image.resize(..., "linear",
    antialias=True): max|err| <= 1e-5 on values in [0, 1]."""
    from ddmi_tpu_torch.core.coords import resize_antialias

    x = np.random.default_rng(size).random(shape).astype(np.float32)
    out = (shape[0], size, size, shape[3])
    ref = np.asarray(jax.image.resize(jnp.asarray(x), out, "linear", antialias=True))
    got = resize_antialias(torch.from_numpy(x), size).numpy()
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("param,loss_type,elbo", [("eps", "l2", 0.0), ("x0", "l2", 0.5),
                                                  ("v", "l1", 0.1)])
def test_p_losses_matches_jax(param, loss_type, elbo):
    """p_losses with a fixed elementwise denoiser, for each
    parameterization: loss, loss_simple and loss_vlb within 1e-6
    relative."""
    from ddmi_tpu.diffusion.process import GaussianDiffusion as JGD
    from ddmi_tpu.diffusion.process import p_losses as jax_p_losses
    from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, p_losses

    d = dict(parameterization=param, loss_type=loss_type, original_elbo_weight=elbo,
             l_simple_weight=0.8, v_posterior=0.1)
    jcfg = jax_config_from_dict({"model": {"params": {"ddpmconfig": d}}})
    tcfg = config_from_dict({"model": {"params": {"ddpmconfig": d}}})
    jgd = JGD.from_config(jcfg.model.ddpmconfig)
    tgd = GaussianDiffusion.from_config(tcfg.model.ddpmconfig)
    rng = np.random.default_rng(5)
    x0, noise = (rng.standard_normal((3, 4, 4, 8)).astype(np.float32) for _ in range(2))
    t = np.array([0, 417, 999])
    logit = rng.standard_normal((8,)).astype(np.float32)
    jfn = lambda x, tt: jnp.tanh(x) * 0.7 + 1e-3 * tt[:, None, None, None]
    tfn = lambda x, tt: torch.tanh(x) * 0.7 + 1e-3 * tt[:, None, None, None]
    _, jaux = jax_p_losses(jgd, jfn, jnp.asarray(logit.reshape(1, 1, 1, 8)), jnp.asarray(x0),
                           jnp.asarray(t), jnp.asarray(noise))
    _, taux = p_losses(tgd, tfn, torch.from_numpy(logit.reshape(1, 8, 1, 1)),
                       torch.from_numpy(_nchw(x0)), torch.from_numpy(t),
                       torch.from_numpy(_nchw(noise)))
    for key in ("loss", "loss_simple", "loss_vlb"):
        assert abs(float(taux[key]) - float(jaux[key])) <= 1e-6 * abs(float(jaux[key])), key


@pytest.mark.parametrize("step", [0, 7, 100, 110, 130, 1000, 5003])
def test_ema_update_matches_jax(step):
    """ema_update at micro-steps before and past update_after_step (100),
    on and off the update_every boundary: within 1e-6 of the JAX function."""
    from ddmi_tpu.core.ema import ema_update as jax_ema
    from ddmi_tpu_torch.core.ema import ema_update

    rng = np.random.default_rng(step)
    e, p = (rng.standard_normal((3, 5)).astype(np.float32) for _ in range(2))
    ref = jax_ema({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, jnp.asarray(step, jnp.int32),
                  beta=0.9999, update_every=10)["w"]
    got = ema_update({"w": torch.from_numpy(e.copy())}, {"w": torch.from_numpy(p)}, step,
                     beta=0.9999, update_every=10)["w"]
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6


def test_synthetic_images_are_the_jax_packages():
    """The port's SyntheticImages gives bit-identical batches."""
    from ddmi_tpu.data.synthetic import SyntheticImages as JaxImages
    from ddmi_tpu_torch.data.synthetic import SyntheticImages

    a, b = SyntheticImages(3, 32, length=2, seed=7), JaxImages(3, 32, length=2, seed=7)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# --------------------------------------------------------- the attention tiers


def test_attention_tiers_follow_grad_mode(monkeypatch):
    """With no gradient recorded the UNet block and the 1D tiers take the
    inference kernels (fused block, mha_vmem); with one, flash (n >= 512,
    1D up to 32,768 tokens) or the dense / MEA paths, as JAX training
    traces do."""
    from ddmi_tpu_torch.nn import attention1d
    from ddmi_tpu_torch.nn.unet import AttentionBlock
    from ddmi_tpu_torch.ops import attention, attn_block, flash_attention, mea

    calls = []

    def spy(name, fn):
        def call(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return call

    for mod, name in ((attn_block, "attention_block"), (attention, "mha_vmem"),
                      (flash_attention, "flash_attention"), (mea, "attention")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))

    def run(block, x, grad):
        calls.clear()
        with torch.set_grad_enabled(grad):
            block(x)
        return list(calls)

    torch.manual_seed(0)
    fused = AttentionBlock(128, 4)
    assert run(fused, torch.randn(1, 128, 8, 8), False) == ["attention_block"]
    assert run(fused, torch.randn(1, 128, 8, 8), True) == []  # dense, n = 64
    big = AttentionBlock(32, 1)
    assert run(big, torch.randn(1, 32, 32, 32), False) == ["mha_vmem"]
    assert run(big, torch.randn(1, 32, 32, 32), True) == ["flash_attention"]

    q = torch.randn(1, 2, 1024, 16)
    tier = lambda grad, t: run(lambda x: attention1d.tiered_attention(x, x, x), t, grad)
    assert tier(False, q) == ["mha_vmem"]
    assert tier(True, q) == ["flash_attention"]
    monkeypatch.setattr(attention1d, "FLASH_TRAIN_MAX_TOKENS", 512)
    assert tier(True, q) == ["attention"]
    assert tier(False, torch.randn(1, 2, 1100, 16)) == ["attention"]  # n % 8, n % 1024 != 0


# ------------------------------------------------------ the stage-2 trajectory


def _draws(step):
    rng = np.random.default_rng(100 + step)
    x = rng.random((B, 128, 128, 3)).astype(np.float32)
    t = rng.integers(0, 1000, (B,))
    noise = rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32)
    eps = rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32)
    return x, t, noise, eps


@pytest.fixture(scope="module")
def trajectory():
    """The port's initial weights (seeded, zero-init parameters perturbed,
    a random mixing logit) mapped onto the JAX trees by the JAX package's
    converters; then in JAX, STEPS micro-steps of value_and_grad of the
    stage-2 loss at explicit t / noise / eps, optax (adamw, bf16 mu,
    MultiSteps k = 3) and ema_update.  Returns the port state_dicts, the
    first step's loss and gradients, and the parameters and EMA after every
    micro-step, with each micro-step's gradients."""
    from ddmi_tpu.core.amp import amp_denoiser
    from ddmi_tpu.core.coords import resize_antialias, symmetrize
    from ddmi_tpu.core.ema import ema_update
    from ddmi_tpu.core.optim import stage2_adamw
    from ddmi_tpu.diffusion.process import p_losses
    from ddmi_tpu.domains.image import ImagePipeline
    from ddmi_tpu.interop.reference_ckpt import convert_unet, convert_vae
    from ddmi_tpu_torch.domains.image import ImagePipeline as TorchPipeline

    jcfg = jax_config_from_dict(CFG)
    m = jcfg.model
    port = TorchPipeline(config_from_dict(CFG), device="cpu", seed=0)
    _perturb_zeros(port.unet, 1)
    logit = np.random.default_rng(2).standard_normal((1, 4, 1, 1)).astype(np.float32)
    sds = {"unet": port.unet.state_dict(), "vae": port.vae.state_dict(),
           "mixing_logit": torch.from_numpy(logit)}
    vae = convert_vae(_numpy_sd(port.vae), m.ddconfig)
    params = {"unet": convert_unet(_numpy_sd(port.unet), m.unetconfig),
              "mixing_logit": np.transpose(logit, (0, 2, 3, 1))}
    pipe = ImagePipeline(jcfg)

    @jax.jit
    def encode(x, eps):
        y = jnp.clip(resize_antialias(symmetrize(x), pipe.anchor), -1, 1)
        post = pipe.vae.apply({"params": vae}, y, method=pipe.vae.encode)
        z = post.mean.astype(jnp.float32) + post.std.astype(jnp.float32) * eps
        return z.astype(post.mean.dtype).astype(jnp.float32)

    def loss_fn(p, z, t, noise):
        model_fn = amp_denoiser(lambda q, xt, tt: pipe.unet.apply({"params": q}, xt, tt),
                                p["unet"], False)
        return p_losses(pipe.gd, model_fn, p["mixing_logit"], z, t, noise)[0]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    tx = stage2_adamw(jcfg)
    update = jax.jit(tx.update)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state, ema = tx.init(p), p
    out = {"sds": sds, "params0": params, "grads": [], "params": [], "ema": []}
    for step in range(STEPS):
        x, t, noise, eps = map(jnp.asarray, _draws(step))
        loss, grads = grad_fn(p, encode(x, eps), t, noise)
        if step == 0:
            out["loss0"], out["grads0"] = float(loss), grads
        out["grads"].append(grads)
        updates, opt_state = update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        ema = ema_update(ema, p, jnp.asarray(step), beta=m.lossconfig.ema_decay,
                         update_every=m.lossconfig.ema_update_every)
        out["params"].append(p)
        out["ema"].append(ema)
    return out


def _port_pipeline(traj):
    """The port's pipeline on the CPU with the trajectory's initial
    weights, and the map from a JAX params tree to port names."""
    from ddmi_tpu_torch.domains.image import ImagePipeline

    cfg = config_from_dict(CFG)
    pipe = ImagePipeline(cfg, device="cpu", seed=0)
    pipe.load_state_dicts(**traj["sds"])

    def port(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        sd = {f"unet.{k}": v.numpy()
              for k, v in unet_from_jax(tree["unet"], cfg.model.unetconfig).items()}
        sd["mixing_logit"] = _nchw(tree["mixing_logit"])
        return sd

    return pipe, port


def _torch_draws(step):
    x, t, noise, eps = _draws(step)
    return (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(_nchw(noise)),
            torch.from_numpy(_nchw(eps)))


def _roundoff(grads, floor=1e-5):
    """Names of the parameters whose gradient is roundoff: below `floor`
    times the global gradient norm.  They exist: at model_channels 32 a
    GroupNorm(32) group holds one channel, so a conv or embedding bias just
    before it cannot change the loss."""
    total = np.sqrt(sum(float(np.sum(np.square(g))) for g in grads.values()))
    return {k for k, g in grads.items() if np.linalg.norm(g) <= floor * total}, total


def test_stage2_loss_and_gradients_match_jax(trajectory):
    """stage2_loss (encode, UNet through the flash tier's plain backward,
    mixed prediction, p_losses) against jax.value_and_grad of the same
    computation: the loss within 1e-5 relative; every parameter's gradient
    within 1e-3 relative (L2) plus 1e-5 of the global gradient norm, which
    covers the parameters whose exact gradient is 0 (see _roundoff).  fp32
    on both sides, sums in other orders through ~20 layers and back."""
    pipe, port = _port_pipeline(trajectory)
    pipe.init_stage2()
    x, t, noise, eps = _torch_draws(0)
    loss, _ = pipe.stage2_loss(x, t=t, noise=noise, eps=eps)
    loss.backward()
    assert abs(loss.item() - trajectory["loss0"]) <= 1e-5 * abs(trajectory["loss0"])
    ref = port(trajectory["grads0"])
    params = pipe.stage2_params()
    assert set(ref) == set(params)
    _, total = _roundoff(ref)
    for k, r in ref.items():
        err = np.linalg.norm(params[k].grad.numpy() - r)
        assert err <= 1e-3 * np.linalg.norm(r) + 1e-5 * total, (k, err, np.linalg.norm(r))


def test_stage2_train_steps_match_optax_and_ema(trajectory):
    """STEPS micro-steps of stage2_train_step (AdamW with bf16 mu,
    MultiSteps k = 3, EMA every 2 steps with decay 0 before step 100)
    against optax and ema_update.  The parameters change only at
    micro-steps 3 and 6.  After every micro-step, each parameter's and each
    EMA's change from the start agrees with JAX's within 1e-3 relative (L2)
    over the elements whose accumulated JAX gradient exceeds 1e-3 of its
    tensor's RMS at every update so far.  Adam moves an element by about
    lr * sign(gradient) whatever the gradient's size, so where the gradient
    is roundoff (see _roundoff; also the key bias of an attention qkv, which
    the softmax cannot see) the direction is the roundoff's: those elements
    are held to |change| <= lr per update."""
    pipe, port = _port_pipeline(trajectory)
    state = pipe.init_stage2()
    start = {k: v.detach().clone().numpy() for k, v in state.params.items()}
    prev = start
    p0 = port(trajectory["params0"])
    zero_grad, _ = _roundoff(port(trajectory["grads0"]))
    lr = config_from_dict(CFG).model.lr
    steady = {k: np.ones(v.shape, bool) for k, v in p0.items()}
    acc = None
    for step in range(STEPS):
        grads = port(trajectory["grads"][step])
        acc = grads if acc is None else {k: acc[k] + grads[k] for k in acc}
        if step % 3 == 2:
            for k, g in acc.items():
                rms = np.sqrt(np.mean(np.square(g)))
                steady[k] &= (np.abs(g) > 1e-3 * rms) & (k not in zero_grad)
            acc = None
        x, t, noise, eps = _torch_draws(step)
        state, aux = pipe.stage2_train_step(state, x, t=t, noise=noise, eps=eps)
        now = {k: v.detach().clone().numpy() for k, v in state.params.items()}
        changed = [k for k in now if not np.array_equal(now[k], prev[k])]
        assert (len(changed) > 0) == (step % 3 == 2), (step, changed[:3])
        prev = now
        updates = (step + 1) // 3
        for got, ref in ((now, port(trajectory["params"][step])),
                         ({k: v.numpy() for k, v in state.ema.items()},
                          port(trajectory["ema"][step]))):
            for k, r in ref.items():
                d, rd, m = got[k] - start[k], r - p0[k], steady[k]
                if m.any():
                    assert _rel(d[m], rd[m]) <= 1e-3, (step, k, _rel(d[m], rd[m]))
                assert np.abs(d[~m]).max(initial=0.0) <= 1.01 * lr * updates, (step, k)
    assert state.step == STEPS and state.opt.gradient_step == 2


# -------------------------------------------------------------- the trainer


class _Images:
    """SyntheticImages with a NaN batch at `nan_at` (None: none)."""

    def __init__(self, length, nan_at=None):
        from ddmi_tpu_torch.data.synthetic import SyntheticImages

        self.src = SyntheticImages(B, 128, length=length, seed=1)
        self.nan_at = nan_at

    def __len__(self):
        return len(self.src)

    def __iter__(self):
        for i, x in enumerate(self.src):
            yield np.full_like(x, np.nan) if i == self.nan_at else x


def test_trainer_train_stage2(tmp_path):
    """Trainer.train_stage2: the step count, parameters that change only at
    accumulation boundaries (micro-steps 3 and 6), finite logged losses, a
    NaN loss stopped by the guard at its check step, and a resume from the
    checkpoint the first run saved at its last epoch."""
    from ddmi_tpu_torch.core.trainer import NaNLossError, Trainer
    from ddmi_tpu_torch.domains.image import ImagePipeline

    cfg = config_from_dict(CFG)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, extra={"nan_check_every": 2, "prefetch": 2}))
    pipe = ImagePipeline(cfg, device="cpu", seed=cfg.seed)
    seen = []
    step_fn = pipe.stage2_train_step

    def recording(state, x, **kw):
        before = [p.detach().clone() for p in state.params.values()]
        out = step_fn(state, x, **kw)
        seen.append(any(not torch.equal(a, p) for a, p in zip(before, state.params.values())))
        return out

    pipe.stage2_train_step = recording
    trainer = Trainer(cfg, pipe, _Images(6), save_dir=str(tmp_path / "ok"))
    state = trainer.train_stage2(epochs=1)
    assert state.step == 6 and state.opt.gradient_step == 2
    assert seen == [False, False, True, False, False, True]
    lines = (tmp_path / "ok" / "train.jsonl").read_text().splitlines()
    assert len(lines) == 6 and all(np.isfinite(eval(ln)["s2/loss"]) for ln in lines)

    pipe = ImagePipeline(cfg, device="cpu", seed=cfg.seed)
    bad = Trainer(cfg, pipe, _Images(6, nan_at=2), save_dir=str(tmp_path / "nan"))
    with pytest.raises(NaNLossError, match="step 4"):
        bad.train_stage2(epochs=1)
    assert not (tmp_path / "nan" / "stage2").exists() or not os.listdir(tmp_path / "nan" / "stage2")

    pipe = ImagePipeline(cfg, device="cpu", seed=cfg.seed)
    again = Trainer(cfg, pipe, _Images(6), save_dir=str(tmp_path / "ok"))
    state = again.train_stage2(epochs=1, resume=True)
    assert state.step == 12 and state.opt.gradient_step == 4
