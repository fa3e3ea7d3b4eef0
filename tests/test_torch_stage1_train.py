"""Stage-1 image training of the PyTorch port against the JAX package, on
the CPU, at a small config: a VAE at anchor 32 (ch 32, ch_mult [1, 1, 2],
one res block, the mid-block attention) on 64 x 64 inputs, so that the
multiscale transform takes all three branches, and an INR of width 64;
batch 2, accumulation over 5.  The weights (every zero-init leaf
randomised), the spectral-norm vectors, the discriminator and LPIPS's
random VGG are JAX's, carried by ddmi_tpu_torch/interop.py; every draw of
a micro-step (the multiscale branch and crop, the posterior eps, the INR's
twelve NoiseInjection draws, the DiffAugment draws) is JAX's own or fed to
both sides.  Here: the loss and its gradients, reconstruction at two
resolutions, checkpoints with resume for both stages, the trainer, and a
run that never loads JAX; tests/test_torch_stage1_steps.py runs two
accumulation windows of the train step on this set-up.

Tolerances: fp32 losses within 1e-5 relative and gradients with a cosine
>= 0.99999 and max|err| <= 1e-4 * max|ref| (sums in other orders); under
model.amp (bf16 on both sides, roundings in other orders) the loss within
1e-2 relative, the gradient cosine >= 0.999 and max|err| <= 0.1 * max|ref|,
with the bf16 compute dtypes checked layer by layer.  Resume is bit-exact.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.interop import (
    discriminator_from_jax, lpips_from_jax, mlp_image_from_jax, sn_state_from_jax,
    vae_from_jax,
)

torch.set_num_threads(1)

B, RES, ANCHOR, SPE, STEPS = 2, 64, 32, 10, 10
POLICY = ["color", "translation", "cutout"]


def _cfg(amp=False, adversarial=False, **loss):
    lc = dict(gradient_accumulate_every=5, epochs=4, warmup_epochs=1, adversarial=adversarial,
              save_and_sample_every=1, disc_weight=0.5, **loss)
    if adversarial:
        lc["extra"] = {"diffaugment": POLICY}
    return {
        "seed": 3,
        "model": {"use_fp16": amp, "amp": amp, "lr": 1e-3, "embed_dim": 4, "params": {
            "lossconfig": lc,
            "ddconfig": dict(z_channels=8, resolution=ANCHOR, out_ch=8, ch=32,
                             ch_mult=[1, 1, 2], num_res_blocks=1, attn_resolutions=[],
                             hdbf_resolutions=[8, 16], attn_type="vanilla"),
            "mlpconfig": dict(ch=64, latent_dim=8),
            "unetconfig": dict(image_size=8, in_channels=4, model_channels=32,
                               out_channels=4, attention_resolutions=[2], num_res_blocks=1,
                               channel_mult=[1, 2], num_head_channels=32),
            "ddpmconfig": dict(image_size=8, channels=4)}},
        "data": {"domain": "image", "batch_size": B},
    }


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _randomize(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(np.shape(a))).astype(np.float32)
        if not np.any(np.asarray(a)) else np.asarray(a, np.float32), tree)


class _FeedNoise:
    """A flax interceptor handing each NoiseInjection the next given draw,
    cast to its input's dtype as the module casts its own."""

    def __init__(self, draws):
        self.draws = iter(draws)

    def __call__(self, next_fun, args, kwargs, context):
        from ddmi_tpu.nn.stylegan import NoiseInjection

        if isinstance(context.module, NoiseInjection) and context.method_name == "__call__":
            kwargs = dict(kwargs, noise=jnp.asarray(next(self.draws)).astype(args[0].dtype))
        return next_fun(*args, **kwargs)


def _inputs(step):
    rng = np.random.default_rng(100 + step)
    x = rng.random((B, RES, RES, 3)).astype(np.float32)
    noise = [rng.standard_normal((B, ANCHOR * ANCHOR, 1)).astype(np.float32)
             for _ in range(12)]
    return x, noise, jax.random.PRNGKey(1000 + step)


def _port_draws(rng, noise, adversarial):
    """The draws JAX's stage-1 step makes from its key, for the port."""
    from ddmi_tpu_torch.domains.image import Stage1Draws

    aug = None
    if adversarial:
        rng, rng_aug = jax.random.split(rng)
        aug = []
        h = w = ANCHOR
        for p, n in (("color", 3), ("translation", 1), ("cutout", 1)):
            for _ in range(n):
                rng_aug, sub = jax.random.split(rng_aug)
                if p == "color":
                    aug.append(torch.from_numpy(np.asarray(
                        jax.random.uniform(sub, (B, 1, 1, 1))).reshape(B)))
                else:
                    r1, r2 = jax.random.split(sub)
                    if p == "translation":
                        s = int(h * 0.125 + 0.5)
                        pair = (jax.random.randint(r1, (B,), -s, s + 1),
                                jax.random.randint(r2, (B,), -s, s + 1))
                    else:
                        c = int(h * 0.5 + 0.5)
                        pair = (jax.random.randint(r1, (B, 1, 1), 0, h + (1 - c % 2)),
                                jax.random.randint(r2, (B, 1, 1), 0, w + (1 - c % 2)))
                    aug.append(tuple(torch.from_numpy(np.asarray(a)).long().reshape(B)
                                     for a in pair))
    rng_ms, rng_post, _ = jax.random.split(rng, 3)
    rp, ri, rj, ri2, rj2 = jax.random.split(rng_ms, 5)
    ms = (float(jax.random.uniform(rp)),
          int(jax.random.randint(ri, (), 0, 2 * ANCHOR - ANCHOR)),
          int(jax.random.randint(rj, (), 0, 2 * ANCHOR - ANCHOR)),
          int(jax.random.randint(ri2, (), 0, int(1.5 * ANCHOR) - ANCHOR)),
          int(jax.random.randint(rj2, (), 0, int(1.5 * ANCHOR) - ANCHOR)))
    eps = _nchw(jax.random.normal(rng_post, (B, 8, 8, 4), jnp.float32))
    return Stage1Draws(ms, eps, iter([torch.from_numpy(a) for a in noise]), aug)


class _Setup:
    """A JAX pipeline and the port's on the same state: JAX's init_stage1
    (zero leaves randomised) with LPIPS on a random VGG."""

    def __init__(self, amp=False, adversarial=False, perceptual=True):
        from ddmi_tpu.domains.image import ImagePipeline as JaxPipe
        from ddmi_tpu.evals.lpips import LPIPS as JaxLPIPS, PerceptualLoss
        from ddmi_tpu_torch.domains.image import ImagePipeline
        from ddmi_tpu_torch.evals.lpips import LPIPS

        d = _cfg(amp, adversarial)
        self.adversarial = adversarial
        jcfg, cfg = jax_config(d), config_from_dict(d)
        self.pp = None
        pfn = None
        if perceptual:
            lp = JaxLPIPS(dtype=jnp.bfloat16 if amp else jnp.float32)
            x0 = jnp.zeros((1, 32, 32, 3))
            self.pp = lp.init(jax.random.PRNGKey(5), x0, x0)["params"]
            pfn = PerceptualLoss(lambda p, t, o: lp.apply({"params": p}, t, o), self.pp)
        self.jpipe = JaxPipe(jcfg, perceptual_fn=pfn)
        st = self.jpipe.init_stage1(jax.random.PRNGKey(0), SPE)
        st = st.replace(params=_randomize(st.params, 1))
        if adversarial:
            st = st.replace(disc_params=_randomize(st.disc_params, 2, 0.02))
        self.jstate = jax.tree_util.tree_map(jnp.asarray, st)
        self.tx = self.jpipe.stage1_optimizer(SPE)
        lpips = None
        if perceptual:
            lpips = LPIPS(dtype=torch.bfloat16 if amp else torch.float32)
            lpips.load_state_dict(lpips_from_jax(jax.tree_util.tree_map(np.asarray, self.pp)))
        self.pipe = ImagePipeline(cfg, device="cpu", seed=0, perceptual=lpips)
        p = jax.tree_util.tree_map(np.asarray, st.params)
        self.pipe.load_state_dicts(vae=vae_from_jax(p["vae"], cfg.model.ddconfig),
                                   mlp=mlp_image_from_jax(p["mlp"], cfg.model.mlpconfig))
        self.state = self.pipe.init_stage1(SPE)
        self.state.sn = sn_state_from_jax(jax.tree_util.tree_map(np.asarray, st.sn_state))
        if adversarial:
            self.pipe.gan.load_state_dict(discriminator_from_jax(
                jax.tree_util.tree_map(np.asarray, st.disc_params)))
        self.cfg = cfg

    def port_names(self, tree):
        """A JAX {'vae', 'mlp'} tree -> {port parameter name: array}."""
        tree = jax.tree_util.tree_map(np.asarray, tree)
        m = self.cfg.model
        out = {f"vae.{k}": v.numpy() for k, v in vae_from_jax(tree["vae"], m.ddconfig).items()}
        out.update({f"mlp.{k}": v.numpy()
                    for k, v in mlp_image_from_jax(tree["mlp"], m.mlpconfig).items()})
        return out


def _grad_check(got, ref, cos_min=0.99999, err_max=1e-4):
    names = sorted(ref)
    g = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in names])
    r = np.concatenate([np.asarray(ref[k], np.float64).ravel() for k in names])
    cos = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r)))
    err = float(np.abs(g - r).max() / np.abs(r).max())
    assert cos >= cos_min and err <= err_max, (cos, err)
    return cos, err


@pytest.mark.parametrize("amp", [False, True])
def test_stage1_loss_and_gradients_match_jax(amp):
    """stage1_loss at micro-step 3 (multiscale, encode, decode, the INR at
    the crop's coordinates, KL, LPIPS, the SN regulariser) and its
    gradients against jax.value_and_grad of ImagePipeline.stage1_loss on
    the same weights, state and draws, on three keys that take the three
    multiscale branches; each term checked, and the refreshed SN vectors.

    Under amp the bars are bf16 roundoff (the largest gradient error reads
    0.024 of the largest gradient), which is also how far JAX's fp32 run
    lies from its amp run: values alone cannot tell the policy from fp32
    compute.  So the amp case also checks the policy itself: every layer of
    the VAE and the INR that holds a weight sees a bf16 weight and bf16
    inputs (torch.autocast, or dropped casts, would show fp32 weights), and
    the gradients land on the fp32 masters.  The INR's style MLP is the
    exception that flax's promotion makes (fp32 scale, bf16 weights): it
    runs in fp32 on the bf16-cast weights, which are checked when its
    sinusoidal embedding runs."""
    s = _Setup(amp=amp)
    jp, pipe = s.jpipe, s.pipe
    loss_bar, cos_min, err_max = (1e-2, 0.999, 0.1) if amp else (1e-5, 0.99999, 1e-4)
    step = 3
    seen, hooks = {}, []

    def record(mod, args, kwargs):
        weights = {p.dtype for p in mod.parameters(recurse=False) if p.dim() >= 2}
        inputs = {t.dtype for t in (*args, *kwargs.values())
                  if torch.is_tensor(t) and t.is_floating_point()}
        seen.setdefault(mod, set()).update(weights | inputs)

    def record_style(mod, args):
        seen.setdefault(mod, set()).update(pipe.mlp.time_mlp[i].weight.dtype for i in (1, 3))

    if amp:
        style = {pipe.mlp.time_mlp[1], pipe.mlp.time_mlp[3]}
        hooks = [m.register_forward_pre_hook(record, with_kwargs=True)
                 for net in (pipe.vae, pipe.mlp) for m in net.modules()
                 if m not in style and any(p.dim() >= 2 for p in m.parameters(recurse=False))]
        hooks.append(pipe.mlp.time_mlp[0].register_forward_pre_hook(record_style))

    def loss_fn(p, x, rng, noise):
        with fnn.intercept_methods(_FeedNoise(noise)):
            return jp.stage1_loss(p, s.jstate.sn_state, x, rng, jnp.int32(step), s.pp)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    for key in (0, 4, 3):
        x, noise, _ = _inputs(key)
        rng = jax.random.PRNGKey(key)
        (ref, (metrics, new_sn, _)), grads = grad_fn(
            s.jstate.params, jnp.asarray(x), rng, [jnp.asarray(a) for a in noise])
        draws = _port_draws(rng, noise, False)
        loss, got, sn, _ = pipe.stage1_loss(torch.from_numpy(x), step, draws, s.state.sn)
        for k in ("recon", "kl", "lpips", "sn"):
            r = float(metrics[k])
            assert abs(float(got[k]) - r) <= loss_bar * abs(r), (key, k, float(got[k]), r)
        assert got["kl_coeff"] == float(metrics["kl_coeff"])
        assert abs(loss.item() - float(ref)) <= loss_bar * abs(float(ref)), (key, loss.item())
        loss.backward()
        params = s.state.params
        if amp:
            assert len(seen) == len(hooks) and all(d == {torch.bfloat16} for d in seen.values())
            assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                       for p in params.values())
        _grad_check({k: p.grad.numpy() for k, p in params.items()}, s.port_names(grads),
                    cos_min, err_max)
        for p in params.values():
            p.grad = None
        if not amp:
            for k, (u, v) in new_sn.items():
                assert _rel(sn[k][0].numpy(), u) <= 1e-5 and _rel(sn[k][1].numpy(), v) <= 1e-5
    for h in hooks:
        h.remove()


@pytest.mark.parametrize("res", [32, 48])
def test_reconstruct_matches_jax(res):
    """reconstruct at the anchor and at 48 x 48 (scale injection 32 / 48)
    from 64 x 64 inputs, on JAX's posterior eps, through the fused render's
    plain version: within 1e-4 of JAX's pixels (in [0, 1]).  The INR's
    noise gains are zeroed on both sides: JAX's render draws its noise
    from jax.random, the port's from the kernel's Philox stream."""
    s = _Setup(perceptual=False)
    params = jax.tree_util.tree_map(np.asarray, s.jstate.params)
    for blk in params["mlp"].values():
        for conv in (blk.values() if isinstance(blk, dict) else ()):
            if isinstance(conv, dict) and "noise" in conv:
                conv["noise"]["weight"] = np.zeros_like(conv["noise"]["weight"])
    m = s.cfg.model
    s.pipe.load_state_dicts(mlp=mlp_image_from_jax(params["mlp"], m.mlpconfig))
    x = np.random.default_rng(7).random((3, RES, RES, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    ref = np.asarray(jax.jit(lambda p, a: s.jpipe.reconstruct(p, a, res, rng))(
        params, jnp.asarray(x)))
    eps = _nchw(jax.random.normal(jax.random.split(rng)[0], (3, 8, 8, 4), jnp.float32))
    got = s.pipe.reconstruct(torch.from_numpy(x), res, eps=eps)
    assert got.shape == (3, res, res, 3) and ref.shape == got.shape
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-4
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


# ------------------------------------------------------------ checkpoints


class _Images:
    def __init__(self, length, seed=1):
        from ddmi_tpu_torch.data.synthetic import SyntheticImages

        self.src = SyntheticImages(B, RES, length=length, seed=seed)

    def __len__(self):
        return len(self.src)

    def __iter__(self):
        return iter(self.src)


def _trainer(path, adversarial=False, stage=1):
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.evals.lpips import build_perceptual

    d = _cfg(adversarial=adversarial)
    d["data"]["save_pth"] = str(path)
    d["data"]["extra"] = {"prefetch": 0, "nan_check_every": 1}
    cfg = config_from_dict(d)
    lpips = build_perceptual(cfg, "cpu") if stage == 1 else None
    pipe = ImagePipeline(cfg, device="cpu", seed=0, perceptual=lpips)
    return Trainer(cfg, pipe, _Images(2))


def _state_arrays(state):
    sd = state.state_dict()
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}/{i}", x)
        else:
            out[prefix] = v.clone() if torch.is_tensor(v) else v

    walk("", sd)
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("adversarial", [False, True])
def test_stage1_resume_is_bit_exact(tmp_path, adversarial):
    """Four micro-steps in one run equal two, a checkpoint, a new process's
    pipeline resuming from it, and two more, bit for bit: parameters,
    moments, accumulator, counts, SN vectors, the discriminator and its
    optimizer (the step generators' states are in the checkpoint)."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager

    skip = lambda *a: None
    one = _trainer(tmp_path / "one", adversarial).train_stage1(epochs=2, eval_hook=skip)
    first = _trainer(tmp_path / "two", adversarial)
    half = first.train_stage1(epochs=1, eval_hook=skip)
    assert half.step == 2
    assert CheckpointManager(str(tmp_path / "two"), prefix="stage1").all_steps() == [2]
    second = _trainer(tmp_path / "two", adversarial).train_stage1(
        epochs=1, eval_hook=skip, resume=True)
    assert one.step == second.step == 4
    _assert_same(_state_arrays(one), _state_arrays(second))
    restored = _trainer(tmp_path / "three", adversarial).pipe.init_stage1(2)
    CheckpointManager(str(tmp_path / "one"), prefix="stage1").restore(
        _Wrap(restored), step=4)
    _assert_same(_state_arrays(one), _state_arrays(restored))


class _Wrap:
    """A checkpoint written by the trainer holds {"state", "generators"}."""

    def __init__(self, state):
        self.state = state

    def load_state_dict(self, sd):
        self.state.load_state_dict(sd["state"])


def test_stage2_resume_is_bit_exact_and_takes_the_stage1_checkpoint(tmp_path):
    """Stage 2 after stage 1 in the same save directory loads the VAE and
    INR of the newest stage-1 checkpoint; four stage-2 micro-steps in one
    run equal two, a checkpoint, a resume and two more, bit for bit
    (parameters, EMA, moments, accumulator, counts)."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager

    skip = lambda *a: None
    t1 = _trainer(tmp_path / "a")
    s1 = t1.train_stage1(epochs=1, eval_hook=skip)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    run = _trainer(tmp_path / "a", stage=2)
    one = run.train_stage2(epochs=2)
    saved = CheckpointManager(str(tmp_path / "a"), prefix="stage1").restore()["state"]["params"]
    for k, v in run.pipe.vae.state_dict().items():
        assert torch.equal(v.float(), saved["vae." + k].float().to(v.dtype).float()), k
    for k, v in run.pipe.mlp.state_dict().items():
        assert torch.equal(v, saved["mlp." + k]), k
    assert s1.step == 2
    _trainer(tmp_path / "b", stage=2).train_stage2(epochs=1)
    two = _trainer(tmp_path / "b", stage=2).train_stage2(epochs=1, resume=True)
    assert one.step == two.step == 4
    _assert_same(_state_arrays(one), _state_arrays(two))


def test_checkpoint_manager_keeps_three_and_replaces_whole_files(tmp_path):
    """max_to_keep 3, newest first; a save never leaves a temporary file;
    an existing step is replaced only with overwrite."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager

    ck = CheckpointManager(str(tmp_path), prefix="stage1")
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    for step in (1, 2, 3, 4, 5):
        ck.save(step, {"step": step, "w": torch.full((3,), float(step))})
    assert ck.all_steps() == [3, 4, 5] and ck.latest_step() == 5
    assert not [f for f in os.listdir(tmp_path / "stage1") if f.endswith(".tmp")]
    with pytest.raises(FileExistsError):
        ck.save(5, {"step": 0})
    ck.save(5, {"step": 7, "w": torch.zeros(3)}, overwrite=True)
    assert ck.restore()["step"] == 7 and ck.restore(step=4)["w"][0] == 4.0


def test_train_stage1_on_a_tiny_dataset_with_its_eval_hook(tmp_path):
    """Trainer.train_stage1 over 2 epochs of 2 batches (the adversarial
    config): finite losses in the log, a checkpoint per epoch (the last
    three kept), and the default eval hook's PSNR records and saved
    reconstructions."""
    import json

    t = _trainer(tmp_path, adversarial=True)
    state = t.train_stage1(epochs=2)
    assert state.step == 4
    recs = [json.loads(line) for line in open(tmp_path / "train.jsonl")]
    losses = [r["s1/loss"] for r in recs if "s1/loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert all(np.isfinite(r["s1/d_loss"]) for r in recs if "s1/d_loss" in r)
    psnr = [r["eval/psnr"] for r in recs if "eval/psnr" in r]
    assert len(psnr) == 2 and all(np.isfinite(psnr)), recs
    assert not [r for r in recs if "s1/eval_hook_failures" in r]
    assert sorted(os.listdir(tmp_path / "stage1")) == ["2.pt", "4.pt"]
    saved = os.listdir(tmp_path / "recon")
    assert any(f.startswith("ep0") for f in saved) and any(f.startswith("ep1") for f in saved)


def test_port_stage1_never_imports_jax(tmp_path):
    """A fresh interpreter trains stage 1 (adversarial, LPIPS on random
    weights, DiffAugment), resumes it, reconstructs at another resolution
    and hands the checkpoint to stage 2 without loading jax or any module
    of the JAX package."""
    code = textwrap.dedent(f"""
        import sys, warnings
        warnings.simplefilter("ignore")
        import torch
        torch.set_num_threads(1)
        from ddmi_tpu_torch.core.config import config_from_dict
        from ddmi_tpu_torch.core.trainer import Trainer
        from ddmi_tpu_torch.data.synthetic import SyntheticImages
        from ddmi_tpu_torch.domains.image import ImagePipeline
        from ddmi_tpu_torch.evals.lpips import build_perceptual
        d = {_cfg(adversarial=True)!r}
        d["data"]["save_pth"] = {str(tmp_path)!r}
        cfg = config_from_dict(d)
        data = SyntheticImages(2, 64, length=2, seed=0)
        pipe = ImagePipeline(cfg, device="cpu", seed=0, perceptual=build_perceptual(cfg, "cpu"))
        Trainer(cfg, pipe, data).train_stage1(epochs=1)
        pipe = ImagePipeline(cfg, device="cpu", seed=0, perceptual=build_perceptual(cfg, "cpu"))
        st = Trainer(cfg, pipe, data).train_stage1(epochs=1, resume=True)
        assert st.step == 4, st.step
        out = pipe.reconstruct(torch.rand(2, 64, 64, 3), 40)
        assert out.shape == (2, 40, 40, 3)
        d["model"]["params"]["lossconfig"]["adversarial"] = False
        cfg = config_from_dict(d)
        s2 = Trainer(cfg, ImagePipeline(cfg, device="cpu", seed=0), data).train_stage2(epochs=1)
        assert s2.step == 2
        assert "jax" not in sys.modules, "the port loaded jax"
        assert not [m for m in sys.modules if m.split(".")[0] == "ddmi_tpu"]
        print("OK")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=root, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
