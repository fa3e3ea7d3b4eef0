"""Accumulation windows of the ported video train steps against the JAX
package's, on the CPU (tests/test_torch_video_train.py holds the config,
the weights and the draws: the same JAX state and draws on both sides,
LPIPS on a random VGG; tests/test_torch_video_gan_steps.py runs the
adversarial config's windows).  Stage 1 runs with lossconfig.lr_scheduler
off, the video domain's constant rate (the image domain keeps a warm-up
there), so its updates at the windows' ends move the parameters.  The
tolerances are stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddmi_tpu_torch.interop import discriminator3d_from_jax
from test_torch_video_train import (
    B, Setup, _rel, _video, jit_optimized, stage1_draws, stage2_draws, stage2_setup, unet_grads,
)

torch.set_num_threads(1)

STEPS, ACCUM = 4, 2

# convs followed by a batch norm: their bias cannot change the loss, so its
# gradient is roundoff on both sides, and Adam moves it by +-lr either way
_BN_BIASES = tuple(f"{d}.convs.{i}.bias" for d in ("disc2d", "disc3d") for i in (1, 2, 3))


def _sync_disc(state, jst):
    """Copy JAX's discriminators and their optimizer state into the port's."""
    tree = lambda t: discriminator3d_from_jax(jax.tree_util.tree_map(np.asarray, t))
    with torch.no_grad():
        for k, v in tree(jst.disc_params).items():
            state.disc[k].copy_(v)
        adam = jst.disc_opt_state[0]
        for ours, ref in ((state.disc_opt.mu, adam.mu), (state.disc_opt.nu, adam.nu)):
            ref = tree(ref)
            for t, k in zip(ours, state.disc):
                t.copy_(ref[k])
        state.disc_opt.count = int(adam.count)


def _check_first_update(now, start, ref_now, ref_start, lr):
    """Adam's first update moves each element by lr * g / (|g| + eps), about
    lr * sign(g) for the window's mean gradient g: every element moves at
    most lr, and over all parameters at least 99% move in JAX's direction
    (the rest have a gradient at roundoff level, where the sign is
    roundoff's)."""
    agree = total = 0
    for k, r in ref_now.items():
        d, rd = now[k] - start[k], r - ref_start[k]
        assert np.abs(d).max() <= 1.01 * lr, k
        agree += int(np.sum(np.sign(d) == np.sign(rd)))
        total += d.size
    assert agree >= 0.99 * total, (agree, total)


def _check_moments(ours, ref, names, scale=1.0):
    """Every Adam moment within 1e-3 relative (L2) plus 1e-5 of its kind's
    global norm, both times `scale`."""
    total = np.sqrt(sum(float(np.sum(np.square(r))) for r in ref.values()))
    for t, k in zip(ours, names):
        err = np.linalg.norm(t.numpy() - ref[k])
        assert err <= scale * (1e-3 * np.linalg.norm(ref[k]) + 1e-5 * total), k


def test_stage1_train_steps_match_jax():
    """Two accumulation windows of the plain config (run_stage1_windows)."""
    run_stage1_windows(adversarial=False)


def run_stage1_windows(adversarial):
    """Two accumulation windows (4 micro-steps) of stage1_train_step against
    JAX's (jit) on the same state and draws, LPIPS included, plain and with
    the 2D + 3D PatchGAN pair.  The parameters change at micro-steps 2 and
    4 only (a constant rate from the first update), the SN state at every
    one, the accumulator is zero after each window.  In the first window:
    each micro-step's loss terms within 1e-4 relative; the Adam moments
    within 1e-3 relative (L2) plus 1e-5 of their kind's global norm; the SN
    vectors within 1e-4 relative; the update as _check_first_update holds
    it.  That update leaves the two runs' weights apart where Adam's
    normalised step took opposite signs (up to 2 lr an element whose
    gradient is roundoff), so the second window's bars are ten times the
    first's.  The discriminators start each micro-step from JAX's state
    (one Adam step on a hinge loss magnifies roundoff several-fold per
    step) and change at every one; in the first window their parameters
    after the update are held to JAX's within 1e-4 relative, but for the
    few elements (at most 0.1%) whose gradient is near zero, where Adam's
    first normalised step (about lr * sign(g)) may take roundoff's sign, a
    difference of at most 2 lr.  For the 3D discriminator that share is 5%:
    XLA's fp32 gradients of 3D convolutions on the CPU lie up to 0.12 x
    max|g| from float64 (test_torch_video_modules.py holds the port's
    against JAX's in float64).  The biases before a batch norm, whose
    gradient is roundoff, are held only to |change| <= lr."""
    s = Setup(adversarial=adversarial, lr_scheduler=False)
    jp, pipe, state, tx = s.jpipe, s.pipe, s.state, s.tx
    # the adversarial step's 3D discriminator runs about ten times faster
    # compiled with optimisations, which outweighs their compile time
    jit = jit_optimized if adversarial else jax.jit
    jstep = jit(lambda st, x, rng: jp.stage1_train_step(tx, st, x, rng, s.pp))
    jst = s.jstate
    prev = {k: v.detach().clone().numpy() for k, v in state.params.items()}
    prev_sn = {k: u.clone() for k, (u, _) in state.sn.items()}
    lr = s.cfg.model.lr
    for step in range(STEPS):
        x, rng = _video(60 + step), jax.random.PRNGKey(200 + step)
        if adversarial:
            _sync_disc(state, jst)
            before = {k: v.detach().clone() for k, v in state.disc.items()}
        jax_prev = jst.params
        jst, jm = jstep(jst, jnp.asarray(x), rng)
        draws, _ = stage1_draws(rng, adversarial)
        state, m = pipe.stage1_train_step(state, torch.from_numpy(x), draws=draws)
        scale = 1.0 if step < ACCUM else 10.0
        for k in jm:
            r = float(jm[k])
            assert abs(float(m[k]) - r) <= scale * 1e-4 * abs(r), (step, k, float(m[k]), r)
        now = {k: v.detach().clone().numpy() for k, v in state.params.items()}
        changed = [k for k in now if not np.array_equal(now[k], prev[k])]
        assert (len(changed) > 0) == (step % ACCUM == ACCUM - 1), (step, changed[:3])
        if step % ACCUM == 0:
            win_start, ref_win_start = prev, s.port_names(jax_prev)
        prev = now
        assert any(not torch.equal(prev_sn[k], u) for k, (u, _) in state.sn.items()), step
        prev_sn = {k: u.clone() for k, (u, _) in state.sn.items()}
        if adversarial:
            ref = discriminator3d_from_jax(jax.tree_util.tree_map(np.asarray, jst.disc_params))
            for k, v in state.disc.items():
                assert not torch.equal(before[k], v), (step, k)
                if step >= ACCUM:
                    continue
                if k in _BN_BIASES:
                    assert (v - before[k]).abs().max() <= 1.01 * lr, (step, k)
                    continue
                got, want = v.detach().numpy(), ref[k].numpy()
                flip = np.abs(got - want) > 1e-6 * np.abs(want).max()
                share = 5e-2 if k.startswith("disc3d.") else 1e-3
                assert flip.mean() <= share and np.abs(got - want).max() <= 2.02 * lr, (step, k)
                assert _rel(got[~flip], want[~flip]) <= 1e-4, (step, k)
        if step % ACCUM:
            inner = jst.opt_state.inner_opt_state[0]
            for ours, ref in ((state.opt.inner.mu, inner.mu), (state.opt.inner.nu, inner.nu)):
                _check_moments(ours, s.port_names(ref), list(state.params), scale)
            assert all(not a.any() for a in state.opt.acc)
            for k, (u, v) in jst.sn_state.items():
                assert _rel(state.sn[k][0].numpy(), u) <= scale * 1e-4
                assert _rel(state.sn[k][1].numpy(), v) <= scale * 1e-4
            if step < ACCUM:
                _check_first_update(now, win_start, s.port_names(jst.params), ref_win_start, lr)
    assert state.step == STEPS and state.opt.gradient_step == STEPS // ACCUM


def test_stage2_train_steps_match_jax():
    """One accumulation window (2 micro-steps) of stage2_train_step against
    JAX's (jit) on the same weights and draws (fp32): each micro-step's loss
    within 1e-5 relative; the parameters unchanged after the first and
    changed after the second; the Adam moments within 1e-3 relative plus
    1e-5 of their kind's global norm; the parameters' changes as
    _check_first_update holds them; the EMA (a copy of the parameters at
    micro-step 0, before update_after_step) equal to JAX's within 1e-6."""
    s = Setup(perceptual=False)
    jst, pipe, state = stage2_setup(s)
    p1 = s.jstate.params
    tx = s.jpipe.stage2_optimizer()
    jst = jst.replace(opt_state=tx.init(jst.params))
    jstep = jax.jit(lambda st, x, rng: s.jpipe.stage2_train_step(tx, st, p1, x, rng))
    cfg_unet = s.jpipe.unet.cfg
    start = {k: v.detach().clone().numpy() for k, v in state.params.items()}
    ref_start = unet_grads(cfg_unet, jst.params)
    for step in range(ACCUM):
        x, rng = _video(70 + step), jax.random.PRNGKey(300 + step)
        jst, aux = jstep(jst, jnp.asarray(x), rng)
        eps, t, noise = stage2_draws(rng)
        state, m = pipe.stage2_train_step(state, torch.from_numpy(x), t=t, noise=noise, eps=eps)
        assert abs(float(m["loss"]) - float(aux["loss"])) <= 1e-5 * abs(float(aux["loss"]))
        now = {k: v.detach().numpy() for k, v in state.params.items()}
        changed = [k for k in now if not np.array_equal(now[k], start[k])]
        assert (len(changed) > 0) == (step == ACCUM - 1), (step, changed[:3])
    inner = jst.opt_state.inner_opt_state[0]
    for ours, ref in ((state.opt.inner.mu, inner.mu), (state.opt.inner.nu, inner.nu)):
        _check_moments([t.float() for t in ours], unet_grads(cfg_unet, ref), list(state.params))
    now = {k: v.detach().clone().numpy() for k, v in state.params.items()}
    _check_first_update(now, start, unet_grads(cfg_unet, jst.params), ref_start, s.cfg.model.lr)
    ema_ref = unet_grads(cfg_unet, jst.ema_params)
    for k, e in state.ema.items():
        assert _rel(e.numpy(), ema_ref[k]) <= 1e-6, k
    assert state.step == ACCUM and B == 2
