"""Two accumulation windows of the ported stage-1 train step against the
JAX package's, on the CPU, plain and adversarial (tests/
test_torch_stage1_train.py holds the config, the weights and the draws:
the same JAX state and draws on both sides, LPIPS on a random VGG).  The
tolerances are stated in each test.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu_torch.interop import discriminator_from_jax
from test_torch_stage1_train import STEPS, _FeedNoise, _Setup, _inputs, _port_draws, _rel

torch.set_num_threads(1)


def _check_params(now, start, ref_now, ref_start, steady, lr_total):
    """Each parameter's change from the start within 1e-2 relative (L2) of
    JAX's (Adam's step divides each element's mean gradient by its own
    RMS, so where a window's gradients nearly cancel the gradients'
    1e-4-level differences come out magnified) over the elements whose
    gradient is steady (above 1e-3 of the
    tensor's RMS in every window: Adam moves an element by about lr *
    sign(gradient) whatever its size, so where the gradient is roundoff so
    is the direction); the rest move at most the summed learning rates."""
    for k, r in ref_now.items():
        d, rd, m = now[k] - start[k], r - ref_start[k], steady[k]
        if m.any():
            assert _rel(d[m], rd[m]) <= 1e-2, (k, _rel(d[m], rd[m]))
        assert np.abs(d[~m]).max(initial=0.0) <= 1.01 * lr_total, k


def _sync_disc(state, jst):
    """Copy JAX's discriminator and its optimizer state into the port's."""
    with torch.no_grad():
        for k, v in discriminator_from_jax(
                jax.tree_util.tree_map(np.asarray, jst.disc_params)).items():
            state.disc[k].copy_(v)
        adam = jst.disc_opt_state[0]
        for ours, ref in ((state.disc_opt.mu, adam.mu), (state.disc_opt.nu, adam.nu)):
            ref = discriminator_from_jax(jax.tree_util.tree_map(np.asarray, ref))
            for t, k in zip(ours, state.disc):
                t.copy_(ref[k])
        state.disc_opt.count = int(adam.count)


# convs followed by a batch norm: their bias cannot change the loss, so its
# gradient is roundoff on both sides, and Adam moves it by +-lr either way
_BN_BIASES = ("discriminator.convs.1.bias", "discriminator.convs.2.bias",
              "discriminator.convs.3.bias")


@pytest.mark.parametrize("adversarial", [False, True])
def test_stage1_train_steps_match_jax(adversarial):
    """Two accumulation windows (10 micro-steps) of stage1_train_step
    against JAX's (jit) on the same state and draws, LPIPS included, for
    the plain config and the adversarial one with every DiffAugment
    policy.  The parameters are bit-unchanged through micro-step 9 (the
    first optimizer update has rate 0) and change at 10; the SN state
    changes at every micro-step (power iteration goes on while the weights
    stand still), the discriminator at every one.  Each micro-step's loss
    terms within 1e-4 relative.  After each window every Adam moment
    within 1e-3 relative (L2) plus 1e-5 of its kind's global norm (the
    first conv's gradient comes back through LPIPS, the INR and the whole
    VAE), the accumulator zero, the SN vectors within 1e-4 relative; after
    10 the parameters (see _check_params).

    The discriminator's trajectory is not comparable over many steps: at
    this size one step of Adam (lr 1e-3, b1 0.5) on a hinge loss amplifies
    a 1e-7 change of its weights about fivefold per step (0.2% after six
    steps).  So each micro-step starts the port's discriminator from JAX's
    state, and its parameters after the update are held to JAX's within
    1e-4 relative, about 2e-3 of one update's size (Adam's first steps
    normalise the gradient, so roundoff in small gradients shows in full;
    the biases before a batch norm, whose gradient is roundoff, only to
    |change| <= lr)."""
    s = _Setup(adversarial=adversarial)
    jp, pipe, state, tx = s.jpipe, s.pipe, s.state, s.tx

    def jstep(st, x, rng, noise):
        with fnn.intercept_methods(_FeedNoise(noise)):
            return jp.stage1_train_step(tx, st, x, rng, s.pp)

    jstep = jax.jit(jstep)
    jst = s.jstate
    start = {k: v.detach().clone().numpy() for k, v in state.params.items()}
    ref_start = s.port_names(jst.params)
    prev, prev_sn = start, {k: u.clone() for k, (u, _) in state.sn.items()}
    steady = {k: np.ones(v.shape, bool) for k, v in start.items()}
    lr = s.cfg.model.lr
    for step in range(STEPS):
        x, noise, rng = _inputs(step)
        if adversarial:
            _sync_disc(state, jst)
            before = {k: v.detach().clone() for k, v in state.disc.items()}
        jst, jm = jstep(jst, jnp.asarray(x), rng, [jnp.asarray(a) for a in noise])
        state, m = pipe.stage1_train_step(state, torch.from_numpy(x),
                                          draws=_port_draws(rng, noise, adversarial))
        for k in jm:
            r = float(jm[k])
            assert abs(float(m[k]) - r) <= 1e-4 * abs(r), (step, k, float(m[k]), r)
        now = {k: v.detach().clone().numpy() for k, v in state.params.items()}
        changed = [k for k in now if not np.array_equal(now[k], prev[k])]
        assert (len(changed) > 0) == (step == STEPS - 1), (step, changed[:3])
        prev = now
        assert any(not torch.equal(prev_sn[k], u) for k, (u, _) in state.sn.items()), step
        prev_sn = {k: u.clone() for k, (u, _) in state.sn.items()}
        if adversarial:
            ref = discriminator_from_jax(jax.tree_util.tree_map(np.asarray, jst.disc_params))
            for k, v in state.disc.items():
                assert not torch.equal(before[k], v), (step, k)
                if k in _BN_BIASES:
                    assert (v - before[k]).abs().max() <= 1.01 * lr, (step, k)
                else:
                    assert _rel(v.detach().numpy(), ref[k].numpy()) <= 1e-4, (step, k)
        if step % 5 == 3:  # the running mean of the window's first four gradients
            acc = s.port_names(jst.opt_state.acc_grads)
            total = np.sqrt(sum(float(np.sum(np.square(g))) for g in acc.values()))
            for k, g in acc.items():
                # a conv bias just before a one-channel GroupNorm group (ch 32)
                # cannot change the loss: its whole gradient is roundoff
                rms = np.sqrt(np.mean(np.square(g)))
                steady[k] &= (np.abs(g) > 1e-3 * rms) & (np.linalg.norm(g) > 1e-5 * total)
        if step % 5 == 4:
            inner = jst.opt_state.inner_opt_state[0]
            for ours, ref in ((state.opt.inner.mu, inner.mu), (state.opt.inner.nu, inner.nu)):
                ref = s.port_names(ref)
                total = np.sqrt(sum(float(np.sum(np.square(r))) for r in ref.values()))
                for t, k in zip(ours, state.params):
                    err = np.linalg.norm(t.numpy() - ref[k])
                    assert err <= 1e-3 * np.linalg.norm(ref[k]) + 1e-5 * total, (step, k)
            assert all(not a.any() for a in state.opt.acc)
            for k, (u, v) in jst.sn_state.items():
                assert _rel(state.sn[k][0].numpy(), u) <= 1e-4
                assert _rel(state.sn[k][1].numpy(), v) <= 1e-4
    _check_params(prev, start, s.port_names(jst.params), ref_start, steady,
                  s.state.opt.inner.lr(1))
    assert state.step == STEPS and state.opt.gradient_step == 2
