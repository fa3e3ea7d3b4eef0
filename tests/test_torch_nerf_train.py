"""NeRF training of the PyTorch port against the JAX package, on the CPU,
at the JAX tests' tiny config (tests/test_nerf.py): 6-value clouds (xyz and
rgb) of 200 points through a pointnet of width 32 (2 blocks) onto 16^2
planes, a triplane VAE at ch 32 (ch_mult [1, 2], the cross-plane blocks at
16^2, no HDBF taps), an INRNeRF of depth 2 and width 32, 64 rays per scene
of a 16^2 view with 16 perturbed samples each, batches of 2 scenes.  The
weights are seeded random draws of JAX's shapes (no leaf zero; the quant
layers scaled as tests/test_torch_occupancy_train.py says), carried by
ddmi_tpu_torch/interop.py; every draw of a micro-step (the three
posteriors' eps, each scene's pixel indices and stratified uniforms, t and
the diffusion noise) is derived from JAX's own keys and fed to the port.

Here: the stage-1 loss and its gradients (fp32 and amp), three
micro-steps with accumulation over 2 against optax, and the stage-2 loss;
tests/test_torch_nerf_trainer.py holds the loaders and the trainer.  The
tolerances are tests/test_torch_occupancy_train.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.interop import (
    mlp_nerf_from_jax, pointnet_from_jax, sn_state_to_jax, triplane_vae_from_jax, unet_from_jax,
)
from test_torch_occupancy_train import (
    DDPM, UNET, check_grads, check_terms, check_window, jax_eps, nchw, random_params, rel,
    scale_quant,
)

torch.set_num_threads(1)

B, RES, N_CLOUD, SPE, R, E = 2, 16, 200, 4, 8, 8
DD = dict(double_z=True, z_channels=32, resolution=16, in_channels=8, out_ch=8, ch=32,
          ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], hdbf_resolutions=[],
          inter_attn_resolutions=[16], attn_type="vanilla")
MLP = dict(in_ch=3, out_ch=4, ch=32, latent_dim=8, D=2, W=32, skips=[1], multires=4,
           multires_views=2, N_samples=16, N_rand=64, white_bkgd=True)


def nerf_cfg(amp=False):
    lc = dict(epochs=2, warmup_epochs=1, gradient_accumulate_every=2, sn_reg=True,
              kl_anneal=False, kl_max_coeff=0.05, lr_scheduler=False, save_and_sample_every=1)
    return {
        "seed": 3,
        "model": {"use_fp16": amp, "amp": amp, "lr": 1e-4, "embed_dim": E,
                  "pointnet": {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 16,
                               "n_blocks": 2},
                  "params": {"lossconfig": lc, "ddconfig": DD, "unetconfig": UNET,
                             "ddpmconfig": DDPM, "mlpconfig": MLP}},
        "data": {"domain": "nerf", "batch_size": B},
    }


def nerf_batch(seed):
    from ddmi_tpu_torch.data.nerf import SyntheticNeRF

    return next(iter(SyntheticNeRF(B, N_CLOUD, RES, length=1, seed=seed)))


def jax_draws(rng, n_rand=64, n_samples=16):
    """The draws JAX's NeRF stage1_loss makes from its key, port layout:
    the posteriors' eps from the encode key, then per scene the pixel
    indices (jax.random.choice without replacement) and the stratified
    uniforms."""
    from ddmi_tpu_torch.domains.triplane import TriplaneDraws

    rng_enc, rng_scene = jax.random.split(rng)
    pixels, uniforms = [], []
    for r in jax.random.split(rng_scene, B):
        rng_pix, rng_ray = jax.random.split(r)
        pixels.append(np.asarray(jax.random.choice(rng_pix, RES * RES, (n_rand,), replace=False)))
        uniforms.append(np.asarray(jax.random.uniform(rng_ray, (n_rand, n_samples))))
    return TriplaneDraws(jax_eps(rng_enc, B, R, E), torch.from_numpy(np.stack(pixels)).long(),
                         torch.from_numpy(np.stack(uniforms)))


class Setup:
    """A JAX NeRFPipeline and the port's on the same stage-1 weights and SN
    vectors (the port's, drawn by init_stage1), with JAX's loss and
    gradient compiled once (`vg`)."""

    def __init__(self, amp=False):
        from ddmi_tpu.domains.nerf import NeRFPipeline as JaxPipe

        d = nerf_cfg(amp)
        self.jcfg, self.cfg = jax_config(d), config_from_dict(d)
        jp = self.jpipe = JaxPipe(self.jcfg)
        planes = tuple(jnp.zeros((1, RES, RES, 8)) for _ in range(3))
        key = jax.random.PRNGKey(0)
        in_dim = jp.mlp.in_channels_xyz + jp.mlp.in_channels_dir
        self.params = {
            "pointnet": random_params(lambda: jp.pointnet.init(key, jnp.zeros((1, 64, 6))), 1),
            "vae": scale_quant(random_params(lambda: jp.vae.init(key, planes, key), 2)),
            "mlp": random_params(lambda: jp.mlp.init(key, jnp.zeros((8, in_dim))), 3),
        }
        jp._stage1_total_iters = SPE * self.cfg.model.lossconfig.epochs
        self.pipe = self.new_pipe()
        self.state = self.pipe.init_stage1(SPE)
        self.sn = sn_state_to_jax(self.state.sn)
        self.vg = jax.jit(jax.value_and_grad(jp.stage1_loss, has_aux=True))

    def new_pipe(self):
        from ddmi_tpu_torch.domains.nerf import NeRFPipeline

        pipe = NeRFPipeline(self.cfg, device="cpu", seed=0)
        pipe.load_state_dicts(**self.port_sds(self.params))
        return pipe

    def port_sds(self, tree):
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
        return {"pointnet": pointnet_from_jax(tree["pointnet"], 2),
                "vae": triplane_vae_from_jax(tree["vae"], self.cfg.model.ddconfig),
                "mlp": mlp_nerf_from_jax(tree["mlp"], 2)}

    def port_names(self, tree):
        return {f"{m}.{k}": v.numpy() for m, sd in self.port_sds(tree).items()
                for k, v in sd.items()}


@pytest.fixture(scope="module")
def s32():
    return Setup()


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("amp", [False, True])
def test_stage1_loss_and_gradients_match_jax(s32, amp):
    """stage1_loss (20 x the L1 of each scene's 64 drawn rays rendered with
    perturbed samples, averaged over the scenes; the KL at its constant
    coefficient; the SN regulariser) and its gradients with respect to
    every pointnet, VAE and INRNeRF parameter against jax.value_and_grad of
    the JAX loss on the same weights, SN vectors and draws.  Under amp the
    VAE and the INRNeRF run bf16 on both sides; rays and compositing stay
    fp32.  The render takes the INRNeRF module, not the MLP kernel."""
    from ddmi_tpu_torch.ops import nerf_mlp

    s = Setup(amp=True) if amp else s32
    batch, key = nerf_batch(5), jax.random.PRNGKey(11)
    (_, (jm, jsn)), jg = s.vg(s.params, s.sn, batch, key, jnp.int32(3))
    nerf_mlp.nerf_mlp_fused.launches = 0
    loss, m, sn = s.pipe.stage1_loss(_tensors(batch), 3, jax_draws(key), s.state.sn)
    loss.backward()
    assert nerf_mlp.nerf_mlp_fused.launches == 0
    grads = {k: p.grad.detach().numpy().copy() for k, p in s.state.params.items()}
    for p in s.state.params.values():
        p.grad = None
    check_terms(m, jm, 1e-2 if amp else 1e-5)
    ref32 = s32.port_names(s32.vg(s32.params, s32.sn, batch, key, jnp.int32(3))[1]) if amp \
        else None
    check_grads(grads, s.port_names(jg), ref32)
    for k, (u, v) in jsn.items():
        assert rel(sn[k][0].numpy(), u) <= 1e-5 and rel(sn[k][1].numpy(), v) <= 1e-5, k


def test_stage1_micro_steps_match_optax(s32):
    """Three stage1_train_step micro-steps with accumulation over 2 against
    JAX's loss gradients fed to optax's AdamW inside MultiSteps (constant
    rate 1e-4), as tests/test_torch_occupancy_train.py holds occupancy's."""
    import copy

    import optax

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
        batch, key = nerf_batch(20 + step), jax.random.PRNGKey(30 + step)
        (_, (jm, sn)), g = s.vg(params, sn, batch, key, jnp.int32(step))
        window = g if step == 0 else jax.tree_util.tree_map(lambda a, b: (a + b) / 2, window, g)
        upd, opt = update(g, opt, params)
        params = optax.apply_updates(params, upd)
        state, m = pipe.stage1_train_step(state, _tensors(batch), draws=jax_draws(key))
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


def test_stage2_loss_matches_jax(s32):
    """stage2_loss (the frozen encode of the batch's cloud sampled with
    JAX's keys, packed [xy | xz | yz]; then the diffusion loss through the
    UNet at JAX's t and noise) within 1e-5 relative, fp32."""
    s = s32
    jp = s.jpipe
    key = jax.random.PRNGKey(0)
    p2 = {"unet": random_params(lambda: jp.unet.init(key, jnp.zeros((1, 8, 8, 24)),
                                                      jnp.zeros((1,), jnp.int32)), 4),
          "mixing_logit": jnp.full((1, 1, 1, 24), -1.0, jnp.float32)}
    batch, rng = nerf_batch(7), jax.random.PRNGKey(12)
    loss, _ = jax.jit(jp.stage2_loss)(p2, s.params, batch, rng)
    rng_enc, rng_diff = jax.random.split(rng)
    rng_t, rng_n = jax.random.split(rng_diff)
    t = torch.from_numpy(np.array(jax.random.randint(rng_t, (B,), 0, 20))).long()
    noise = nchw(jax.random.normal(rng_n, (B, 8, 8, 24), jnp.float32))
    pipe = s.new_pipe()
    pipe.load_state_dicts(unet=unet_from_jax(jax.tree_util.tree_map(np.asarray, p2["unet"]),
                                             s.cfg.model.unetconfig),
                          mixing_logit=np.full(24, -1.0, np.float32))
    pipe.init_stage2()
    got, _ = pipe.stage2_loss(_tensors(batch), t=t, noise=noise, eps=jax_eps(rng_enc, B, R, E))
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss)), (float(got), float(loss))
