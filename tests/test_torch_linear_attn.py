"""`attn_type: linear` in the triplane and video VAEs of the PyTorch port
against the JAX package, on the CPU: both build LinAttnBlock (a bias-free
`to_qkv`, `to_out`, no norm, no residual) through the shared make_attn,
which flax names LinAttnBlock_{n}.

Here: the bridges (interop.triplane_vae_from_jax, video_vae_from_jax) and
their inverse along the VAEs' `jax_layout` (the round trip is bit for
bit), the video decoder's forward against JAX's on the same weights
(1e-4 x max(1, max|ref|), fp32 sums in other orders), the spectral-norm
regulariser's matrices (to_qkv a bias-free conv, in JAX's sorted path
order; bit for bit) and one occupancy stage-1 micro-step with the
regulariser on: the port's fp32 loss terms and refreshed SN vectors
within 1e-5 relative of JAX's, and the port's gradients, taken in float64,
against JAX's fp32 ones as tests/test_torch_occupancy_train.py's
check_grads holds fp32 ones.  The block's output is quadratic in its
input (no norm, no residual), so the stacked blocks magnify fp32
roundoff: the port's fp32 gradients lie up to 1.2e-3 from its own float64
ones, where JAX's fp32 ones lie within 5e-6 of JAX's float64 ones, and
the two float64 runs agree to 6.3e-6 (JAX's LinAttnBlock casts to fp32
inside).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config
from ddmi_tpu_torch.core.config import config_from_dict
from test_torch_occupancy_train import (
    B, Setup, _loss_and_grads, check_grads, check_terms, jax_eps, occ_batch, random_params, rel,
)

torch.set_num_threads(1)


def _leaf(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def _to_jax(sd, key, kind):
    """The JAX leaves of one `jax_layout` entry, from a port state_dict."""
    w = lambda: sd[key + ".weight"].numpy()
    if kind == "gn":
        return {"scale": w(), "bias": sd[key + ".bias"].numpy()}
    if kind == "dense":
        return {"kernel": np.transpose(w()[:, :, 0, 0]), "bias": sd[key + ".bias"].numpy()}
    out = {"kernel": np.transpose(w(), (2, 3, 1, 0))}
    if kind == "conv":
        out["bias"] = sd[key + ".bias"].numpy()
    return out


def _round_trip(sd, layout, tree):
    """Every layout entry mapped back from the port's state_dict equals the
    JAX tree's fp32 leaves bit for bit; -> the LinAttnBlock entries."""
    lin = []
    for key, path, kind in layout:
        ref = _leaf(tree, path)
        if kind == "gn" and "scale" not in ref:
            ref = ref["GroupNorm_0"]
        back = _to_jax(sd, key, kind)
        assert sorted(back) == sorted(ref), (key, path)
        for name, a in back.items():
            assert np.array_equal(a, np.asarray(ref[name], np.float32)), (key, path, name)
        if any(p.startswith("LinAttnBlock_") for p in path):
            lin.append((key, path, kind))
    return lin


def test_triplane_vae_bridge_and_sn_state_at_linear_attention():
    """The triplane VAE at attn_type linear (LinAttnBlocks in the encoder's
    and the decoder's bottleneck and in every cross-plane block): the
    bridge's round trip along jax_layout, the SN matrices in JAX's groups
    and order, and one stage-1 micro-step (loss terms, every gradient and
    the refreshed SN vectors) against jax.value_and_grad of JAX's loss."""
    from ddmi_tpu.core.sn_reg import _collect_conv_mats
    from ddmi_tpu_torch.core.sn_reg import conv_matrices

    s = Setup(attn_type="linear")
    vae = s.pipe.vae
    lin = _round_trip(vae.state_dict(), vae.jax_layout(),
                      jax.tree_util.tree_map(np.asarray, s.params["vae"]))
    kinds = sorted({k for _, _, k in lin})
    # the encoder's and the decoder's bottleneck and mid cross-plane blocks, and the
    # cross-plane blocks at 32^2 and 16^2 on either side: 8 blocks
    assert kinds == ["conv", "conv_nobias"] and len(lin) == 2 * 8, lin
    ref = _collect_conv_mats(s.params["vae"])
    got = conv_matrices(vae)
    assert list(got) == list(ref)
    for k in ref:
        assert len(got[k]) == len(ref[k]), k
        for a, b in zip(got[k], ref[k]):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    from ddmi_tpu_torch.domains.triplane import TriplaneDraws

    batch, key = occ_batch(5), jax.random.PRNGKey(11)
    m, jm, sn, jsn, _, ref = _loss_and_grads(s, batch, key, 3)
    check_terms(m, jm, 1e-5)
    assert float(jm["sn"]) > 0
    for k, (u, v) in jsn.items():
        assert rel(sn[k][0].numpy(), u) <= 1e-5 and rel(sn[k][1].numpy(), v) <= 1e-5, k
    # the port's gradients in float64 against JAX's fp32 ones
    eps = jax_eps(key, B, 8, 8)
    b64 = {k: np.asarray(v, np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
    pipe = s.pipe.double()
    params = pipe.stage1_params()
    for p in params.values():
        p.requires_grad_(True)
    loss, _, _ = pipe.stage1_loss(
        {k: torch.from_numpy(v) for k, v in b64.items()}, 3,
        TriplaneDraws(tuple(e.double() for e in eps)),
        {k: (u.double(), v.double()) for k, (u, v) in s.state.sn.items()})
    grads = dict(zip(params, (g.numpy() for g in torch.autograd.grad(loss, list(params.values())))))
    check_grads(grads, ref)
    assert any(k.endswith(".to_qkv.weight") for k in grads)


VIDEO = {
    "model": {"embed_dim": 4, "params": {
        "ddconfig": dict(double_z=True, timesformer_channels=64, splits=1, patch_size=8,
                         resolution=32, z_channels=8, in_channels=3, out_ch=8, ch=32,
                         ch_mult=[1, 1, 2, 2], num_res_blocks=1, attn_resolutions=[8],
                         hdbf_resolutions=[8, 16], inter_attn_resolutions=[8, 16],
                         attn_type="linear"),
        "mlpconfig": dict(in_ch=2, out_ch=3, ch=32, latent_dim=8),
        "unetconfig": dict(triplane=True, in_channels=4, model_channels=32, out_channels=4,
                           attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
                           num_head_channels=32),
        "ddpmconfig": dict(image_size=4, channels=4, sampling_timesteps=4)}},
    "data": {"domain": "video", "batch_size": 2, "frames": 4, "test_resolution": 32},
}


def test_video_vae_bridge_decoder_and_sn_layout_at_linear_attention():
    """The video VAE at attn_type linear (LinAttnBlocks in the decoder's
    bottleneck and the level at 8^2): video_vae_from_jax's round trip along
    jax_layout, the SN matrices in JAX's groups and order, and the decoder
    (video_decoder_from_jax) against JAX's decode on the same latents."""
    from ddmi_tpu.core.sn_reg import _collect_conv_mats
    from ddmi_tpu.domains.video import VideoPipeline as JaxPipe
    from ddmi_tpu_torch.core.sn_reg import conv_matrices
    from ddmi_tpu_torch.domains.video import VideoPipeline
    from ddmi_tpu_torch.interop import video_decoder_from_jax, video_vae_from_jax

    jcfg, cfg = jax_config(VIDEO), config_from_dict(VIDEO)
    jp = JaxPipe(jcfg)
    params = random_params(lambda: {"params": jp.init_stage1_params(jax.random.PRNGKey(0))}, 4)
    vae_tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params["vae"])
    pipe = VideoPipeline(cfg, device="cpu", seed=0)
    pipe.load_state_dicts(vae=video_vae_from_jax(vae_tree, cfg.model.ddconfig))
    vae = pipe.vae
    lin = _round_trip(vae.state_dict(), vae.jax_layout(), vae_tree)
    # the bottleneck's and the two of the level at 8^2
    assert len(lin) == 2 * 3 and sorted({k for _, _, k in lin}) == ["conv", "conv_nobias"]
    ref = _collect_conv_mats(params["vae"])
    got = conv_matrices(vae)
    assert list(got) == list(ref)
    for k in ref:
        for a, b in zip(got[k], ref[k]):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    dec = video_decoder_from_jax(vae_tree, cfg.model.ddconfig)
    assert all(torch.equal(v, vae.state_dict()[k]) for k, v in dec.items())
    z = np.random.default_rng(3).standard_normal((2, jp.n_latent_tokens, 4)).astype(np.float32)
    want = jax.jit(lambda p, z: jp.vae.apply({"params": p}, z, method=jp.vae.decode))(
        vae_tree, jnp.asarray(z))
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(z))
    for g_pyr, r_pyr in zip(out, want):
        for g, r in zip(g_pyr, r_pyr):
            r = np.asarray(r)
            g = g.permute(0, 2, 3, 1).numpy()
            assert np.abs(g - r).max() <= 1e-4 * max(1.0, float(np.abs(r).max()))
