"""Module parity of the PyTorch port against the JAX package on shared
weights (converted with ddmi_tpu_torch/interop.py) and shared numpy inputs:
UNet, VAE decoder, INRImage, and the DDIM loop.

fp32 tolerance: max|diff| <= 1e-4 * max(1, max|ref|), because the two
frameworks sum in different orders.  Zero-initialised parameters (ResBlock
and UNet output convs, attention proj_out, biases) are replaced by seeded
random values so that no branch of a module is silently skipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddmi_tpu.core.config import DDConfig, DDPMConfig, MLPConfig, UNetConfig
from ddmi_tpu_torch.interop import mlp_image_from_jax, unet_from_jax, vae_from_jax

torch.set_num_threads(1)


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _perturb_zeros(tree, seed, skip=("noise",)):
    """Seeded N(0, 0.05^2) values for every all-zero leaf (outside `skip`)."""
    rng = np.random.default_rng(seed)

    def go(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = v if k in skip else go(v)
            else:
                a = np.asarray(v)
                if not a.any():
                    a = (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
                out[k] = a
        return out

    return go(tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


UNET = UNetConfig(
    image_size=8, in_channels=4, model_channels=32, out_channels=4,
    num_res_blocks=1, attention_resolutions=(2, 4), channel_mult=(1, 2, 2),
    num_head_channels=32,
)


def test_unet_matches_jax():
    from ddmi_tpu.nn.unet import UNet
    from ddmi_tpu_torch.nn.unet import UNet as TorchUNet

    jm = UNet(UNET)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32))
    p = _perturb_zeros(p["params"], 1)
    m = TorchUNet(UNET)
    m.load_state_dict(unet_from_jax(p, UNET))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 917], np.int32)
    ref = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = m(_nchw(x), torch.from_numpy(t).long())
    _close(_nhwc(got), ref, "unet")


DD = DDConfig(
    z_channels=8, resolution=16, out_ch=8, ch=32, ch_mult=(1, 1, 2),
    num_res_blocks=1, hdbf_resolutions=(8, 4), attn_type="vanilla",
)


def test_vae_decoder_matches_jax():
    from ddmi_tpu.nn.vae import Autoencoder
    from ddmi_tpu_torch.nn.vae import Autoencoder as TorchAE

    jm = Autoencoder(DD, embed_dim=4)
    p = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16, 3)),
                jax.random.PRNGKey(1))["params"]
    p = _perturb_zeros(p, 3)
    m = TorchAE(DD, embed_dim=4)
    m.load_state_dict(vae_from_jax(p, DD))
    z = np.random.default_rng(4).standard_normal((2, 4, 4, 4)).astype(np.float32)
    ref = jm.apply({"params": p}, jnp.asarray(z), method=jm.decode)
    with torch.no_grad():
        got = m.decode(_nchw(z))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _close(_nhwc(g), r, "hdbf plane")


def test_inr_image_matches_jax():
    from ddmi_tpu.nn.inr import INRImage
    from ddmi_tpu.ops.resample import pixel_center_lin
    from ddmi_tpu_torch.nn.inr import INRImage as TorchINR
    from ddmi_tpu_torch.ops.resample import pixel_center_lin as torch_lin

    cfg = MLPConfig(in_ch=2, out_ch=3, ch=32, latent_dim=8)
    jm = INRImage(cfg)
    rng = np.random.default_rng(5)
    planes = [rng.standard_normal((2, r, r, 8)).astype(np.float32) for r in (4, 8, 16)]
    p = jm.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                None, [jnp.asarray(a) for a in planes], 1.0,
                grid_1d=(pixel_center_lin(4), pixel_center_lin(4)))["params"]
    p = _perturb_zeros(p, 6)  # noise gains stay 0: the draws differ by design
    m = TorchINR(cfg)
    m.load_state_dict(mlp_image_from_jax(p, cfg))
    xs, ys = pixel_center_lin(12), pixel_center_lin(10)
    ref = jm.apply({"params": p}, None, [jnp.asarray(a) for a in planes], 0.5,
                   grid_1d=(xs, ys), rngs={"noise": jax.random.PRNGKey(2)})
    with torch.no_grad():
        got = m([_nchw(a) for a in planes], 0.5, grid_1d=(torch_lin(12), torch_lin(10)))
    _close(got, ref, "INRImage")


def test_ddim_loop_matches_jax():
    """Same fixed noise, eta 0, a learned mixing logit, and a simple
    deterministic denoiser on both sides."""
    from ddmi_tpu.diffusion import process as jp
    from ddmi_tpu_torch.diffusion import process as tp

    cfg = DDPMConfig(image_size=4, channels=3, sampling_timesteps=10)
    rng = np.random.default_rng(8)
    noise = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    logit = rng.standard_normal((1, 1, 1, 3)).astype(np.float32)
    wt = 1e-3 * rng.standard_normal(3).astype(np.float32)

    def jfn(x, t):
        return jnp.tanh(0.9 * x + t.astype(jnp.float32)[:, None, None, None] * wt)

    def tfn(x, t):
        return torch.tanh(0.9 * x + t.float()[:, None, None, None] * torch.from_numpy(wt)[:, None, None])

    ref = jp.ddim_sample(jp.GaussianDiffusion.from_config(cfg), jfn, jnp.asarray(logit),
                         noise.shape, jax.random.PRNGKey(0), noise=jnp.asarray(noise))
    got = tp.ddim_sample(tp.GaussianDiffusion.from_config(cfg), tfn,
                         torch.from_numpy(np.transpose(logit, (0, 3, 1, 2))).contiguous(),
                         (2, 3, 4, 4), noise=_nchw(noise))
    _close(_nhwc(got), ref, "ddim")


def test_unet_attention_block_hands_its_parameters_to_the_block_entry(monkeypatch):
    """With no gradient recorded, the UNet's AttentionBlock calls the block
    entry with its own parameter tensors (the same storage as qkv.weight,
    proj_out.weight and the norm's), so no weight is copied per call, and its
    output is the block's on the JAX layout."""
    from ddmi_tpu_torch.nn.unet import AttentionBlock
    from ddmi_tpu_torch.ops import attn_block

    torch.manual_seed(0)
    block = AttentionBlock(128, 4)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    seen = []
    entry = attn_block.attention_block

    def spy(*args, **kw):
        seen.append(args)
        return entry(*args, **kw)

    monkeypatch.setattr(attn_block, "attention_block", spy)
    x = torch.from_numpy(rng.standard_normal((2, 128, 8, 8)).astype(np.float32))
    with torch.no_grad():
        out = block(x)
    (args,) = seen
    owned = (block.norm.weight, block.norm.bias, block.qkv.weight, block.qkv.bias,
             block.proj_out.weight, block.proj_out.bias)
    assert all(a is p and a.data_ptr() == p.data_ptr() for a, p in zip(args[1:7], owned))
    with torch.no_grad():
        wq, bq, wp = attn_block.module_to_jax_layout(block.qkv.weight, block.qkv.bias,
                                                     block.proj_out.weight, 4)
        ref = attn_block.attention_block_plain(x.permute(0, 2, 3, 1), block.norm.weight,
                                               block.norm.bias, wq, bq, wp,
                                               block.proj_out.bias, 4, 32**-0.5)
    _close(out.permute(0, 2, 3, 1), ref, "AttentionBlock vs the plain block")
