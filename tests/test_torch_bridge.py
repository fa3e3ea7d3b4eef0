"""Weight bridge of the PyTorch port (ddmi_tpu_torch/interop.py): JAX param
trees -> port state_dicts, checked as an exact round trip through the JAX
package's own converters (ddmi_tpu/interop/reference_ckpt.py), and a fresh
interpreter running the port never loads JAX."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddmi_tpu.core.config import DDConfig, MLPConfig, UNetConfig
from ddmi_tpu.interop.reference_ckpt import (
    _convert_vae_decoder,
    _Source,
    convert_mlp_image,
    convert_unet,
)
from ddmi_tpu_torch.interop import mlp_image_from_jax, unet_from_jax, vae_decoder_from_jax

torch.set_num_threads(1)

UNET = UNetConfig(
    image_size=8, in_channels=4, model_channels=32, out_channels=4,
    num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
    num_head_channels=32,
)
DD = DDConfig(
    z_channels=8, resolution=16, out_ch=8, ch=32, ch_mult=(1, 1, 2),
    num_res_blocks=1, hdbf_resolutions=(8, 4), attn_type="vanilla",
)
MLP = MLPConfig(in_ch=2, out_ch=3, ch=32, latent_dim=8)


def _random_tree(tree, seed):
    """Replace every leaf with seeded random values (bit-exactness is the
    point here, so no leaf may be a constant that hides a transpose)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), tree
    )


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape)
        assert np.array_equal(a, b), path


def test_unet_bridge_round_trip_is_exact():
    from ddmi_tpu.nn.unet import UNet
    from ddmi_tpu_torch.nn.unet import UNet as TorchUNet

    t = UNet(UNET).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)
    )["params"]
    t = _random_tree(t, 1)
    sd = unet_from_jax(t, UNET)
    TorchUNet(UNET).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_unet(sd, UNET), t)


def test_vae_decoder_bridge_round_trip_is_exact():
    from ddmi_tpu.nn.vae import Autoencoder
    from ddmi_tpu_torch.nn.vae import Autoencoder as TorchAE

    t = Autoencoder(DD, embed_dim=4).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16, 3)),
        jax.random.PRNGKey(1),
    )["params"]
    t = _random_tree(t, 2)
    sd = vae_decoder_from_jax(t, DD)
    TorchAE(DD, embed_dim=4).load_state_dict(sd, strict=True)
    src = _Source(sd)
    dec = _convert_vae_decoder(src.sub("decoder."), DD)
    pqc = {"kernel": np.transpose(src.pop("post_quant_conv.weight"), (2, 3, 1, 0)),
           "bias": src.pop("post_quant_conv.bias")}
    src.finish()
    _assert_trees_equal(dec, t["decoder"])
    _assert_trees_equal(pqc, t["post_quant_conv"])


def test_mlp_bridge_round_trip_is_exact():
    from ddmi_tpu.nn.inr import INRImage
    from ddmi_tpu_torch.nn.inr import INRImage as TorchINR

    hdbf = [jnp.zeros((1, r, r, 8)) for r in (4, 8, 16)]
    t = INRImage(MLP).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 5, 2)), hdbf, 1.0,
    )["params"]
    t = _random_tree(t, 3)
    sd = mlp_image_from_jax(t, MLP)
    TorchINR(MLP).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_mlp_image(sd, MLP), t)


def test_port_slice_never_imports_jax():
    """A fresh interpreter imports the port and runs the whole slice (a
    tiny config, 2 DDIM steps, through the service) without loading jax or
    any module of the JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        import ddmi_tpu_torch
        from ddmi_tpu_torch.core.config import config_from_dict
        from ddmi_tpu_torch import interop
        from ddmi_tpu_torch.ops import attn_block, build, inr_decode
        from ddmi_tpu_torch.serve.server import SamplerService
        cfg = config_from_dict({"model": {"use_fp16": False, "embed_dim": 4, "params": {
            "unetconfig": dict(image_size=4, in_channels=4, model_channels=32,
                               out_channels=4, attention_resolutions=[2],
                               num_res_blocks=1, channel_mult=[1, 2],
                               num_head_channels=32),
            "ddconfig": dict(z_channels=8, resolution=16, out_ch=8, ch=32,
                             ch_mult=[1, 1, 2], num_res_blocks=1,
                             hdbf_resolutions=[8, 4]),
            "mlpconfig": dict(ch=32, latent_dim=8),
            "ddpmconfig": dict(image_size=4, channels=4, sampling_timesteps=2)}},
            "data": {"domain": "image", "test_resolution": 16}})
        s = SamplerService(cfg, service_batch=2, allow_init=True)
        out = s.generate(1, seed=0)
        s.close()
        assert out.shape == (1, 16, 16, 3), out.shape
        assert "jax" not in sys.modules, "the port loaded jax"
        assert not [m for m in sys.modules if m.split(".")[0] == "ddmi_tpu"]
        print("OK")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", code], capture_output=True, text=True,
        env=env, cwd=root, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_port_config_reader_matches_jax():
    """The port's own YAML reader (ddmi_tpu_torch/core/config.py) gives the
    JAX package's values for every field the port reads, on each image
    stage-2 config."""
    import dataclasses

    from ddmi_tpu.core.config import load_config as jax_load
    from ddmi_tpu_torch.core.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("celebahq.yaml", "afhq.yaml", "celebahq_tpu.yaml"):
        path = os.path.join(root, "configs", "ldm", name)
        ours, ref = load_config(path), jax_load(path)
        pairs = [(ours.model, ref.model), (ours.data, ref.data)] + [
            (getattr(ours.model, k), getattr(ref.model, k))
            for k in ("unetconfig", "ddconfig", "mlpconfig", "ddpmconfig")
        ]
        for a, b in pairs:
            for f in dataclasses.fields(a):
                if f.name == "extra" or dataclasses.is_dataclass(getattr(a, f.name)):
                    continue
                assert getattr(a, f.name) == getattr(b, f.name), (name, f.name)
