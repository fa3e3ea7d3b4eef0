"""Weight bridge of the PyTorch port (ddmi_tpu_torch/interop.py): JAX param
trees -> port state_dicts, checked as an exact round trip through the JAX
package's own converters (ddmi_tpu/interop/reference_ckpt.py), and a fresh
interpreter running the port never loads JAX."""

import dataclasses
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
    _convert_triplane_decoder,
    _convert_video_decoder,
    _dense_from_1x1,
    _Source,
    convert_mlp_image,
    convert_mlp_nerf,
    convert_mlp_video,
    convert_unet,
    convert_unet_triplane,
    convert_vae,
)
from ddmi_tpu_torch.interop import (
    mlp_image_from_jax,
    mlp_nerf_from_jax,
    mlp_video_from_jax,
    triplane_decoder_from_jax,
    triplane_unet_from_jax,
    unet_from_jax,
    vae_from_jax,
    video_decoder_from_jax,
)

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


def _shapes(init):
    """The "params" tree of `init()` as shapes (jax.eval_shape: no flax init
    runs); every test here replaces each leaf with _random_tree's values."""
    return jax.eval_shape(init)["params"]


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

    t = _shapes(lambda: UNet(UNET).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)
    ))
    t = _random_tree(t, 1)
    sd = unet_from_jax(t, UNET)
    TorchUNet(UNET).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_unet(sd, UNET), t)


def test_vae_decoder_bridge_round_trip_is_exact():
    from ddmi_tpu.nn.vae import Autoencoder
    from ddmi_tpu_torch.nn.vae import Autoencoder as TorchAE

    t = _shapes(lambda: Autoencoder(DD, embed_dim=4).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16, 3)),
        jax.random.PRNGKey(1),
    ))
    t = _random_tree(t, 2)
    sd = vae_from_jax(t, DD)
    TorchAE(DD, embed_dim=4).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_vae({k: v.numpy() for k, v in sd.items()}, DD), t)


def test_mlp_bridge_round_trip_is_exact():
    from ddmi_tpu.nn.inr import INRImage
    from ddmi_tpu_torch.nn.inr import INRImage as TorchINR

    hdbf = [jnp.zeros((1, r, r, 8)) for r in (4, 8, 16)]
    t = _shapes(lambda: INRImage(MLP).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 5, 2)), hdbf, 1.0,
    ))
    t = _random_tree(t, 3)
    sd = mlp_image_from_jax(t, MLP)
    TorchINR(MLP).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_mlp_image(sd, MLP), t)


TRIPLANE = UNetConfig(
    in_channels=8, model_channels=64, out_channels=8, num_res_blocks=1,
    attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=16,
    plane_sizes=((4, 4), (4, 4), (4, 4)),
)
VIDEO_DD = DDConfig(
    double_z=True, timesformer_channels=64, patch_size=8, splits=1, resolution=32,
    z_channels=32, out_ch=8, ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1,
    hdbf_resolutions=(8, 16), inter_attn_resolutions=(4, 8),
    attn_type="vanilla-multihead",
)


def test_triplane_unet_bridge_round_trip_is_exact():
    from ddmi_tpu.nn.unet_triplane import TriplaneUNet
    from ddmi_tpu_torch.nn.unet_triplane import TriplaneUNet as TorchUNet

    t = _shapes(lambda: TriplaneUNet(TRIPLANE).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 48, 8)), jnp.zeros((1,), jnp.int32)
    ))
    t = _random_tree(t, 4)
    sd = triplane_unet_from_jax(t, TRIPLANE)
    TorchUNet(TRIPLANE).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_unet_triplane(sd, TRIPLANE), t)


def test_video_decoder_bridge_round_trip_is_exact():
    from ddmi_tpu.nn.video_vae import VideoAutoencoder
    from ddmi_tpu_torch.nn.video_vae import VideoAutoencoder as TorchAE

    t = _shapes(lambda: VideoAutoencoder(VIDEO_DD, embed_dim=8, frames=4).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, 32, 32, 3)),
        jax.random.PRNGKey(1),
    ))
    t = _random_tree(t, 5)
    sd = video_decoder_from_jax(t, VIDEO_DD)
    TorchAE(VIDEO_DD, embed_dim=8, frames=4).load_state_dict(sd, strict=True)
    src = _Source(sd)
    dec = _convert_video_decoder(src.sub("decoder."), VIDEO_DD)
    post = {f"post_{p}": _dense_from_1x1(src, f"post_{p}") for p in ("xy", "xt", "yt")}
    src.finish()
    _assert_trees_equal(dec, t["decoder"])
    _assert_trees_equal(post, {k: t[k] for k in post})


def test_mlp_video_bridge_round_trip_is_exact():
    from ddmi_tpu.nn.inr import INRVideo
    from ddmi_tpu_torch.nn.inr import INRVideo as TorchINR

    cfg = MLPConfig(in_ch=3, out_ch=3, ch=32, latent_dim=8)
    hdbf = tuple([jnp.zeros(s) for s in shapes] for shapes in (
        [(1, r, r, 8) for r in (4, 8, 16)], [(1, 4, r, 8) for r in (4, 8, 16)],
        [(1, 4, r, 8) for r in (4, 8, 16)]))
    axes = {"axes": (jnp.linspace(-1, 1, 2), jnp.linspace(-1, 1, 3), jnp.linspace(-1, 1, 3))}
    t = _shapes(lambda: INRVideo(cfg).init({"params": jax.random.PRNGKey(0)}, axes, hdbf))
    t = _random_tree(t, 6)
    sd = mlp_video_from_jax(t)
    TorchINR(cfg).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_mlp_video(sd), t)


NERF_DD = DDConfig(
    double_z=True, z_channels=16, resolution=16, in_channels=8, out_ch=8, ch=32,
    ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), hdbf_resolutions=(8,),
    inter_attn_resolutions=(16, 8), attn_type="vanilla",
)


def test_triplane_decoder_bridge_round_trip_is_exact():
    from ddmi_tpu.nn.triplane_vae import TriplaneAutoencoder
    from ddmi_tpu_torch.nn.triplane_vae import TriplaneAutoencoder as TorchAE

    planes = tuple(jnp.zeros((1, 16, 16, 8)) for _ in range(3))
    t = _shapes(lambda: TriplaneAutoencoder(NERF_DD, embed_dim=4).init(
        {"params": jax.random.PRNGKey(0)}, planes, jax.random.PRNGKey(1)
    ))
    t = _random_tree(t, 7)
    sd = triplane_decoder_from_jax(t, NERF_DD)
    TorchAE(NERF_DD, embed_dim=4).load_state_dict(sd, strict=True)
    src = _Source(sd)
    dec = _convert_triplane_decoder(src.sub("decoder."), NERF_DD)
    post = {f"post_{p}": _dense_from_1x1(src, f"post_quant_conv_{p}") for p in ("xy", "yz", "xz")}
    src.finish()
    _assert_trees_equal(dec, t["decoder"])
    _assert_trees_equal(post, {k: t[k] for k in post})


def test_mlp_nerf_bridge_round_trip_is_exact():
    from ddmi_tpu.nn.inr import INRNeRF
    from ddmi_tpu_torch.nn.inr import INRNeRF as TorchNeRF

    t = _shapes(lambda: INRNeRF(depth=6, width=64, in_channels_xyz=39, in_channels_dir=15,
                                skips=(2, 4)).init(jax.random.PRNGKey(0), jnp.zeros((4, 54))))
    t = _random_tree(t, 8)
    sd = mlp_nerf_from_jax(t, 6)
    TorchNeRF(6, 64, 39, 15, (2, 4)).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_mlp_nerf(sd, depth=6), t)


def test_linear_attention_vae_bridge_round_trip_is_exact():
    """attn_type linear (LinAttnBlock at 8 x 8 and in both mid blocks)."""
    import dataclasses

    from ddmi_tpu.nn.vae import Autoencoder
    from ddmi_tpu_torch.nn.vae import Autoencoder as TorchAE

    dd = dataclasses.replace(DD, attn_type="linear", attn_resolutions=(8,))
    t = _shapes(lambda: Autoencoder(dd, embed_dim=4).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16, 3)),
        jax.random.PRNGKey(1),
    ))
    assert "LinAttnBlock_1" in t["encoder"] and "LinAttnBlock_1" in t["decoder"]
    t = _random_tree(t, 9)
    sd = vae_from_jax(t, dd)
    TorchAE(dd, embed_dim=4).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_vae({k: v.numpy() for k, v in sd.items()}, dd), t)


def test_discriminator_bridge_round_trip_is_exact():
    """The PatchGAN: JAX -> port (strict load) -> JAX, scale offsets and all."""
    from ddmi_tpu.losses.gan import GANLoss2D
    from ddmi_tpu_torch.interop import discriminator_from_jax, discriminator_to_jax
    from ddmi_tpu_torch.losses.gan import GANLoss2D as TorchGAN

    x = jnp.zeros((1, 32, 32, 3))
    t = _random_tree(_shapes(lambda: GANLoss2D().init(jax.random.PRNGKey(0), x, x, False, 1.0)),
                     10)
    sd = discriminator_from_jax(t)
    TorchGAN(3).load_state_dict(sd, strict=True)
    _assert_trees_equal(discriminator_to_jax(sd), t)


def test_lpips_bridge_round_trip_is_exact():
    """LPIPS: JAX -> the reference checkpoint layout (the port's LPIPS loads
    it strictly) -> the JAX package's own load_torch_weights."""
    from ddmi_tpu.evals.lpips import LPIPS, load_torch_weights
    from ddmi_tpu_torch.evals.lpips import LPIPS as TorchLPIPS
    from ddmi_tpu_torch.interop import lpips_from_jax

    x = jnp.zeros((1, 32, 32, 3))
    t = _random_tree(_shapes(lambda: LPIPS().init(jax.random.PRNGKey(0), x, x)), 11)
    sd = lpips_from_jax(t)
    m = TorchLPIPS()
    m.load_state_dict(sd, strict=True)
    assert torch.equal(m.net.features[28].weight, sd["features.28.weight"])
    _assert_trees_equal(load_torch_weights(sd, sd), t)


def test_sn_state_bridge_round_trip_is_exact():
    """The spectral-norm state: JAX -> port -> JAX; its groups are the
    port's own (core/sn_reg.py) on the same VAE."""
    from ddmi_tpu.core.sn_reg import init_sn_state
    from ddmi_tpu.nn.vae import Autoencoder
    from ddmi_tpu_torch.core.sn_reg import conv_matrices
    from ddmi_tpu_torch.interop import sn_state_from_jax, sn_state_to_jax
    from ddmi_tpu_torch.nn.vae import Autoencoder as TorchAE

    t = Autoencoder(DD, embed_dim=4).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16, 3)),
        jax.random.PRNGKey(1),
    )["params"]
    state = jax.tree_util.tree_map(np.asarray, init_sn_state(t, jax.random.PRNGKey(7)))
    ours = sn_state_from_jax(state)
    tm = TorchAE(DD, embed_dim=4)
    tm.load_state_dict(vae_from_jax(jax.tree_util.tree_map(np.asarray, t), DD))
    groups = conv_matrices(tm)
    assert set(groups) == set(state)
    for k, (u, v) in ours.items():
        assert u.shape == (len(groups[k]),) + groups[k][0].shape[:1]
        assert v.shape == (len(groups[k]),) + groups[k][0].shape[1:]
    back = sn_state_to_jax(ours)
    for k, (u, v) in state.items():
        assert np.array_equal(back[k][0], u) and np.array_equal(back[k][1], v)


def test_port_nerf_service_never_imports_jax():
    """A fresh interpreter serves a tiny NeRF config (2 DDIM steps, a
    width-256 MLP, so the render goes through the kernel wrapper's plain
    version) without loading jax or any module of the JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        from ddmi_tpu_torch.core.config import config_from_dict
        from ddmi_tpu_torch.ops import nerf_mlp
        from ddmi_tpu_torch.serve.server import SamplerService
        cfg = config_from_dict({"model": {"embed_dim": 4, "params": {
            "unetconfig": dict(in_channels=12, model_channels=32, out_channels=12,
                               attention_resolutions=[2], num_res_blocks=1,
                               channel_mult=[1, 2], num_head_channels=16),
            "ddconfig": dict(z_channels=16, resolution=16, out_ch=8, ch=32,
                             ch_mult=[1, 2], num_res_blocks=1, hdbf_resolutions=[],
                             inter_attn_resolutions=[16]),
            "mlpconfig": dict(D=2, W=256, skips=[1], multires=2, multires_views=1,
                              N_samples=8),
            "ddpmconfig": dict(timesteps=20, channels=12, sampling_timesteps=2)}},
            "data": {"domain": "nerf"}})
        s = SamplerService(cfg, service_batch=2, resolution=8, n_views=2, device="cpu",
                           allow_init=True)
        assert s.pipe.fold_mlp() is not None
        out = s.generate(1, seed=0)
        s.close()
        assert out.shape == (1, 2, 8, 8, 3) and out.dtype.name == "uint8", out.shape
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
        s = SamplerService(cfg, service_batch=2, device="cpu", allow_init=True)
        out = s.generate(1, seed=0)
        s.close()
        assert out.shape == (1, 16, 16, 3), out.shape
        from ddmi_tpu_torch.ops import attention, flash_attention, mea
        vcfg = config_from_dict({"model": {"embed_dim": 8, "params": {
            "unetconfig": dict(in_channels=8, model_channels=64, out_channels=8,
                               num_res_blocks=1, attention_resolutions=[2],
                               channel_mult=[1, 2], num_head_channels=16),
            "ddconfig": dict(resolution=32, z_channels=32, out_ch=8, ch=32,
                             ch_mult=[1, 1, 2, 2], num_res_blocks=1,
                             hdbf_resolutions=[8, 16], inter_attn_resolutions=[4, 8],
                             attn_type="vanilla-multihead"),
            "mlpconfig": dict(ch=32, latent_dim=8),
            "ddpmconfig": dict(timesteps=20, channels=8, sampling_timesteps=2)}},
            "data": {"domain": "video", "frames": 4}})
        s = SamplerService(vcfg, service_batch=2, device="cpu", allow_init=True)
        out = s.generate(1, seed=0)
        s.close()
        assert out.shape == (1, 4, 32, 32, 3), out.shape
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
    stage-2 config and on the skytimelapse stage-2 and stage-1 configs."""
    import dataclasses

    from ddmi_tpu.core.config import load_config as jax_load
    from ddmi_tpu_torch.core.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("ldm/celebahq.yaml", "ldm/afhq.yaml", "ldm/celebahq_tpu.yaml",
                 "ldm/skytimelapse.yaml", "d2c-vae/skytimelapse.yaml"):
        path = os.path.join(root, "configs", name)
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


def test_video_vae_bridge_round_trip_is_exact():
    """The whole video VAE (TimeSformer, class tokens and positions, the
    pooling transformers, pre_* and the decode half): every JAX leaf lands
    in a port key and every key of the port's VideoAutoencoder
    (with_encoder) is filled, strictly; the JAX package's
    reference_ckpt.convert_video_vae reads it back bit for bit."""
    from ddmi_tpu.interop.reference_ckpt import convert_video_vae
    from ddmi_tpu.nn.video_vae import VideoAutoencoder
    from ddmi_tpu_torch.interop import video_vae_from_jax
    from ddmi_tpu_torch.nn.video_vae import VideoAutoencoder as TorchAE

    dd = dataclasses.replace(VIDEO_DD, timesformer_channels=32)
    t = _shapes(lambda: VideoAutoencoder(dd, embed_dim=8, frames=4).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, 32, 32, 3)), jax.random.PRNGKey(1)))
    t = _random_tree(t, 7)
    sd = video_vae_from_jax(t, dd)
    TorchAE(dd, embed_dim=8, frames=4, with_encoder=True).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_video_vae({k: v.numpy() for k, v in sd.items()}, dd), t)


def test_discriminator3d_bridge_round_trip_is_exact():
    """The video PatchGAN pair (2D on a frame, 3D on the clip): the port's
    GANLoss3D loads the bridged state strictly, and discriminator3d_to_jax
    gives JAX's tree back bit for bit."""
    from ddmi_tpu.losses.gan import GANLoss3D
    from ddmi_tpu_torch.interop import discriminator3d_from_jax, discriminator3d_to_jax
    from ddmi_tpu_torch.losses.gan import GANLoss3D as TorchGAN

    x = jnp.zeros((1, 4, 16, 16, 3))
    t = _random_tree(_shapes(lambda: GANLoss3D().init(jax.random.PRNGKey(0), x, x, False)), 8)
    sd = discriminator3d_from_jax(t)
    TorchGAN(3).load_state_dict(sd, strict=True)
    _assert_trees_equal(discriminator3d_to_jax(sd), t)
