"""Weight bridge: JAX parameter trees (numpy arrays) -> port `state_dict`s.

The exact inverse of the converters in
ddmi_tpu/interop/reference_ckpt.py that the ported slices need: for images
`convert_unet`, `convert_vae` and `convert_mlp_image`; for video
`convert_unet_triplane`, the decoder half of `convert_video_vae` and
`convert_mlp_video`; for NeRF the decoder half of `convert_triplane_vae` and
`convert_mlp_nerf` (the UNet is the image one); for occupancy
`convert_triplane_vae` whole, `convert_mlp_3d` and `convert_pointnet`.  For
stage-1 training: LPIPS into the reference checkpoint layout (the JAX
package's evals/lpips.py::load_torch_weights reads it back), and the
PatchGAN and the spectral-norm state, which the JAX package has no
converter for (`*_to_jax` give the inverses).  The port's modules use the
reference PyTorch layouts, so every map here is a transpose, reshape or channel
permutation and the round trip is bit-exact:

  * Flax Conv (kh, kw, I, O)   -> Conv2d (O, I, kh, kw)
  * Flax 1x1 Conv (1, 1, I, O) -> Conv1d (O, I, 1)        [ADM attention]
  * Flax Dense (I, O)          -> Linear (O, I)
  * GroupNorm scale / bias     -> weight / bias
  * ModulatedConv (k, k, I, O) -> (1, O, I, k, k)
  * Flax Dense (I, O) over tokens -> Conv1d (O, I, 1)   [1D attention]
  * Flax Dense (I, O) over planes -> 1x1 Conv2d (O, I, 1, 1) [video post_*,
                                                    triplane post_quant_conv_*]
  * ADM qkv: qkv-major output channels -> head-major (QKVAttentionLegacy)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ddmi_tpu_torch.nn.unet import qkv_permutation
from ddmi_tpu_torch.nn.vae import jax_layout

SD = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _conv(sd: SD, key: str, p) -> None:
    sd[key + ".weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    sd[key + ".bias"] = _t(p["bias"])


def _conv1d(sd: SD, key: str, kernel, bias) -> None:
    sd[key + ".weight"] = _t(np.transpose(np.asarray(kernel)[0], (2, 1, 0)))
    sd[key + ".bias"] = _t(bias)


def _dense(sd: SD, key: str, p) -> None:
    sd[key + ".weight"] = _t(np.transpose(p["kernel"]))
    sd[key + ".bias"] = _t(p["bias"])


def _gn(sd: SD, key: str, p) -> None:
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])


def _resnet_fc(sd: SD, key: str, p) -> None:
    """ResnetBlockFC {fc_0, fc_1, shortcut (bias-free)?}."""
    _dense(sd, key + ".fc_0", p["fc_0"])
    _dense(sd, key + ".fc_1", p["fc_1"])
    if "shortcut" in p:
        sd[key + ".shortcut.weight"] = _t(np.transpose(p["shortcut"]["kernel"]))


# ------------------------------------------------------------------- UNet


def _heads(ch: int, cfg) -> int:
    if cfg.num_head_channels != -1:
        return max(1, ch // cfg.num_head_channels)
    return max(1, cfg.num_heads)


def _adm_resblock(sd: SD, key: str, p) -> None:
    _gn(sd, key + ".in_layers.0", p["norm_in"])
    _conv(sd, key + ".in_layers.2", p["conv_in"])
    _dense(sd, key + ".emb_layers.1", p["emb_proj"])
    _gn(sd, key + ".out_layers.0", p["norm_out"])
    _conv(sd, key + ".out_layers.3", p["conv_out"])
    if "skip" in p:
        _conv(sd, key + ".skip_connection", p["skip"])


def _adm_attn(sd: SD, key: str, p, num_heads: int) -> None:
    C = np.asarray(p["qkv"]["kernel"]).shape[2]
    inv = np.argsort(qkv_permutation(num_heads, C // num_heads))
    _gn(sd, key + ".norm", p["norm"])
    _conv1d(sd, key + ".qkv", np.asarray(p["qkv"]["kernel"])[..., inv],
            np.asarray(p["qkv"]["bias"])[inv])
    _conv1d(sd, key + ".proj_out", p["proj_out"]["kernel"], p["proj_out"]["bias"])


def unet_from_jax(tree, cfg) -> SD:
    """JAX UNet params (nn/unet.py) -> port UNet state_dict (walks the same
    ADM block layout as reference_ckpt.convert_unet)."""
    sd: SD = {}
    _dense(sd, "time_embed.0", tree["time_dense1"])
    _dense(sd, "time_embed.2", tree["time_dense2"])
    _conv(sd, "input_blocks.0.0", tree["conv_in"])
    mc = cfg.model_channels
    idx, ds, ch = 1, 1, mc
    for level, mult in enumerate(cfg.channel_mult):
        for i in range(cfg.num_res_blocks):
            key = f"input_blocks.{idx}"
            _adm_resblock(sd, key + ".0", tree[f"down_{level}_{i}"])
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                _adm_attn(sd, key + ".1", tree[f"down_attn_{level}_{i}"], _heads(ch, cfg))
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            _conv(sd, f"input_blocks.{idx}.0.op", tree[f"downsample_{level}"]["Conv_0"])
            idx += 1
            ds *= 2
    _adm_resblock(sd, "middle_block.0", tree["mid_block1"])
    _adm_attn(sd, "middle_block.1", tree["mid_attn"], _heads(ch, cfg))
    _adm_resblock(sd, "middle_block.2", tree["mid_block2"])
    idx = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            key = f"output_blocks.{idx}"
            _adm_resblock(sd, key + ".0", tree[f"up_{level}_{i}"])
            ch = mult * mc
            sub = 1
            if ds in cfg.attention_resolutions:
                _adm_attn(sd, f"{key}.{sub}", tree[f"up_attn_{level}_{i}"], _heads(ch, cfg))
                sub += 1
            if level != 0 and i == cfg.num_res_blocks:
                _conv(sd, f"{key}.{sub}.conv", tree[f"upsample_{level}"]["Conv_0"])
                ds //= 2
            idx += 1
    _gn(sd, "out.0", tree["norm_out"])
    _conv(sd, "out.2", tree["conv_out"])
    return sd


# ------------------------------------------------------------ VAE decoder


def _vae_resnet(sd: SD, key: str, p) -> None:
    _gn(sd, key + ".norm1", p["Norm_0"]["GroupNorm_0"])
    _conv(sd, key + ".conv1", p["Conv_0"])
    _gn(sd, key + ".norm2", p["Norm_1"]["GroupNorm_0"])
    _conv(sd, key + ".conv2", p["Conv_1"])
    if "nin_shortcut" in p:
        _conv(sd, key + ".nin_shortcut", p["nin_shortcut"])


def _vae_attn(sd: SD, key: str, p) -> None:
    _gn(sd, key + ".norm", p["Norm_0"]["GroupNorm_0"])
    for name in ("q", "k", "v", "proj_out"):
        _conv(sd, f"{key}.{name}", p[name])


def vae_from_jax(tree, cfg) -> SD:
    """JAX Autoencoder params (nn/vae.py) -> state_dict of the port's
    Autoencoder (`encoder.*`, `quant_conv.*`, `decoder.*`,
    `post_quant_conv.*`), any attn_type; inverts reference_ckpt.convert_vae
    along the port's `jax_layout`."""
    sd: SD = {}
    for key, path, kind in jax_layout(cfg):
        p = tree
        for name in path:
            p = p[name]
        if kind == "gn":
            _gn(sd, key, p)
        elif kind == "conv":
            _conv(sd, key, p)
        else:
            sd[key + ".weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    return sd


# -------------------------------------------------------------- INR (MLP)


def _modconv(sd: SD, key: str, p) -> None:
    sd[key + ".weight"] = _t(np.transpose(p["weight"], (3, 2, 0, 1))[None])
    sd[key + ".modulation.weight"] = _t(np.transpose(p["modulation"]["weight"]))
    sd[key + ".modulation.bias"] = _t(p["modulation"]["bias"])


def mlp_image_from_jax(tree, cfg) -> SD:
    """JAX INRImage params (nn/inr.py) -> port INRImage state_dict (the
    reference MLP's keys); inverts reference_ckpt.convert_mlp_image."""
    sd: SD = {}
    _dense(sd, "time_mlp.1", tree["Dense_0"])
    _dense(sd, "time_mlp.3", tree["Dense_1"])
    for b in ("net_res1", "net_res2", "net_res3", "net_res4"):
        blk = tree[b]
        for c in ("conv1", "conv2", "conv3"):
            key = f"{b}.{c}"
            _modconv(sd, key + ".conv", blk[c]["conv"])
            sd[key + ".noise.weight"] = _t(np.asarray(blk[c]["noise"]["weight"]).reshape(1))
            sd[key + ".activate.bias"] = _t(blk[c]["act_bias"])
        if "skip" in blk:
            w = np.asarray(blk["skip"]["EqualLinear_0"]["weight"])  # (I, O)
            sd[f"{b}.skip.0.weight"] = _t(np.transpose(w)[:, :, None, None])
    _modconv(sd, "torgb.conv", tree["torgb"]["conv"])
    bias = np.asarray(tree["torgb"]["bias"])
    sd["torgb.bias"] = _t(bias.reshape(1, -1, 1, 1))
    return sd


# ----------------------------------------------------------------- video


def _attn1d(sd: SD, key: str, p) -> None:
    """AttnBlock1D[Expand] -> reference MemoryEfficientAttnBlock1D[_expand]."""
    _gn(sd, key + ".norm", p["GroupNormTokens_0"]["GroupNorm_0"])
    for name in ("q", "k", "v", "proj_out"):
        sd[f"{key}.{name}.weight"] = _t(np.transpose(p[name]["kernel"])[:, :, None])
        sd[f"{key}.{name}.bias"] = _t(p[name]["bias"])


def triplane_unet_from_jax(tree, cfg) -> SD:
    """JAX TriplaneUNet params (nn/unet_triplane.py) -> port TriplaneUNet
    state_dict; inverts reference_ckpt.convert_unet_triplane."""
    sd = unet_from_jax(tree, cfg)
    idx = 1
    for level in range(len(cfg.channel_mult)):
        for i in range(cfg.num_res_blocks):
            _attn1d(sd, f"input_attns.{idx}", tree[f"down_xattn_{level}_{i}"])
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            _attn1d(sd, f"input_attns.{idx}", tree[f"down_xattn_ds_{level}"])
            idx += 1
    _attn1d(sd, "mid_attn", tree["mid_xattn"])
    idx = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            _attn1d(sd, f"output_attns.{idx}", tree[f"up_xattn_{level}_{i}"])
            idx += 1
    return sd


def video_decoder_from_jax(tree, cfg) -> SD:
    """JAX VideoAutoencoder params (nn/video_vae.py) -> state_dict of the
    port's decode-only VideoAutoencoder (`decoder.*`, `post_{xy,xt,yt}.*`).
    Inverts the decoder half of reference_ckpt.convert_video_vae; the
    encoder is not read."""
    if cfg.attn_type not in ("vanilla", "vanilla-multihead", "none"):
        raise NotImplementedError(f"attn_type {cfg.attn_type!r} is not ported")
    dec = tree["decoder"]
    sd: SD = {}
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    ab = 0
    _vae_resnet(sd, "decoder.mid.block_1", dec["mid_block1"])
    if cfg.attn_type != "none":
        _vae_attn(sd, "decoder.mid.attn_1", dec[f"AttnBlock_{ab}"])
        ab += 1
    _vae_resnet(sd, "decoder.mid.block_2", dec["mid_block2"])
    _attn1d(sd, "decoder.mid_attn", dec["mid_inter_attn"])
    n = len(cfg.ch_mult)
    curr = cfg.resolution // 2 ** (n - 1)
    for i in reversed(range(n)):
        for j in range(cfg.num_res_blocks + 1):
            _vae_resnet(sd, f"decoder.up.{i}.block.{j}", dec[f"up_{i}_{j}"])
            if curr in cfg.attn_resolutions:
                _vae_attn(sd, f"decoder.up.{i}.attn.{j}", dec[f"AttnBlock_{ab}"])
                ab += 1
        if curr in cfg.inter_attn_resolutions:
            _attn1d(sd, f"decoder.up.{i}.inter_attn.0", dec[f"inter_attn_{i}"])
        if curr in cfg.hdbf_resolutions:
            _conv(sd, f"decoder.up.{i}.hdbf.0", dec[f"hdbf_{curr}"])
        if i != 0:
            _conv(sd, f"decoder.up.{i}.upsample.conv", dec[f"upsample_{i}"]["Conv_0"])
            curr *= 2
    _gn(sd, "decoder.norm_out", dec["norm_out"]["GroupNorm_0"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    for plane in ("xy", "xt", "yt"):
        p = tree[f"post_{plane}"]
        sd[f"post_{plane}.weight"] = _t(np.transpose(p["kernel"])[:, :, None, None])
        sd[f"post_{plane}.bias"] = _t(p["bias"])
    return sd


def mlp_video_from_jax(tree) -> SD:
    """JAX INRVideo params (nn/inr.py) -> port INRVideo state_dict (the
    reference MLPVideo's keys); inverts reference_ckpt.convert_mlp_video."""
    sd: SD = {}
    for i in (1, 2, 3, 4):
        _resnet_fc(sd, f"net_res{i}", tree[f"net_res{i}"])
    _dense(sd, "net_out", tree["net_out"])
    return sd


# ------------------------------------------------------------------ NeRF


def _inter_plane(sd: SD, key_a: str, key_attn: str, key_b: str, p) -> None:
    """JAX InterPlaneBlock {block_a, AttnBlock_0?, block_b} -> the
    reference's [ResnetBlock(3c), attn(3c), ResnetBlock(3c)] keys."""
    _vae_resnet(sd, key_a, p["block_a"])
    if "AttnBlock_0" in p:
        _vae_attn(sd, key_attn, p["AttnBlock_0"])
    _vae_resnet(sd, key_b, p["block_b"])


def triplane_decoder_from_jax(tree, cfg) -> SD:
    """JAX TriplaneAutoencoder params (nn/triplane_vae.py) -> state_dict of
    the port's decode-only TriplaneAutoencoder (`decoder.*`,
    `post_quant_conv_{xy,yz,xz}.*`).  Inverts the decoder half of
    reference_ckpt.convert_triplane_vae; the encoder is not read."""
    if cfg.attn_type not in ("vanilla", "vanilla-multihead", "none"):
        raise NotImplementedError(f"attn_type {cfg.attn_type!r} is not ported")
    dec = tree["decoder"]
    sd: SD = {}
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    ab = 0
    _vae_resnet(sd, "decoder.mid.block_1", dec["mid_block1"])
    if cfg.attn_type != "none":
        _vae_attn(sd, "decoder.mid.attn_1", dec[f"AttnBlock_{ab}"])
        ab += 1
    _vae_resnet(sd, "decoder.mid.block_2", dec["mid_block2"])
    _inter_plane(sd, "decoder.mid.block_3", "decoder.mid_attn", "decoder.mid.block_4",
                 dec["mid_inter"])
    n = len(cfg.ch_mult)
    curr = cfg.resolution // 2 ** (n - 1)
    for i in reversed(range(n)):
        for j in range(cfg.num_res_blocks + 1):
            _vae_resnet(sd, f"decoder.up.{i}.block.{j}", dec[f"up_{i}_{j}"])
            if curr in cfg.attn_resolutions:
                _vae_attn(sd, f"decoder.up.{i}.attn.{j}", dec[f"AttnBlock_{ab}"])
                ab += 1
        if curr in cfg.inter_attn_resolutions:
            key = f"decoder.up.{i}.inter_attn"
            _inter_plane(sd, key + ".0", key + ".1", key + ".2", dec[f"inter_{i}"])
        if curr in cfg.hdbf_resolutions:
            _conv(sd, f"decoder.up.{i}.hdbf.0", dec[f"hdbf_{curr}"])
        if i != 0:
            _conv(sd, f"decoder.up.{i}.upsample.conv", dec[f"upsample_{i}"]["Conv_0"])
            curr *= 2
    _gn(sd, "decoder.norm_out", dec["norm_out"]["GroupNorm_0"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    for plane in ("xy", "yz", "xz"):
        p = tree[f"post_{plane}"]
        sd[f"post_quant_conv_{plane}.weight"] = _t(np.transpose(p["kernel"])[:, :, None, None])
        sd[f"post_quant_conv_{plane}.bias"] = _t(p["bias"])
    return sd


def triplane_vae_from_jax(tree, cfg) -> SD:
    """JAX TriplaneAutoencoder params -> state_dict of the port's whole
    TriplaneAutoencoder (`with_encoder=True`): the decoder half of
    `triplane_decoder_from_jax`, the encoder (`encoder.*`) and the quant
    convs `quant_conv_{xy,yz,xz}`.  Inverts reference_ckpt.convert_triplane_vae."""
    sd = triplane_decoder_from_jax(tree, cfg)
    enc = tree["encoder"]
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    ab = 0
    n = len(cfg.ch_mult)
    curr = cfg.resolution
    for i in range(n):
        for j in range(cfg.num_res_blocks):
            _vae_resnet(sd, f"encoder.down.{i}.block.{j}", enc[f"down_{i}_{j}"])
            if curr in cfg.attn_resolutions:
                _vae_attn(sd, f"encoder.down.{i}.attn.{j}", enc[f"AttnBlock_{ab}"])
                ab += 1
        if curr in cfg.inter_attn_resolutions:
            key = f"encoder.down.{i}.inter_attn"
            _inter_plane(sd, key + ".0", key + ".1", key + ".2", enc[f"inter_{i}"])
        if i != n - 1:
            _conv(sd, f"encoder.down.{i}.downsample.conv", enc[f"downsample_{i}"]["Conv_0"])
            curr //= 2
    _vae_resnet(sd, "encoder.mid.block_1", enc["mid_block1"])
    if cfg.attn_type != "none":
        _vae_attn(sd, "encoder.mid.attn_1", enc[f"AttnBlock_{ab}"])
    _vae_resnet(sd, "encoder.mid.block_2", enc["mid_block2"])
    _inter_plane(sd, "encoder.mid.block_3", "encoder.mid_attn", "encoder.mid.block_4",
                 enc["mid_inter"])
    _gn(sd, "encoder.norm_out", enc["norm_out"]["GroupNorm_0"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    for plane in ("xy", "yz", "xz"):
        p = tree[f"quant_{plane}"]
        sd[f"quant_conv_{plane}.weight"] = _t(np.transpose(p["kernel"])[:, :, None, None])
        sd[f"quant_conv_{plane}.bias"] = _t(p["bias"])
    return sd


def mlp3d_from_jax(tree) -> SD:
    """JAX INR3D params (nn/inr.py) -> port INR3D state_dict (the reference
    MLP3D's keys); inverts reference_ckpt.convert_mlp_3d."""
    sd: SD = {}
    _dense(sd, "net_p", tree["net_p"])
    sd.update(mlp_video_from_jax(tree))
    return sd


def pointnet_from_jax(tree, n_blocks: int) -> SD:
    """JAX LocalPoolPointnet params (nn/pointnet.py) -> port
    LocalPoolPointnet state_dict (`fc_pos`, `blocks.{i}`, `fc_c`); inverts
    reference_ckpt.convert_pointnet."""
    sd: SD = {}
    _dense(sd, "fc_pos", tree["fc_pos"])
    for i in range(n_blocks):
        _resnet_fc(sd, f"blocks.{i}", tree[f"block{i}"])
    _dense(sd, "fc_c", tree["fc_c"])
    return sd


def mlp_nerf_from_jax(tree, depth: int) -> SD:
    """JAX INRNeRF params (nn/inr.py) -> port INRNeRF state_dict (the
    reference MLPNeRF's keys, Linear at index 0 of each Sequential);
    inverts reference_ckpt.convert_mlp_nerf."""
    sd: SD = {}
    for i in range(1, depth + 1):
        _dense(sd, f"xyz_encoding_{i}.0", tree[f"xyz_encoding_{i}"])
    _dense(sd, "xyz_encoding_final", tree["xyz_encoding_final"])
    _dense(sd, "dir_encoding.0", tree["dir_encoding"])
    _dense(sd, "sigma", tree["sigma"])
    _dense(sd, "rgb.0", tree["rgb"])
    return sd


# ------------------------------------------------------- stage-1 training


def discriminator_from_jax(tree) -> SD:
    """JAX GANLoss2D params {"discriminator": {Conv_k, SyncBatchNorm_k}} ->
    state_dict of the port's GANLoss2D (`discriminator.convs.{k}`,
    `discriminator.norms.{k}.scale` (the offset from 1, as JAX stores it)
    and `.bias`)."""
    d = tree["discriminator"]
    sd: SD = {}
    k = 0
    while f"Conv_{k}" in d:
        _conv(sd, f"discriminator.convs.{k}", d[f"Conv_{k}"])
        k += 1
    k = 0
    while f"SyncBatchNorm_{k}" in d:
        sd[f"discriminator.norms.{k}.scale"] = _t(d[f"SyncBatchNorm_{k}"]["scale"])
        sd[f"discriminator.norms.{k}.bias"] = _t(d[f"SyncBatchNorm_{k}"]["bias"])
        k += 1
    return sd


def discriminator_to_jax(sd: SD) -> dict:
    """The inverse of `discriminator_from_jax` (numpy leaves)."""
    d: dict = {}
    for key, t in sd.items():
        _, group, k, name = key.split(".")
        a = t.detach().cpu().numpy()
        if group == "convs":
            d.setdefault(f"Conv_{k}", {})["kernel" if name == "weight" else "bias"] = (
                np.transpose(a, (2, 3, 1, 0)) if name == "weight" else a)
        else:
            d.setdefault(f"SyncBatchNorm_{k}", {})[name] = a
    return {"discriminator": d}


def lpips_from_jax(tree) -> SD:
    """JAX LPIPS params {"vgg": {conv0..conv12}, lin0..lin4} -> the reference
    LPIPS checkpoint layout (torchvision `features.{i}` and
    `lin{i}.model.1.weight`), which the port's LPIPS loads and the JAX
    package's evals/lpips.py::load_torch_weights reads back."""
    from ddmi_tpu_torch.evals.lpips import VGG16_CFG

    sd: SD = {}
    conv = layer = 0
    for v in VGG16_CFG:
        if v == "M":
            layer += 1
            continue
        _conv(sd, f"features.{layer}", tree["vgg"][f"conv{conv}"])
        conv += 1
        layer += 2
    for i in range(5):
        if f"lin{i}" in tree:
            sd[f"lin{i}.model.1.weight"] = _t(np.asarray(tree[f"lin{i}"]).reshape(1, -1, 1, 1))
    return sd


def sn_state_from_jax(state) -> Dict[str, tuple]:
    """JAX spectral-norm state {f"{out}x{fan_in}": (u, v)} -> the port's,
    unchanged: the port keeps JAX's groups, matrix order and (kh, kw, in)
    column order (core/sn_reg.py)."""
    return {k: (_t(u), _t(v)) for k, (u, v) in state.items()}


def sn_state_to_jax(state) -> Dict[str, tuple]:
    return {k: (u.detach().cpu().numpy(), v.detach().cpu().numpy()) for k, (u, v) in state.items()}
