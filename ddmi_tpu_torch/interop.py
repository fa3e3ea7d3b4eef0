"""Weight bridge: JAX parameter trees (numpy arrays) -> port `state_dict`s.

The exact inverse of the converters in
ddmi_tpu/interop/reference_ckpt.py that the ported slices need: for images
`convert_unet` (and the JAX UNet's label embedding and spatial
transformers, which that converter does not map), `convert_mdt`,
`convert_vae` and `convert_mlp_image`; for video
`convert_unet_triplane`, `convert_video_vae` (whole, or its decoder half)
and `convert_mlp_video`; for NeRF and occupancy `convert_triplane_vae`
(whole, or its decoder half for the sampling checkpoints), `convert_pointnet`
(any cloud width: srn_cars' `fc_pos` takes 6 values a point) and
`convert_mlp_nerf` or `convert_mlp_3d` (the UNet is the image one).  For
stage-1 training: LPIPS into the reference checkpoint layout (the JAX
package's evals/lpips.py::load_torch_weights reads it back), and the
PatchGANs (the image one and the video 2D + 3D pair) and the
spectral-norm state, which the JAX package has no converter for (`*_to_jax` give the inverses).  For the
evals: the FID InceptionV3 and the FVD I3D into pytorch-fid's and
pytorch_i3d's layouts, the inverses of the JAX package's
evals/inception.py::load_torch_inception and evals/i3d.py::load_torch_i3d
(also the readers of its `.npz` weight files).  The port's modules use the
reference PyTorch layouts, so every map here is a transpose, reshape or channel
permutation and the round trip is bit-exact:

  * Flax Conv (kh, kw, I, O)   -> Conv2d (O, I, kh, kw)
  * Flax Conv (kt, kh, kw, I, O) -> Conv3d (O, I, kt, kh, kw) [3D PatchGAN, I3D]
  * frozen BatchNorm bn_scale / bn_bias / bn_mean / bn_var -> weight / bias /
    running_mean / running_var                      [InceptionV3, I3D]
  * LayerNorm scale / bias     -> weight / bias
  * Flax 1x1 Conv (1, 1, I, O) -> Conv1d (O, I, 1)        [ADM attention]
  * Flax Dense (I, O)          -> Linear (O, I)
  * GroupNorm scale / bias     -> weight / bias
  * ModulatedConv (k, k, I, O) -> (1, O, I, k, k)
  * Flax Dense (I, O) over tokens -> Conv1d (O, I, 1)   [1D attention]
  * Flax Dense (I, O) over planes -> 1x1 Conv2d (O, I, 1, 1) [video pre_* and
                                        post_*, triplane post_quant_conv_*]
  * ADM qkv: qkv-major output channels -> head-major (QKVAttentionLegacy)

The standalone ConvONet (nn/onet.py, domains/onet.py): the LocalDecoder,
the pointnet with its plane UNet, the voxel encoder with its UNet2D and
UNet3D, PointNet++ (Dense -> Linear; its batch-statistics norm's scale /
bias -> weight / bias), and the StyleGAN pieces at any kernel size
(EqualConv2d, ModulatedConv) and FastGroupNorm (`scale` / `bias` kept).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ddmi_tpu_torch.nn.triplane_vae import jax_layout as triplane_jax_layout
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


def _linear_nobias(sd: SD, key: str, p) -> None:
    sd[key + ".weight"] = _t(np.transpose(p["kernel"]))


def _layer_norm(sd: SD, key: str, p) -> None:
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])


def _conv1x1_from_dense(sd: SD, key: str, p) -> None:
    sd[key + ".weight"] = _t(np.transpose(p["kernel"])[:, :, None, None])
    sd[key + ".bias"] = _t(p["bias"])


def _spatial_transformer(sd: SD, key: str, p, depth: int) -> None:
    """JAX SpatialTransformer (nn/transformer.py) -> the LDM attention.py
    keys of the port's (nn/transformer.py)."""
    _gn(sd, key + ".norm", p["norm"])
    _conv1x1_from_dense(sd, key + ".proj_in", p["proj_in"])
    for i in range(depth):
        b, k = p[f"block_{i}"], f"{key}.transformer_blocks.{i}"
        for a in ("attn1", "attn2"):
            for name in ("to_q", "to_k", "to_v"):
                _linear_nobias(sd, f"{k}.{a}.{name}", b[a][name])
            _dense(sd, f"{k}.{a}.to_out.0", b[a]["to_out"])
        for n in ("norm1", "norm2", "norm3"):
            _layer_norm(sd, f"{k}.{n}", b[n])
        _dense(sd, f"{k}.ff.net.0.proj", b["ff"]["geglu"]["proj"])
        _dense(sd, f"{k}.ff.net.2", b["ff"]["out_proj"])
    _conv1x1_from_dense(sd, key + ".proj_out", p["proj_out"])


def unet_from_jax(tree, cfg) -> SD:
    """JAX UNet params (nn/unet.py) -> port UNet state_dict (walks the same
    ADM block layout as reference_ckpt.convert_unet), with the label
    embedding of a class-conditional UNet and the spatial transformers in
    the attention blocks' places where the config asks for them."""
    sd: SD = {}
    _dense(sd, "time_embed.0", tree["time_dense1"])
    _dense(sd, "time_embed.2", tree["time_dense2"])
    if cfg.num_classes is not None:
        sd["label_emb.weight"] = _t(tree["label_emb"]["embedding"])
    if cfg.use_spatial_transformer:
        attn = lambda key, p, nh: _spatial_transformer(sd, key, p, cfg.transformer_depth)
    else:
        attn = lambda key, p, nh: _adm_attn(sd, key, p, nh)
    _conv(sd, "input_blocks.0.0", tree["conv_in"])
    mc = cfg.model_channels
    idx, ds, ch = 1, 1, mc
    for level, mult in enumerate(cfg.channel_mult):
        for i in range(cfg.num_res_blocks):
            key = f"input_blocks.{idx}"
            _adm_resblock(sd, key + ".0", tree[f"down_{level}_{i}"])
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                attn(key + ".1", tree[f"down_attn_{level}_{i}"], _heads(ch, cfg))
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            _conv(sd, f"input_blocks.{idx}.0.op", tree[f"downsample_{level}"]["Conv_0"])
            idx += 1
            ds *= 2
    _adm_resblock(sd, "middle_block.0", tree["mid_block1"])
    attn("middle_block.1", tree["mid_attn"], _heads(ch, cfg))
    _adm_resblock(sd, "middle_block.2", tree["mid_block2"])
    idx = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            key = f"output_blocks.{idx}"
            _adm_resblock(sd, key + ".0", tree[f"up_{level}_{i}"])
            ch = mult * mc
            sub = 1
            if ds in cfg.attention_resolutions:
                attn(f"{key}.{sub}", tree[f"up_attn_{level}_{i}"], _heads(ch, cfg))
                sub += 1
            if level != 0 and i == cfg.num_res_blocks:
                _conv(sd, f"{key}.{sub}.conv", tree[f"upsample_{level}"]["Conv_0"])
                ds //= 2
            idx += 1
    _gn(sd, "out.0", tree["norm_out"])
    _conv(sd, "out.2", tree["conv_out"])
    return sd


# ------------------------------------------------------------------ MDTv2


def _mdt_block(sd: SD, key: str, p) -> None:
    _dense(sd, key + ".adaLN_modulation.1", p["adaLN_modulation"])
    _dense(sd, key + ".attn.qkv", p["attn"]["qkv"])
    _dense(sd, key + ".attn.proj", p["attn"]["proj"])
    sd[key + ".attn.rel_pos_bias.relative_position_bias_table"] = _t(p["attn"]["rel_pos_table"])
    _dense(sd, key + ".mlp.fc1", p["mlp_fc1"])
    _dense(sd, key + ".mlp.fc2", p["mlp_fc2"])
    if "skip_linear" in p:
        _dense(sd, key + ".skip_linear", p["skip_linear"])


def mdt_from_jax(tree, cfg) -> SD:
    """JAX MDTv2 params (nn/mdt.py) -> port MDTv2 state_dict (the
    reference maskedtransformer.py keys); inverts
    reference_ckpt.convert_mdt: the patch Dense over (p, p, C)-ordered
    patch vectors becomes the p x p stride-p Conv2d."""
    p, C = cfg.patch_size, cfg.in_channels
    k = np.asarray(tree["x_embedder"]["kernel"])
    sd: SD = {
        "x_embedder.proj.weight": _t(np.transpose(k.reshape(p, p, C, -1), (3, 2, 0, 1))),
        "x_embedder.proj.bias": _t(tree["x_embedder"]["bias"]),
        "pos_embed": _t(tree["pos_embed"]),
        "decoder_pos_embed": _t(tree["decoder_pos_embed"]),
    }
    _dense(sd, "t_embedder.mlp.0", tree["t_mlp1"])
    _dense(sd, "t_embedder.mlp.2", tree["t_mlp2"])
    half = (cfg.depth - cfg.decode_layer) // 2
    for i in range(half):
        _mdt_block(sd, f"en_inblocks.{i}", tree[f"en_in_{i}"])
        _mdt_block(sd, f"en_outblocks.{i}", tree[f"en_out_{i}"])
    for i in range(cfg.decode_layer):
        _mdt_block(sd, f"de_blocks.{i}", tree[f"de_{i}"])
    if "sideblock" in tree:
        _mdt_block(sd, "sideblocks.0", tree["sideblock"])
        sd["mask_token"] = _t(tree["mask_token"])
    _dense(sd, "final_layer.adaLN_modulation.1", tree["final_adaLN"])
    _dense(sd, "final_layer.linear", tree["final_linear"])
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


def _lin_attn(sd: SD, key: str, p) -> None:
    """LinAttnBlock: the bias-free to_qkv (qkv-major on both sides) and
    to_out."""
    sd[key + ".to_qkv.weight"] = _t(np.transpose(p["to_qkv"]["kernel"], (3, 2, 0, 1)))
    _conv(sd, key + ".to_out", p["to_out"])


def vae_from_jax(tree, cfg) -> SD:
    """JAX Autoencoder params (nn/vae.py) -> state_dict of the port's
    Autoencoder (`encoder.*`, `quant_conv.*`, `decoder.*`,
    `post_quant_conv.*`), any attn_type; inverts reference_ckpt.convert_vae
    along the port's `jax_layout`."""
    return _from_layout(tree, jax_layout(cfg))


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
    encoder is not read.  `attn_type: linear` maps LinAttnBlock_{n}."""
    if cfg.attn_type not in ("vanilla", "vanilla-multihead", "linear", "none"):
        raise NotImplementedError(f"attn_type {cfg.attn_type!r} is not ported")
    dec = tree["decoder"]
    sd: SD = {}
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    ab = 0
    if cfg.attn_type == "linear":
        attn, name = _lin_attn, "LinAttnBlock"
    else:
        attn, name = _vae_attn, "AttnBlock"
    _vae_resnet(sd, "decoder.mid.block_1", dec["mid_block1"])
    if cfg.attn_type != "none":
        attn(sd, "decoder.mid.attn_1", dec[f"{name}_{ab}"])
        ab += 1
    _vae_resnet(sd, "decoder.mid.block_2", dec["mid_block2"])
    _attn1d(sd, "decoder.mid_attn", dec["mid_inter_attn"])
    n = len(cfg.ch_mult)
    curr = cfg.resolution // 2 ** (n - 1)
    for i in reversed(range(n)):
        for j in range(cfg.num_res_blocks + 1):
            _vae_resnet(sd, f"decoder.up.{i}.block.{j}", dec[f"up_{i}_{j}"])
            if curr in cfg.attn_resolutions:
                attn(sd, f"decoder.up.{i}.attn.{j}", dec[f"{name}_{ab}"])
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


def _vit_attn(sd: SD, key: str, norm, qkv, out) -> None:
    """PreNorm(Attention): LayerNorm, bias-free qkv, to_out.0."""
    _gn(sd, key + ".norm", norm)  # a LayerNorm's scale and bias map as a GroupNorm's
    sd[key + ".fn.to_qkv.weight"] = _t(np.transpose(qkv["kernel"]))
    _dense(sd, key + ".fn.to_out.0", out)


def _vit_ff(sd: SD, key: str, norm, p) -> None:
    _gn(sd, key + ".norm", norm)
    _dense(sd, key + ".fn.net.0", p["Dense_0"])
    _dense(sd, key + ".fn.net.3", p["Dense_1"])


def timesformer_from_jax(tree) -> SD:
    """JAX TimeSformerEncoder params (nn/vit.py) -> port TimeSformerEncoder
    state_dict (`to_patch_embedding`, `layers.{i}.{0,1,2}`)."""
    sd: SD = {}
    _dense(sd, "to_patch_embedding", tree["to_patch_embedding"])
    i = 0
    while f"time_attn_{i}" in tree:
        for j, part in enumerate(("time", "space")):
            a = tree[f"{part}_attn_{i}"]
            _vit_attn(sd, f"layers.{i}.{j}", tree[f"{part}_norm_{i}"], a["to_qkv"], a["to_out"])
        _vit_ff(sd, f"layers.{i}.2", tree[f"ff_norm_{i}"], tree[f"ff_{i}"])
        i += 1
    return sd


def vit_transformer_from_jax(tree) -> SD:
    """JAX Transformer params (nn/vit.py, the pooling transformer) -> port
    Transformer state_dict (`layers.{i}.{0,1}`)."""
    sd: SD = {}
    i = 0
    while f"qkv_{i}" in tree:
        _vit_attn(sd, f"layers.{i}.0", tree[f"attn_norm_{i}"], tree[f"qkv_{i}"],
                  tree[f"attn_out_{i}"])
        _vit_ff(sd, f"layers.{i}.1", tree[f"ff_norm_{i}"], tree[f"ff_{i}"])
        i += 1
    return sd


def video_vae_from_jax(tree, cfg) -> SD:
    """JAX VideoAutoencoder params (nn/video_vae.py) -> state_dict of the
    port's whole VideoAutoencoder (`with_encoder=True`): the decode half of
    `video_decoder_from_jax`, the TimeSformer (`encoder.*`), the class
    tokens and positions, the pooling transformers and `pre_{xy,xt,yt}`.
    Inverts reference_ckpt.convert_video_vae."""
    sd = video_decoder_from_jax(tree, cfg)
    sd.update({"encoder." + k: v for k, v in timesformer_from_jax(tree["encoder"]).items()})
    for plane in ("xy", "xt", "yt"):
        sd[f"{plane}_token"] = _t(tree[f"{plane}_token"])
        sd[f"{plane}_pos_embedding"] = _t(tree[f"{plane}_pos"])
        sd.update({f"{plane}_quant_attn.{k}": v for k, v in
                   vit_transformer_from_jax(tree[f"{plane}_quant_attn"]).items()})
        p = tree[f"pre_{plane}"]
        sd[f"pre_{plane}.weight"] = _t(np.transpose(p["kernel"])[:, :, None, None])
        sd[f"pre_{plane}.bias"] = _t(p["bias"])
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


def _from_layout(tree, layout) -> SD:
    """A JAX parameter tree -> state_dict along a module's `jax_layout`:
    "gn" a GroupNorm, "conv" a Conv (kernel and bias), "conv_nobias" its
    kernel alone, "dense" a Dense layer that the port runs as a 1x1 Conv2d."""
    sd: SD = {}
    for key, path, kind in layout:
        p = tree
        for name in path:
            p = p[name]
        if kind == "gn":
            _gn(sd, key, p)
        elif kind == "conv":
            _conv(sd, key, p)
        elif kind == "dense":
            sd[key + ".weight"] = _t(np.transpose(p["kernel"])[:, :, None, None])
            sd[key + ".bias"] = _t(p["bias"])
        else:
            sd[key + ".weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    return sd


def triplane_decoder_from_jax(tree, cfg) -> SD:
    """JAX TriplaneAutoencoder params (nn/triplane_vae.py) -> state_dict of
    the port's decode-only TriplaneAutoencoder (`decoder.*`,
    `post_quant_conv_{xy,yz,xz}.*`).  Inverts the decoder half of
    reference_ckpt.convert_triplane_vae; the encoder is not read."""
    return _from_layout(tree, [e for e in triplane_jax_layout(cfg) if e[0].startswith(
        ("decoder.", "post_quant_conv"))])


def triplane_vae_from_jax(tree, cfg) -> SD:
    """JAX TriplaneAutoencoder params -> state_dict of the port's whole
    TriplaneAutoencoder (`with_encoder=True`): the decoder half, the encoder
    (`encoder.*`) and the quant convs `quant_conv_{xy,yz,xz}`, along the
    port's `jax_layout` (nn/triplane_vae.py).  Inverts
    reference_ckpt.convert_triplane_vae."""
    return _from_layout(tree, triplane_jax_layout(cfg))


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


def _conv3d(sd: SD, key: str, p) -> None:
    sd[key + ".weight"] = _t(np.transpose(p["kernel"], (4, 3, 0, 1, 2)))
    sd[key + ".bias"] = _t(p["bias"])


def _conv_unet(tree, levels: int, conv) -> SD:
    sd: SD = {}
    for i in range(levels):
        conv(sd, f"down{i}_conv1", tree[f"down{i}_conv1"])
        conv(sd, f"down{i}_conv2", tree[f"down{i}_conv2"])
    for i in range(levels - 1):
        for name in ("upconv", "conv1", "conv2"):
            conv(sd, f"up{i}_{name}", tree[f"up{i}_{name}"])
    conv(sd, "conv_final", tree["conv_final"])
    return sd


def unet2d_from_jax(tree, depth: int) -> SD:
    """JAX UNet2D params (nn/conv_unet.py) -> port UNet2D state_dict (the
    same conv names, Conv2d layouts)."""
    return _conv_unet(tree, depth, _conv)


def unet3d_from_jax(tree, num_levels: int = 3) -> SD:
    """JAX UNet3D params -> port UNet3D state_dict (Conv3d layouts)."""
    return _conv_unet(tree, num_levels, _conv3d)


def _prefixed(prefix: str, sd: SD) -> SD:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def pointnet_unet_from_jax(tree, n_blocks: int, unet_depth: int) -> SD:
    """JAX LocalPoolPointnet(unet=True) params -> port state_dict: the
    pointnet's keys and the shared plane UNet's under `unet.`."""
    sd = pointnet_from_jax(tree, n_blocks)
    sd.update(_prefixed("unet", unet2d_from_jax(tree["unet"], unet_depth)))
    return sd


def voxel_encoder_from_jax(tree, unet_depth: int = 4) -> SD:
    """JAX LocalVoxelEncoder params -> port state_dict: `conv_in` (Conv3d),
    and the optional `unet.` (UNet2D) and `unet3d.` (UNet3D)."""
    sd: SD = {}
    _conv3d(sd, "conv_in", tree["conv_in"])
    if "unet" in tree:
        sd.update(_prefixed("unet", unet2d_from_jax(tree["unet"], unet_depth)))
    if "unet3d" in tree:
        sd.update(_prefixed("unet3d", unet3d_from_jax(tree["unet3d"])))
    return sd


def pointnetpp_from_jax(tree) -> SD:
    """JAX PointNetPlusPlus params -> port state_dict: each set abstraction
    and feature propagation's Dense `mlp_{i}` as `mlps.{i}`, its norm
    `bn_{i}` {scale, bias} as `bns.{i}` {weight, bias}."""
    sd: SD = {}
    for block in ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1"):
        p = tree[block]
        i = 0
        while f"mlp_{i}" in p:
            _dense(sd, f"{block}.mlps.{i}", p[f"mlp_{i}"])
            _gn(sd, f"{block}.bns.{i}", p[f"bn_{i}"])
            i += 1
    return sd


def local_decoder_from_jax(tree, n_blocks: int) -> SD:
    """JAX LocalDecoder params (nn/onet.py) -> port LocalDecoder state_dict
    (the reference's `fc_p`, `fc_c.{i}`, `blocks.{i}`, `fc_out`)."""
    sd: SD = {}
    _dense(sd, "fc_p", tree["fc_p"])
    for i in range(n_blocks):
        if f"fc_c{i}" in tree:
            _dense(sd, f"fc_c.{i}", tree[f"fc_c{i}"])
        _resnet_fc(sd, f"blocks.{i}", tree[f"block{i}"])
    _dense(sd, "fc_out", tree["fc_out"])
    return sd


def conv_onet_from_jax(tree, encoder_sd: SD, n_blocks: int) -> SD:
    """JAX ConvONet params {encoder, decoder} -> port ConvONet state_dict,
    given the encoder's state_dict converted by its own function above
    (`pointnet_from_jax`, `pointnet_unet_from_jax`, `voxel_encoder_from_jax`)."""
    sd = _prefixed("encoder", encoder_sd)
    sd.update(_prefixed("decoder", local_decoder_from_jax(tree["decoder"], n_blocks)))
    return sd


def equal_conv2d_from_jax(tree) -> SD:
    """JAX EqualConv2d params (k, k, I, O) weight, (O,) bias -> port
    EqualConv2d state_dict ((O, I, k, k) weight)."""
    sd = {"weight": _t(np.transpose(tree["weight"], (3, 2, 0, 1)))}
    if "bias" in tree:
        sd["bias"] = _t(tree["bias"])
    return sd


def modulated_conv_from_jax(tree) -> SD:
    """JAX ModulatedConv params (any kernel size) -> port ModulatedConv
    state_dict (`weight` (1, O, I, k, k), `modulation.*`)."""
    sd: SD = {}
    _modconv(sd, "x", tree)
    return {k[2:]: v for k, v in sd.items()}


def fast_group_norm_from_jax(tree) -> SD:
    """JAX FastGroupNorm params -> port FastGroupNorm state_dict (the same
    `scale` and `bias`)."""
    return {"scale": _t(tree["scale"]), "bias": _t(tree["bias"])}


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


def discriminator3d_from_jax(tree) -> SD:
    """JAX GANLoss3D params {"disc2d": ..., "disc3d": ...} (each {Conv_k,
    SyncBatchNorm_k}) -> state_dict of the port's GANLoss3D
    (`disc2d.convs.{k}`, `disc2d.norms.{k}.{scale,bias}`, and the same
    under `disc3d`; Flax Conv (kt, kh, kw, I, O) -> Conv3d (O, I, kt, kh,
    kw))."""
    sd: SD = {}
    for name, d in ((n, tree[n]) for n in ("disc2d", "disc3d")):
        k = 0
        while f"Conv_{k}" in d:
            kernel = np.asarray(d[f"Conv_{k}"]["kernel"])
            nd = kernel.ndim
            sd[f"{name}.convs.{k}.weight"] = _t(np.transpose(
                kernel, (nd - 1, nd - 2) + tuple(range(nd - 2))))
            sd[f"{name}.convs.{k}.bias"] = _t(d[f"Conv_{k}"]["bias"])
            k += 1
        k = 0
        while f"SyncBatchNorm_{k}" in d:
            for leaf in ("scale", "bias"):
                sd[f"{name}.norms.{k}.{leaf}"] = _t(d[f"SyncBatchNorm_{k}"][leaf])
            k += 1
    return sd


def discriminator3d_to_jax(sd: SD) -> dict:
    """The inverse of `discriminator3d_from_jax` (numpy leaves)."""
    tree: dict = {}
    for name in ("disc2d", "disc3d"):
        d: dict = {}
        for key, t in sd.items():
            owner, group, k, leaf = key.split(".")
            if owner != name:
                continue
            a = t.detach().cpu().numpy()
            if group == "convs":
                d.setdefault(f"Conv_{k}", {})[leaf if leaf == "bias" else "kernel"] = (
                    a if leaf == "bias" else np.transpose(a, tuple(range(2, a.ndim)) + (1, 0)))
            else:
                d.setdefault(f"SyncBatchNorm_{k}", {})[leaf] = a
        tree[name] = d
    return tree


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


# --------------------------------------------------------- metric networks


def _frozen_bn(sd: SD, key: str, p) -> None:
    sd[key + ".weight"] = _t(p["bn_scale"])
    sd[key + ".bias"] = _t(p["bn_bias"])
    sd[key + ".running_mean"] = _t(p["bn_mean"])
    sd[key + ".running_var"] = _t(p["bn_var"])
    sd[key + ".num_batches_tracked"] = torch.tensor(0)


def inception_from_jax(tree) -> SD:
    """JAX InceptionV3 params (ddmi_tpu/evals/inception.py) -> the port's
    InceptionV3 state_dict (pytorch-fid's names)."""
    sd: SD = {}

    def walk(node, path):
        if "conv" in node:
            sd[path + ".conv.weight"] = _t(np.transpose(node["conv"]["kernel"], (3, 2, 0, 1)))
            _frozen_bn(sd, path + ".bn", node)
            return
        for name, child in node.items():
            walk(child, f"{path}.{name}" if path else name)

    walk({k: v for k, v in tree.items() if k != "fc"}, "")
    _dense(sd, "fc", tree["fc"])
    return sd


_I3D_BRANCHES = {"Branch_0/Conv3d_0a_1x1": "b0", "Branch_1/Conv3d_0a_1x1": "b1a",
                 "Branch_1/Conv3d_0b_3x3": "b1b", "Branch_2/Conv3d_0a_1x1": "b2a",
                 "Branch_2/Conv3d_0b_3x3": "b2b", "Branch_3/Conv3d_0b_1x1": "b3b"}


def i3d_from_jax(tree) -> SD:
    """JAX I3D params (ddmi_tpu/evals/i3d.py) -> the port's I3D state_dict
    (pytorch_i3d's names: a Mixed block's `Branch_1/Conv3d_0b_3x3` is its
    `b1b`)."""
    sd: SD = {}

    def unit(key, p):
        sd[key + ".conv3d.weight"] = _t(np.transpose(p["conv3d"]["kernel"], (4, 3, 0, 1, 2)))
        if "bias" in p["conv3d"]:
            sd[key + ".conv3d.bias"] = _t(p["conv3d"]["bias"])
        if "bn_scale" in p:
            _frozen_bn(sd, key + ".bn", p)

    for name, node in tree.items():
        if name.startswith("Mixed"):
            for branch, p in node.items():
                unit(f"{name}.{_I3D_BRANCHES[branch]}", p)
        else:
            unit(name, node)
    return sd
