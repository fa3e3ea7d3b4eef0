"""Nested convocc-style YAML for the 3D slices (the port's own copy of
ddmi_tpu/core/convocc_config.py's `load_convocc_config`, `encoder_name`,
`pointnet_kwargs`, `voxel_encoder_kwargs`, `generation_kwargs` and
`nerf_kwargs`; `pointnet_input_dim` reads the cloud's width, which the JAX
package takes from its input).

`data.conv_config` (configs/ldm/shapenet.yaml, configs/ldm/srn_cars.yaml)
names a convocc YAML whose `inherit_from` chain is merged recursively; its
`model.encoder_kwargs` block carries the point-cloud encoder's settings,
`generation` and `test.threshold` the mesh extraction's, and `model.TN` the
NeRF render's.  A relative path is read from the working directory,
as the JAX package reads it; a relative `inherit_from` is resolved beside
the file first, then from the working directory.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import yaml


def _merge(base: Dict[str, Any], override: Dict[str, Any]) -> None:
    for k, v in override.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            _merge(base[k], v)
        else:
            base[k] = v


def load_convocc_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    parent = cfg.get("inherit_from")
    if parent:
        parent_path = parent
        if not os.path.isabs(parent_path):
            parent_path = os.path.join(os.path.dirname(path), parent_path)
            if not os.path.exists(parent_path):
                parent_path = parent
        base = load_convocc_config(parent_path)
    else:
        base = {}
    _merge(base, cfg)
    return base


def nerf_kwargs(conv_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The render settings of the model.TN block (srncars_nerf_3plane.yaml),
    with the JAX package's defaults: samples per ray, rays per training
    scene, the stratified perturbation (the file spells it `peturb`), the
    background and the embeddings' frequencies."""
    tn = (conv_cfg.get("model") or {}).get("TN", {})
    return {
        "N_samples": tn.get("N_samples", 256),
        "N_rand": tn.get("N_rand", 5000),
        "white_bkgd": tn.get("white_bkgd", True),
        "multires": tn.get("multires", 10),
        "multires_views": tn.get("multires_views", 4),
        "perturb": tn.get("peturb", tn.get("perturb", 1.0)),
    }


def encoder_name(conv_cfg: Dict[str, Any]) -> str:
    """convocc model.encoder: 'pointnet_local_pool' (default) or
    'voxel_simple_local'."""
    return (conv_cfg.get("model") or {}).get("encoder", "pointnet_local_pool")


def pointnet_kwargs(conv_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """LocalPoolPointnet kwargs (convocc encoder_kwargs schema), with the
    optional plane-feature UNet refinement's."""
    enc = (conv_cfg.get("model") or {}).get("encoder_kwargs", {})
    kw = {
        "c_dim": (conv_cfg.get("model") or {}).get("c_dim", 32),
        "hidden_dim": enc.get("hidden_dim", 256),
        "plane_resolution": enc.get("plane_resolution", 64),
        "n_blocks": enc.get("n_blocks", 7),
    }
    if enc.get("unet"):
        uk = enc.get("unet_kwargs") or {}
        kw.update(unet=True, unet_depth=uk.get("depth", 4),
                  unet_start_filts=uk.get("start_filts", 32))
    return kw


def voxel_encoder_kwargs(conv_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """LocalVoxelEncoder kwargs (convocc encoder_kwargs schema): c_dim, the
    plane resolution, the conv's kernel size, `plane_type` where given, the
    UNet3D switch and the optional plane UNet's."""
    enc = (conv_cfg.get("model") or {}).get("encoder_kwargs", {})
    kw = {
        "c_dim": (conv_cfg.get("model") or {}).get("c_dim", 32),
        "plane_resolution": enc.get("plane_resolution", 64),
        "kernel_size": enc.get("kernel_size", 3),
        "unet3d": bool(enc.get("unet3d", False)),
    }
    if enc.get("plane_type"):
        kw["plane_type"] = tuple(enc["plane_type"])
    if enc.get("unet"):
        uk = enc.get("unet_kwargs") or {}
        kw.update(unet=True, unet_depth=uk.get("depth", 4),
                  unet_start_filts=uk.get("start_filts", 32))
    return kw


def pointnet_input_dim(conv_cfg: Dict[str, Any]) -> int:
    """The values each input point carries (data.dim: 3, or 6 for the
    srn_cars clouds' xyz and rgb), the width of the pointnet's first
    layer (flax's Dense takes it from its input)."""
    return int((conv_cfg.get("data") or {}).get("dim", 3))


def generation_kwargs(conv_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Mesh extraction kwargs (convocc generation schema): the occupancy
    probability threshold, MISE's start resolution and upsampling steps,
    the face target of the quadric simplification and the steps of the
    gradient refinement."""
    g = conv_cfg.get("generation") or {}
    t = conv_cfg.get("test") or {}
    return {
        "threshold": t.get("threshold", 0.2),
        "resolution0": g.get("resolution_0", 64),
        "upsampling_steps": g.get("upsampling_steps", 2),
        "simplify_nfaces": g.get("simplify_nfaces"),
        "refinement_step": g.get("refinement_step", 0),
    }
