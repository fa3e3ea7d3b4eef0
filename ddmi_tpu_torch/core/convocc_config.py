"""Nested convocc-style YAML for the NeRF slice (the port's own copy of
ddmi_tpu/core/convocc_config.py's `load_convocc_config` and `nerf_kwargs`).

`data.conv_config` (configs/ldm/srn_cars.yaml) names a convocc YAML whose
`inherit_from` chain is merged recursively; its `model.TN` block carries the
NeRF render settings.  A relative path is read from the working directory,
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
    """The render settings that sampling reads from the model.TN block
    (srncars_nerf_3plane.yaml), with the JAX package's defaults."""
    tn = (conv_cfg.get("model") or {}).get("TN", {})
    return {
        "N_samples": tn.get("N_samples", 256),
        "white_bkgd": tn.get("white_bkgd", True),
        "multires": tn.get("multires", 10),
        "multires_views": tn.get("multires_views", 4),
    }
