"""Typed configuration for the port's slices.

Reads the same YAML files as ddmi_tpu/core/config.py (e.g.
configs/ldm/celebahq.yaml, configs/ldm/skytimelapse.yaml,
configs/ldm/srn_cars.yaml), into dataclasses that carry the fields the
ported slices use, with the JAX package's defaults; every other key lands in
an `extra` dict (the NeRF MLP's D / W / skips / multires / N_samples are
read from `mlpconfig.extra`, as the JAX NeRF pipeline reads them).  The
port keeps its own reader, although the JAX one imports no JAX, so that a
run of the port loads no module of the JAX package.  Parsing uses PyYAML,
which the GPU machine has.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import yaml


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """Known fields of `cls` from d, unknown keys merged into `extra`.
    YAML 1.1 reads '1e-4' as a string: coerce by the declared type."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    known = {}
    for k, v in d.items():
        if k not in fields:
            continue
        t = fields[k].type
        if isinstance(v, str) and t in ("float", "int"):
            v = float(v) if t == "float" else int(v)
        elif t == "float" and isinstance(v, int):
            v = float(v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        known[k] = v
    extra = {k: v for k, v in d.items() if k not in fields}
    known["extra"] = {**extra, **(known.get("extra") or {})}
    return known


@dataclass(frozen=True)
class LossConfig:
    """The training fields of the JAX LossConfig: stage 1 (d2c-vae) and
    stage 2 (ldm)."""

    epochs: int = 200
    warmup_epochs: int = 5
    multiscale: bool = True
    adversarial: bool = False
    kl_anneal: bool = True
    kl_max_coeff: float = 0.5
    kl_const_coeff: float = 1e-4
    kl_const_portion: float = 1e-4
    kl_anneal_portion: float = 0.9
    disc_weight: float = 0.5
    sn_reg: bool = True
    sn_reg_weight_decay: float = 0.1
    sn_reg_weight_decay_anneal: bool = True
    sn_reg_weight_decay_init: float = 5.0
    lr_scheduler: bool = True
    save_and_sample_every: int = 25
    gradient_accumulate_every: int = 1
    ema_decay: float = 0.9999
    ema_update_every: int = 10
    perceptual_weight: float = 1.0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class UNetConfig:
    image_size: int = 64
    in_channels: int = 64
    model_channels: int = 256
    out_channels: int = 64
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 4, 2)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 8)
    num_heads: int = -1
    num_head_channels: int = 32
    dropout: float = 0.0
    use_scale_shift_norm: bool = False
    # context-conditioned denoiser: SpatialTransformer blocks in place of
    # the self-attention blocks, cross-attending to a (B, n_ctx,
    # context_dim) context (nn/transformer.py)
    use_spatial_transformer: bool = False
    transformer_depth: int = 1
    context_dim: Optional[int] = None
    # class-conditional: a label embedding added to the timestep embedding
    num_classes: Optional[int] = None
    # triplane (video) variant: planes (xy, xt, yt) as (h, w) pairs
    triplane: bool = False
    plane_sizes: Tuple[Tuple[int, int], ...] = ()
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class DDConfig:
    z_channels: int = 128
    resolution: int = 256
    out_ch: int = 64
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 3
    attn_resolutions: Tuple[int, ...] = ()
    hdbf_resolutions: Tuple[int, ...] = (128, 64)
    attn_type: str = "vanilla"
    # video autoencoder
    inter_attn_resolutions: Tuple[int, ...] = ()
    double_z: bool = True
    in_channels: int = 3
    timesformer_channels: int = 384
    patch_size: int = 8
    splits: int = 1
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class MLPConfig:
    in_ch: int = 2
    out_ch: int = 3
    ch: int = 256
    latent_dim: int = 64
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class DDPMConfig:
    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    cosine_s: float = 8e-3
    image_size: int = 64
    channels: int = 64
    clip_denoised: bool = False
    parameterization: str = "eps"
    loss_type: str = "l2"
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    v_posterior: float = 0.0
    mixed_prediction: bool = True
    mixed_init: float = -6.0
    sampling_timesteps: int = 50
    ddim_sampling_eta: float = 0.0
    w: float = 1.0  # classifier-free guidance weight
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class DiTConfig:
    """The MDTv2 denoiser (model.DiT: True, nn/mdt.py)."""

    input_size: int = 64
    patch_size: int = 2
    in_channels: int = 64
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    mask_ratio: Optional[float] = None
    decode_layer: int = 4
    cross_plane: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class ModelConfig:
    DiT: bool = False
    resume: bool = False  # the CLI's train mode continues from the newest checkpoint
    amp: bool = True   # stage-2 training: bf16 compute, fp32 master parameters
    lr: float = 1e-4
    embed_dim: int = 64
    lossconfig: LossConfig = field(default_factory=LossConfig)
    ddconfig: DDConfig = field(default_factory=DDConfig)
    mlpconfig: MLPConfig = field(default_factory=MLPConfig)
    unetconfig: UNetConfig = field(default_factory=UNetConfig)
    ddpmconfig: DDPMConfig = field(default_factory=DDPMConfig)
    ditconfig: DiTConfig = field(default_factory=DiTConfig)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class DataConfig:
    domain: str = "image"  # image | video | occupancy | nerf
    mode: str = "train"  # the CLI's mode: train | eval | gen
    data_dir: str = "./train_data"
    test_data_dir: str = "./test_data"
    save_pth: str = "./save"  # checkpoints, logs and eval images
    batch_size: int = 8
    test_batch_size: int = 8
    test_resolution: int = 256
    frames: int = 16
    conv_config: Optional[str] = None  # nested convocc YAML (NeRF render kwargs)
    dataset: str = "folder"  # folder | synthetic | shapenet | srncars | sky | ucf101
    num_workers: int = 4
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class MeshConfig:
    """The JAX package's device mesh.  The port runs on one card, where it
    changes nothing (the trainer says so once)."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class Config:
    exp: str = "d2c-vae"  # d2c-vae (stage 1) | ldm (stage 2)
    seed: int = 42
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    extra: Dict[str, Any] = field(default_factory=dict)


_SUB = (("lossconfig", LossConfig), ("ddconfig", DDConfig), ("mlpconfig", MLPConfig),
        ("unetconfig", UNetConfig), ("ddpmconfig", DDPMConfig), ("ditconfig", DiTConfig))


def config_from_dict(d: Dict[str, Any]) -> Config:
    d = dict(d)
    out: Dict[str, Any] = {}
    if "model" in d:
        m = dict(d.pop("model"))
        params = m.pop("params", None) or {}
        sub = {k: cls(**_filter_kwargs(cls, dict(params[k])))
               for k, cls in _SUB if params.get(k) is not None}
        out["model"] = ModelConfig(**_filter_kwargs(ModelConfig, {**m, **sub}))
    if "data" in d:
        out["data"] = DataConfig(**_filter_kwargs(DataConfig, dict(d.pop("data"))))
    if "mesh" in d:
        out["mesh"] = MeshConfig(**_filter_kwargs(MeshConfig, dict(d.pop("mesh"))))
    out.update(_filter_kwargs(Config, d))
    return Config(**out)


def load_config(path: str, **overrides: Any) -> Config:
    """Load a YAML config (the JAX package's schema) into a Config; the
    top-level keys in `overrides` (the CLI's `exp` and `seed`) replace the
    file's."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw.update(overrides)
    return config_from_dict(raw)

