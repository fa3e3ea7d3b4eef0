"""Convert the original DDMI repository's checkpoints into the port's
(counterpart of ddmi_tpu/cli/convert_reference_ckpt.py).

Usage:
  python -m ddmi_tpu_torch.cli.convert_reference_ckpt \
      --exp d2c-vae --configs configs/d2c-vae/celebahq.yaml \
      --ckpt /path/model-last.pt [--out <save_pth>] [--device cuda]

  python -m ddmi_tpu_torch.cli.convert_reference_ckpt \
      --exp ldm --configs configs/ldm/celebahq.yaml \
      --ckpt /path/ldm-last.pt [--out <save_pth>] [--device cuda]

The port's modules carry the original repository's state_dict names and
layouts, so a conversion is a load, held key by key and shape by shape
against the model the config builds (a missing or extra tensor, or a shape
that differs, raises).  Stage-1 files hold the VAE under 'model' (image
d2c-vae files) or 'vaemodel', the INR under 'mlp' and, for occupancy and
NeRF, the point-cloud encoder under 'pointnet'; stage-2 files ('ldm-*.pt')
hold the frozen stage-1 modules as well, the DDPM under 'diffusion'
('model.*' is the UNet, beside 'mixing_logit' and the schedule's buffers,
which the port recomputes) and the ema_pytorch copy under 'ema'
('ema_model.*'), which becomes the EMA where the file has one (else the raw
weights do).

It writes `<save_pth>/stage1/<step>.pt` (and for ldm `stage2/<step>.pt`)
in the trainer's layout, so that `Trainer.load_stage1` / `load_stage2`,
training with `model.resume: True`, gen, eval and `cli/serve.py` read them
as they read the trainer's own.  The optimizer, spectral-norm and
discriminator states start fresh, and a resumed run draws its steps from
the trainer's seeds.  All four domains, and the image domain's MDTv2
denoiser (model.DiT: 'model.*' is then the maskedtransformer.py state,
whose derived relative_position_index buffers are dropped).  Runs on the
card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import pickle
import warnings
from typing import Dict

import torch

from ddmi_tpu_torch.core.checkpoint import CheckpointManager
from ddmi_tpu_torch.core.config import load_config

# Reference buffers the port recomputes from the widths: the TimeSformer's
# rotary tables (as the JAX converter skips them).
RECOMPUTED = ("encoder.frame_rot_emb.", "encoder.image_rot_emb.")


def load_reference_checkpoint(path: str) -> dict:
    """torch.load a reference .pt on the CPU.  Stage-2 files embed OmegaConf
    arguments, which a weights-only load rejects; only that rejection
    falls back to a full unpickling, which can run code from the file and
    is announced with a warning.  Other load errors propagate."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        warnings.warn(
            f"{path}: weights_only load rejected (embedded non-tensor objects, "
            "e.g. OmegaConf args in reference stage-2 files); falling back to FULL "
            "pickle loading, which can execute code from the checkpoint - only "
            "convert checkpoints you trust"
        )
        return torch.load(path, map_location="cpu", weights_only=False)


def checked(name: str, sd, module: torch.nn.Module, skip=()) -> Dict[str, torch.Tensor]:
    """A reference state_dict (tensors or arrays) as `module`'s, its keys
    under the `skip` prefixes and those of the module's derived
    (non-persistent) buffers dropped: the keys and shapes must be the
    module's exactly, else ValueError naming up to 8 of each kind of
    difference."""
    want = module.state_dict()
    derived = {k for k, _ in module.named_buffers()} - set(want)
    sd = {k: torch.as_tensor(v) for k, v in sd.items()
          if not k.startswith(tuple(skip)) and k not in derived}
    missing, extra = sorted(set(want) - set(sd))[:8], sorted(set(sd) - set(want))[:8]
    if missing or extra:
        raise ValueError(f"{name}: the checkpoint's tensors differ from the model's; "
                         f"missing={missing} extra={extra}")
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in want.items()
           if sd[k].shape != v.shape][:8]
    if bad:
        raise ValueError(f"{name}: shape mismatches (key, checkpoint, model) {bad}")
    return sd


def stage1_reference(data: dict, pipe, exp: str) -> Dict[str, dict]:
    """The stage-1 modules' state_dicts in a reference file, checked."""
    image_vae = exp == "d2c-vae" and pipe.cfg.data.domain == "image" and "model" in data
    keys = {"vae": "model" if image_vae else "vaemodel", "mlp": "mlp", "pointnet": "pointnet"}
    out = {}
    for name in pipe.stage1_modules:
        if keys[name] not in data:
            raise KeyError(f"reference checkpoint has no '{keys[name]}' entry")
        out[name] = checked(f"stage1 '{keys[name]}'", data[keys[name]], getattr(pipe, name),
                            RECOMPUTED if name == "vae" else ())
    return out


def stage2_reference(data: dict, pipe, use_ema: bool) -> dict:
    """The denoiser's state_dict (the UNet's, or MDTv2's) and the mixing
    logit of a reference stage-2 file (its 'ema' copy when `use_ema`),
    checked."""
    if use_ema:
        sd = {k[len("ema_model."):]: v for k, v in data["ema"].items()
              if k.startswith("ema_model.")}
    else:
        sd = data["diffusion"]
    name = "stage2 'ema'" if use_ema else "stage2 'diffusion'"
    unet = checked(name, {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")},
                   pipe.unet)
    if "mixing_logit" not in sd:
        raise ValueError(f"{name}: the checkpoint has no mixing_logit")
    logit = torch.as_tensor(sd["mixing_logit"])
    if logit.numel() != pipe.mixing_logit.numel():
        raise ValueError(f"{name}: mixing_logit has shape {tuple(logit.shape)}, the model "
                         f"{tuple(pipe.mixing_logit.shape)}")
    return {"unet": unet, "mixing_logit": logit.reshape(pipe.mixing_logit.shape)}


def _save(save_dir: str, prefix: str, step: int, state) -> None:
    """`state` as the trainer saves it, with no generator states (a resumed
    trainer keeps its freshly seeded ones)."""
    CheckpointManager(save_dir, prefix=prefix).save(
        step, {"state": state.state_dict(), "generators": []}, overwrite=True)


def convert(exp: str, config_path: str, ckpt_path: str, out_dir=None, device="cuda",
            steps_per_epoch: int = 1000) -> str:
    """Convert `ckpt_path` for the config's model and write the port's
    checkpoints under `out_dir` (data.save_pth when None); -> that
    directory."""
    from ddmi_tpu_torch.cli.main import pipeline_class
    from ddmi_tpu_torch.core.device import resolve_device

    if exp not in ("d2c-vae", "ldm"):
        raise ValueError(f"unknown exp {exp!r}")
    cfg = load_config(config_path, exp=exp)
    device = resolve_device(device)
    data = load_reference_checkpoint(ckpt_path)
    save_dir = out_dir or cfg.data.save_pth
    step = int(data.get("step", 0))
    pipe = pipeline_class(cfg.data.domain)(cfg, device=device, seed=cfg.seed)
    for name, sd in stage1_reference(data, pipe, exp).items():
        getattr(pipe, name).load_state_dict(sd)
    s1 = pipe.init_stage1(steps_per_epoch)
    s1.step = step
    _save(save_dir, "stage1", step, s1)
    if exp == "ldm":
        pipe.load_state_dicts(**stage2_reference(data, pipe, use_ema=False))
        s2 = pipe.init_stage2()
        if "ema" in data:
            ema = stage2_reference(data, pipe, use_ema=True)
            with torch.no_grad():
                for k, v in ema["unet"].items():
                    s2.ema[f"unet.{k}"].copy_(v)
                s2.ema["mixing_logit"].copy_(ema["mixing_logit"])
        s2.step = step
        _save(save_dir, "stage2", step, s2)
    print(f"converted {ckpt_path} (step {step}) -> {save_dir}", flush=True)
    return save_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--exp", required=True, choices=["d2c-vae", "ldm"])
    ap.add_argument("--configs", required=True)
    ap.add_argument("--ckpt", required=True, help="reference .pt file")
    ap.add_argument("--out", default=None, help="override data.save_pth")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' converts on the host)")
    args = ap.parse_args(argv)
    convert(args.exp, args.configs, args.ckpt, args.out, device=args.device)


if __name__ == "__main__":
    main()
