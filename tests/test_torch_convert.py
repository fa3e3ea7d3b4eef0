"""The port's reference-checkpoint converter
(ddmi_tpu_torch/cli/convert_reference_ckpt.py) against the JAX package's.

Synthetic reference `ldm-last.pt` files in the original repository's save
format (keys and shapes enumerated by tests/test_interop.py's
ref_*_state_dict functions, independently of either package's models; the
video VAE also carries the TimeSformer's rotary buffers, which both
converters skip) go through the port's converter and through JAX's
numpy converters (`convert_stage1_*`, `convert_stage2_*`: what JAX's
`convert` runs before it writes its Orbax state; its eager flax inits
take over a minute on the CPU, and tests/test_interop.py drives it whole),
for each of the four domains.  The port's stage-1 and stage-2
checkpoints and JAX's params mapped by ddmi_tpu_torch/interop.py must
be equal bit for bit, the EMA too.  A
missing, extra or misshapen tensor raises (a UNet file for a `DiT: True`
config too; the MDTv2 branch is tests/test_torch_mdt_convert.py's); the
converted image save_pth is served and resumed by `train` (both stages)
through the port's CLI.
"""

import json
import warnings

import numpy as np
import pytest
import torch
import yaml

from ddmi_tpu.core.config import DDConfig, UNetConfig
from ddmi_tpu_torch import interop
from ddmi_tpu_torch.cli.convert_reference_ckpt import convert, load_reference_checkpoint
from test_interop import (
    ref_mlp3d_state_dict,
    ref_mlp_nerf_state_dict,
    ref_mlp_state_dict,
    ref_mlp_video_state_dict,
    ref_pointnet_state_dict,
    ref_triplane_vae_state_dict,
    ref_unet_state_dict,
    ref_unet_triplane_state_dict,
    ref_vae_state_dict,
    ref_video_vae_state_dict,
)

torch.set_num_threads(2)

LC = {"epochs": 1, "warmup_epochs": 0, "save_and_sample_every": 1,
      "gradient_accumulate_every": 1, "multiscale": False}
UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=[2],
            channel_mult=[1, 2], num_head_channels=16)
TRI_DD = dict(double_z=True, z_channels=8, resolution=16, in_channels=3, out_ch=4, ch=32,
              ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], hdbf_resolutions=[8],
              inter_attn_resolutions=[16], attn_type="vanilla")
CONFIGS = {
    "image": {
        "model": {"embed_dim": 4, "params": {
            "ddconfig": dict(double_z=True, z_channels=8, resolution=16, in_channels=3,
                             out_ch=4, ch=32, ch_mult=[1, 1, 2], num_res_blocks=1,
                             attn_resolutions=[], hdbf_resolutions=[4, 8]),
            "mlpconfig": dict(in_ch=2, out_ch=3, ch=32, latent_dim=4),
            "unetconfig": dict(UNET, image_size=4, in_channels=4, out_channels=4),
            "ddpmconfig": dict(timesteps=20, image_size=4, channels=4,
                               sampling_timesteps=4)}},
        "data": {"domain": "image", "test_resolution": 16}},
    "video": {
        "model": {"embed_dim": 8, "params": {
            "ddconfig": dict(double_z=True, z_channels=16, resolution=16, in_channels=3,
                             out_ch=4, ch=32, ch_mult=[1, 1, 1, 1], num_res_blocks=1,
                             attn_resolutions=[], hdbf_resolutions=[4, 8],
                             inter_attn_resolutions=[2, 8], attn_type="vanilla-multihead",
                             timesformer_channels=32, patch_size=8, splits=1),
            "mlpconfig": dict(in_ch=3, out_ch=3, ch=32, latent_dim=4),
            "unetconfig": dict(UNET, in_channels=8, out_channels=8),
            "ddpmconfig": dict(timesteps=20, channels=8, sampling_timesteps=4)}},
        "data": {"domain": "video", "frames": 4, "test_resolution": 16}},
    "occupancy": {
        "model": {"embed_dim": 4, "pointnet": {"c_dim": 3, "hidden_dim": 8,
                                               "plane_resolution": 16, "n_blocks": 3},
                  "params": {
            "ddconfig": TRI_DD, "mlpconfig": dict(in_ch=3, out_ch=1, ch=32, latent_dim=4),
            "unetconfig": dict(UNET, image_size=8, in_channels=12, out_channels=12),
            "ddpmconfig": dict(timesteps=20, image_size=8, channels=12,
                               sampling_timesteps=4)}},
        "data": {"domain": "occupancy"}},
    "nerf": {
        "model": {"embed_dim": 4, "pointnet": {"c_dim": 3, "hidden_dim": 8,
                                               "plane_resolution": 16, "n_blocks": 3},
                  "params": {
            "ddconfig": TRI_DD,
            "mlpconfig": dict(in_ch=3, out_ch=4, ch=32, latent_dim=4, D=2, W=32, skips=[1],
                              multires=2, multires_views=1, N_samples=8),
            "unetconfig": dict(UNET, image_size=8, in_channels=12, out_channels=12),
            "ddpmconfig": dict(timesteps=20, image_size=8, channels=12,
                               sampling_timesteps=4)}},
        "data": {"domain": "nerf"}},
}


def _write_config(tmp_path, domain, **model):
    raw = json.loads(json.dumps(CONFIGS[domain]))
    raw["model"].update({"DiT": False, "resume": False, "use_fp16": False, "amp": False,
                         "lr": 1e-4, **model})
    raw["model"]["params"]["lossconfig"] = dict(LC)
    raw["data"].update({"mode": "train", "dataset": "synthetic", "data_dir": "/tmp/none",
                        "test_data_dir": "/tmp/none", "save_pth": str(tmp_path / "save"),
                        "batch_size": 2, "test_batch_size": 2})
    path = tmp_path / f"{domain}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _jax_cfgs(domain):
    """The JAX package's DDConfig and UNetConfig of the domain's config."""
    p = CONFIGS[domain]["model"]["params"]
    dd = DDConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in p["ddconfig"].items()})
    u = UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in p["unetconfig"].items()})
    return dd, u


def _reference(domain, in_xyz_dir=None):
    """A synthetic reference ldm file's contents: stage-1 modules, the DDPM
    (UNet, mixing logit, a schedule buffer) and its ema_pytorch copy."""
    dd, u = _jax_cfgs(domain)
    m = CONFIGS[domain]["model"]
    e = m["embed_dim"]
    if domain == "image":
        from ddmi_tpu.core.config import MLPConfig

        data = {"vaemodel": ref_vae_state_dict(dd, embed_dim=e),
                "mlp": ref_mlp_state_dict(MLPConfig(**m["params"]["mlpconfig"]))}
        unet, logit = ref_unet_state_dict(u), (1, u.out_channels, 1, 1)
    elif domain == "video":
        vae = ref_video_vae_state_dict(dd, embed_dim=e, frames=4)
        # the rotary tables the reference keeps as buffers, recomputed by both ports
        vae["encoder.frame_rot_emb.scales"] = np.ones(4, np.float32)
        vae["encoder.image_rot_emb.inv_freqs"] = np.ones(4, np.float32)
        data = {"vaemodel": vae, "mlp": ref_mlp_video_state_dict(4, 3, 32)}
        unet, logit = ref_unet_triplane_state_dict(u), (1, u.out_channels, 1)
    else:
        pn = m["pointnet"]
        data = {"vaemodel": ref_triplane_vae_state_dict(dd, embed_dim=e),
                "pointnet": ref_pointnet_state_dict(3 if domain == "occupancy" else 6,
                                                    pn["hidden_dim"], pn["c_dim"],
                                                    pn["n_blocks"])}
        if domain == "occupancy":
            data["mlp"] = ref_mlp3d_state_dict(3, dd.out_ch, 1, 32)
        else:
            data["mlp"] = ref_mlp_nerf_state_dict(2, 32, *in_xyz_dir, skips=(1,))
        unet, logit = ref_unet_state_dict(u), (1, u.out_channels, 1, 1)
    rng = np.random.default_rng(0)
    diffusion = {f"model.{k}": v for k, v in unet.items()}
    diffusion["mixing_logit"] = rng.standard_normal(logit).astype(np.float32)
    diffusion["betas"] = np.linspace(1e-4, 0.02, 20).astype(np.float32)
    # an EMA that differs from the weights
    ema = {f"ema_model.{k}": v + np.float32(0.01) for k, v in diffusion.items()}
    data.update({"step": 777, "diffusion": diffusion, "ema": ema})
    return {k: ({n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in v.items()}
                if isinstance(v, dict) else v) for k, v in data.items()}


def _save(tmp_path, data):
    path = tmp_path / "ldm-last.pt"
    torch.save(data, str(path))
    return str(path)


def _port_files(save):
    import glob

    out = {}
    for prefix in ("stage1", "stage2"):
        (f,) = glob.glob(f"{save}/{prefix}/*.pt")
        out[prefix] = (f, torch.load(f, map_location="cpu", weights_only=True)["state"])
    return out


def _assert_equal(got: dict, want: dict, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        assert got[k].shape == v.shape and torch.equal(got[k].float(), v.float()), (what, k)


def _jax_stage1(domain, data, pipe):
    """JAX's numpy converters on `data` -> the port's stage-1 state_dicts."""
    from ddmi_tpu.interop import reference_ckpt as ref

    p = CONFIGS[domain]["model"]["params"]
    dd, _ = _jax_cfgs(domain)
    np_data = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v)
               for k, v in data.items()}
    if domain == "image":
        from ddmi_tpu.core.config import MLPConfig

        j = ref.convert_stage1_image(np_data, dd, MLPConfig(**p["mlpconfig"]), vae_key="vaemodel")
        return {"vae": interop.vae_from_jax(j["vae"], dd),
                "mlp": interop.mlp_image_from_jax(j["mlp"], MLPConfig(**p["mlpconfig"]))}
    if domain == "video":
        j = ref.convert_stage1_video(np_data, dd)
        return {"vae": interop.video_vae_from_jax(j["vae"], dd),
                "mlp": interop.mlp_video_from_jax(j["mlp"])}
    j = ref.convert_stage1_3d(np_data, dd, domain, nerf_depth=2, pointnet_blocks=3)
    mlp = (interop.mlp3d_from_jax(j["mlp"]) if domain == "occupancy"
           else interop.mlp_nerf_from_jax(j["mlp"], 2))
    return {"pointnet": interop.pointnet_from_jax(j["pointnet"], 3),
            "vae": interop.triplane_vae_from_jax(j["vae"], dd), "mlp": mlp}


def _jax_stage2(domain, data, use_ema, unet_cfg):
    """JAX's stage-2 converter -> {"unet.<k>": ..., "mixing_logit": ...} in
    the port's layouts."""
    from ddmi_tpu.interop import reference_ckpt as ref

    np_data = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v)
               for k, v in data.items()}
    if domain == "video":
        j = ref.convert_stage2_video(np_data, unet_cfg, use_ema=use_ema)
        unet = interop.triplane_unet_from_jax(j["unet"], unet_cfg)
        logit = torch.from_numpy(np.asarray(j["mixing_logit"]))  # (1, 1, C), the port's
    else:
        j = ref.convert_stage2_image(np_data, unet_cfg, use_ema=use_ema)
        unet = interop.unet_from_jax(j["unet"], unet_cfg)
        logit = torch.from_numpy(np.transpose(np.asarray(j["mixing_logit"]), (0, 3, 1, 2)))
    return {**{f"unet.{k}": v for k, v in unet.items()}, "mixing_logit": logit}


@pytest.mark.parametrize("domain", ["image", "video", "occupancy", "nerf"])
def test_converter_matches_jax(tmp_path, domain):
    """The port's checkpoints equal JAX's converted params and EMA, mapped
    by interop.py, bit for bit; both files in the trainer's layout at the
    reference step."""
    from ddmi_tpu_torch.cli.main import pipeline_class
    from ddmi_tpu_torch.core.config import load_config

    path = _write_config(tmp_path, domain)
    pipe = pipeline_class(domain)(load_config(path, exp="ldm"), device="cpu")
    xyz_dir = ((pipe.mlp.in_channels_xyz, pipe.mlp.in_channels_dir) if domain == "nerf"
               else None)
    data = _reference(domain, xyz_dir)
    convert("ldm", path, _save(tmp_path, data), device="cpu", steps_per_epoch=2)
    files = _port_files(str(tmp_path / "save"))
    s1, s2 = files["stage1"][1], files["stage2"][1]
    assert files["stage1"][0].endswith("777.pt") and files["stage2"][0].endswith("777.pt")
    assert s2["step"] == 777
    want1 = _jax_stage1(domain, data, pipe)
    for name, sd in want1.items():
        got = {k[len(name) + 1:]: v for k, v in s1["params"].items() if k.startswith(name + ".")}
        _assert_equal(got, sd, f"{domain} stage1 {name}")
    unet_cfg = pipe.unet.cfg  # the video pipeline fills plane_sizes in
    _assert_equal(s2["params"], _jax_stage2(domain, data, False, unet_cfg), f"{domain} params")
    _assert_equal(s2["ema"], _jax_stage2(domain, data, True, unet_cfg), f"{domain} ema")
    assert not torch.equal(s2["ema"]["mixing_logit"], s2["params"]["mixing_logit"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_converter_refuses_a_mismatched_file(tmp_path, fault):
    path = _write_config(tmp_path, "image")
    data = _reference("image")
    if fault == "missing":
        key = sorted(data["mlp"])[0]
        del data["mlp"][key]
        match = rf"missing=\['{key}'\]"
    elif fault == "extra":
        data["diffusion"]["model.out.9.weight"] = torch.zeros(3)
        match = r"extra=\['out.9.weight'\]"
    else:
        data["vaemodel"]["decoder.conv_in.weight"] = torch.zeros(1, 2, 3, 3)
        match = "shape mismatches.*decoder.conv_in.weight"
    with pytest.raises(ValueError, match=match):
        convert("ldm", path, _save(tmp_path, data), device="cpu", steps_per_epoch=2)


def test_converter_refuses_mdt_and_warns_before_a_full_unpickle(tmp_path):
    """A DiT config refuses a file whose denoiser is a UNet (the MDTv2
    branch is tests/test_torch_mdt_convert.py's); a file a weights-only
    load rejects is unpickled in full only after a warning."""
    import argparse

    path = _write_config(tmp_path, "image", DiT=True)
    with pytest.raises(ValueError, match=r"stage2 'diffusion'.*missing=\['de_blocks.*extra=\['input_blocks"):
        convert("ldm", path, _save(tmp_path, _reference("image")), device="cpu",
                steps_per_epoch=2)
    pt = str(tmp_path / "args.pt")
    torch.save({"args": argparse.Namespace(lr=1e-4), "w": torch.ones(2)}, pt)
    with pytest.warns(UserWarning, match="FULL pickle loading"):
        data = load_reference_checkpoint(pt)
    assert data["args"].lr == 1e-4 and torch.equal(data["w"], torch.ones(2))
    torch.save({"w": torch.ones(2)}, pt)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(load_reference_checkpoint(pt)["w"], torch.ones(2))


def test_converted_image_is_served_and_resumed(tmp_path, monkeypatch):
    """The converted save_pth (stage 1 from a d2c-vae file, then an ldm
    file) is served with its EMA at the reference step, and `train` with
    model.resume: True continues each stage from the converted step (an
    epoch of 2 synthetic batches)."""
    import functools

    from ddmi_tpu_torch import data as port_data
    from ddmi_tpu_torch.cli.main import main
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.serve.server import SamplerService

    monkeypatch.setattr(port_data, "SyntheticImages",
                        functools.partial(port_data.SyntheticImages, length=2))

    data = _reference("image")
    path = _write_config(tmp_path, "image", resume=True)
    stage1 = {"step": 55, "model": data["vaemodel"], "mlp": data["mlp"]}
    convert("d2c-vae", path, _save(tmp_path, stage1), device="cpu", steps_per_epoch=2)
    assert _port_files_one(tmp_path / "save", "stage1")["step"] == 55
    convert("ldm", path, _save(tmp_path, data), device="cpu", steps_per_epoch=2)
    cfg = load_config(path, exp="ldm")
    svc = SamplerService(cfg, service_batch=1, resolution=16, device="cpu")
    try:
        assert svc.step == 777
        ema = _port_files_one(tmp_path / "save", "stage2")["ema"]
        for k, v in svc.pipe.unet.state_dict().items():
            assert torch.equal(v, ema[f"unet.{k}"]), k
        assert svc.generate(1, seed=0, timeout=300).shape == (1, 16, 16, 3)
    finally:
        svc.close()
    for exp, prefix, start in (("ldm", "stage2", 777), ("d2c-vae", "stage1", 777)):
        main(["--exp", exp, "--configs", path, "--device", "cpu"])
        steps = sorted(int(f.stem) for f in (tmp_path / "save" / prefix).glob("*.pt"))
        state = _port_files_one(tmp_path / "save", prefix, steps[-1])
        assert steps[-1] > start and state["step"] == steps[-1], (prefix, steps)


def _port_files_one(save, prefix, step=None):
    files = sorted((save / prefix).glob("*.pt"), key=lambda f: int(f.stem))
    f = files[-1] if step is None else save / prefix / f"{step}.pt"
    return torch.load(str(f), map_location="cpu", weights_only=True)["state"]
