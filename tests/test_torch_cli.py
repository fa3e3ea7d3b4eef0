"""The PyTorch port's entry point on the CPU: the image-folder loader
against the JAX package's (bit for bit over two epochs), the profiler
hook, and the slice as a whole: `ddmi_tpu_torch.cli.main([...,
'--device', 'cpu'])` on tests/test_cli_smoke.py's tiny image config
through d2c-vae train -> ldm train (with a profiled window) -> gen ->
eval --exp d2c-vae, and eval --exp ldm on the same checkpoints (trained
once, by a module fixture), asserting the files and eval.json keys the JAX
smoke asserts, with gen run in a fresh interpreter that must load no JAX
and no module of the JAX package; then the same for occupancy (its gen and
eval through the batched lockstep extraction, eval's 3 meshes in groups of
2).
tests/test_torch_cli_eval.py holds Trainer.evaluate against JAX's.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from ddmi_tpu_torch.cli.main import main

torch.set_num_threads(4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _base_cfg(save):
    """tests/test_cli_smoke.py's tiny image config."""
    return {
        "model": {
            "DiT": False, "pretrained": False, "resume": False,
            "use_fp16": False, "amp": False, "lr": 1e-4, "embed_dim": 8,
            "params": {
                "lossconfig": {"epochs": 1, "warmup_epochs": 0, "save_and_sample_every": 1,
                               "gradient_accumulate_every": 1, "sn_reg": True,
                               "multiscale": False},
                "ddconfig": {"double_z": True, "z_channels": 32, "resolution": 32,
                             "in_channels": 3, "out_ch": 16, "ch": 32, "ch_mult": [1, 2, 4],
                             "num_res_blocks": 1, "attn_resolutions": [],
                             "hdbf_resolutions": [8, 16]},
                "mlpconfig": {"in_ch": 2, "out_ch": 3, "ch": 64, "latent_dim": 16},
                "unetconfig": {"image_size": 8, "in_channels": 8, "model_channels": 32,
                               "out_channels": 8, "num_res_blocks": 1,
                               "attention_resolutions": [2], "channel_mult": [1, 2],
                               "num_head_channels": 16},
                "ddpmconfig": {"timesteps": 20, "image_size": 8, "channels": 8,
                               "sampling_timesteps": 4},
            },
        },
        "data": {"domain": "image", "mode": "train", "dataset": "synthetic",
                 "data_dir": "/tmp/none", "test_data_dir": "/tmp/none", "save_pth": save,
                 "batch_size": 8, "test_batch_size": 2, "test_resolution": 16},
    }


def _write(tmp_path, cfg, name):
    p = tmp_path / name
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def _cli(tmp_path, cfg, exp, mode, name, **extra):
    cfg["data"]["mode"] = mode
    cfg["data"]["extra"] = extra
    main(["--exp", exp, "--configs", _write(tmp_path, cfg, name), "--device", "cpu"])


def _images(root, seed):
    """Seven PNGs: five at 32^2 and two of other shapes (LANCZOS-resized),
    in two subfolders."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i, shape in enumerate([(32, 32)] * 5 + [(40, 28), (20, 36)]):
        d = root / f"class{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, shape + (3,), dtype=np.uint8)).save(d / f"{i}.png")


def test_image_folder_batches_match_jax_over_two_epochs(tmp_path):
    """ImageFolderDataset against the JAX package's on the same folder and
    seed: the same batches, bit for bit, over two epochs (each epoch's
    shuffle and flip coins from default_rng(seed + epoch)), with a thread
    pool decoding; a folder without images raises as JAX's does."""
    pytest.importorskip("PIL")
    from ddmi_tpu.data.image_folder import ImageFolderDataset as JaxDataset
    from ddmi_tpu_torch.data.image_folder import ImageFolderDataset

    _images(tmp_path / "imgs", 0)
    kw = dict(batch_size=2, resolution=32, random_flip=True, seed=5, workers=2)
    ours, ref = ImageFolderDataset(str(tmp_path / "imgs"), **kw), JaxDataset(
        str(tmp_path / "imgs"), **kw)
    assert len(ours) == len(ref) == 3
    for epoch in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and a.shape == (2, 32, 32, 3)
            assert np.array_equal(a, b), epoch
    assert not np.array_equal(np.stack(got), np.stack(list(ImageFolderDataset(
        str(tmp_path / "imgs"), **{**kw, "seed": 9}))))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ImageFolderDataset(str(tmp_path / "empty"), 2)


def test_profiler_hook_writes_a_chrome_trace(tmp_path):
    """ProfilerHook starts at its start step, stops at start + num_steps and
    writes a Chrome trace holding the ops run in between; close() writes a
    profile the run ended inside."""
    from ddmi_tpu_torch.core.metrics import ProfilerHook

    hook = ProfilerHook(str(tmp_path / "profile"), start_step=2, num_steps=2)
    x = torch.randn(64, 64)
    for step in range(1, 6):
        x = torch.tanh(x @ x.t() / 64)
        hook.step(step)
    assert hook.path == str(tmp_path / "profile" / "trace_2_4.json")
    names = {e.get("name") for e in json.load(open(hook.path))["traceEvents"]}
    assert "aten::tanh" in names and "aten::mm" in names
    late = ProfilerHook(str(tmp_path / "late"), start_step=1, num_steps=10)
    late.step(1)
    torch.relu(x)
    late.close(3)
    assert os.path.exists(tmp_path / "late" / "trace_1_3.json")


def short_synthetic_images(monkeypatch):
    """The CLI's synthetic image loader at 6 batches an epoch (its default
    64 reaches no further check)."""
    import functools

    from ddmi_tpu_torch import data as port_data

    monkeypatch.setattr(port_data, "SyntheticImages",
                        functools.partial(port_data.SyntheticImages, length=6))


@pytest.fixture(scope="module")
def image_run(tmp_path_factory):
    """The image slice's two stages trained through the CLI, stage 2 with
    data.extra.profile_steps 2 (the synthetic loader's epoch is 6
    batches); -> (the directory of the configs, the config dict, the save
    directory).  The eval tests below read its checkpoints."""
    tmp_path = tmp_path_factory.mktemp("cli_image")
    save = str(tmp_path / "run")
    cfg = _base_cfg(save)
    with pytest.MonkeyPatch.context() as mp:
        short_synthetic_images(mp)
        _cli(tmp_path, cfg, "d2c-vae", "train", "s1.yaml")
        _cli(tmp_path, cfg, "ldm", "train", "s2.yaml", profile_steps=2)
    return tmp_path, cfg, save


def test_cli_image_train_gen_eval(image_run):
    """The image slice through the CLI on the CPU, as tests/test_cli_smoke.py
    drives the JAX one: stage 1 and stage 2 checkpoints and the eval hooks'
    images; stage 2 with data.extra.profile_steps 2 writes a trace of
    micro-steps 3-4; gen (in a fresh interpreter that loads no JAX)
    writes generation_<i>.png (or .npy); eval --exp d2c-vae writes a
    finite rfid (test_cli_image_eval_fid holds eval --exp ldm's fid)."""
    tmp_path, cfg, save = image_run
    cfg = json.loads(json.dumps(cfg))
    assert os.listdir(os.path.join(save, "stage1")) and os.listdir(os.path.join(save, "stage2"))
    assert any(f.startswith("ep") for f in os.listdir(os.path.join(save, "recon")))
    assert any(f.startswith("ep") for f in os.listdir(os.path.join(save, "samples")))
    assert os.listdir(os.path.join(save, "profile")) == ["trace_2_4.json"]

    cfg["data"]["mode"] = "gen"
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys, warnings
        warnings.simplefilter("ignore")
        import torch
        torch.set_num_threads(4)
        import ddmi_tpu_torch
        for m in pkgutil.walk_packages(ddmi_tpu_torch.__path__, "ddmi_tpu_torch."):
            importlib.import_module(m.name)
        from ddmi_tpu_torch.cli.main import main
        main(["--exp", "ldm", "--configs", {_write(tmp_path, cfg, "gen.yaml")!r},
              "--device", "cpu"])
        assert "jax" not in sys.modules, "the port loaded jax"
        assert not [m for m in sys.modules if m.split(".")[0] == "ddmi_tpu"]
        print("NO-JAX OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=300)
    assert "NO-JAX OK" in out.stdout, out.stderr[-3000:]
    assert os.path.exists(os.path.join(save, "generation_0.png")) or \
        os.path.exists(os.path.join(save, "generation.npy"))

    _cli(tmp_path, cfg, "d2c-vae", "eval", "ev1.yaml")
    results = json.load(open(os.path.join(save, "eval.json")))
    assert "rfid" in results and np.isfinite(results["rfid"])


def test_cli_image_eval_fid(image_run):
    """eval --exp ldm over 8 samples, on the image run's checkpoints,
    writes a finite fid to eval.json."""
    tmp_path, cfg, save = image_run
    cfg = json.loads(json.dumps(cfg))
    _cli(tmp_path, cfg, "ldm", "eval", "ev2.yaml", eval_samples=8)
    results = json.load(open(os.path.join(save, "eval.json")))
    assert "fid" in results and np.isfinite(results["fid"])


def test_cli_occupancy_train_gen_eval(tmp_path, monkeypatch):
    """The occupancy slice through the CLI on the CPU, as
    tests/test_cli_smoke.py drives the JAX one: both stages (the stage-2
    hook writes an .off mesh), gen through the batched lockstep extraction
    (generation/mesh_0.off), eval --exp ldm over 3 meshes in groups of 2
    (the padded last group) and eval --exp d2c-vae (the IoU).  The
    synthetic loader's epoch is 2 batches (its default 8 reaches no further
    check), and a convocc config gives the pointnet's widths and MISE's
    grid, 16^3 with one upsampling step (its default, 64^3 with two,
    reaches no further check)."""
    import functools

    from ddmi_tpu_torch.data import shapenet

    monkeypatch.setattr(shapenet, "SyntheticOccupancy",
                        functools.partial(shapenet.SyntheticOccupancy, length=2))
    save = str(tmp_path / "occ")
    cfg = _base_cfg(save)
    cfg["data"].update({"domain": "occupancy"})
    p = cfg["model"]["params"]
    p["ddconfig"].update({"in_channels": 8, "out_ch": 8, "inter_attn_resolutions": [32, 16]})
    p["mlpconfig"].update({"in_ch": 3, "out_ch": 1})
    p["unetconfig"].update({"in_channels": 24, "out_channels": 24})
    p["ddpmconfig"].update({"channels": 24})
    conv = {"model": {"c_dim": 8, "encoder_kwargs": {"hidden_dim": 32, "plane_resolution": 32,
                                                     "n_blocks": 3}},
            "generation": {"resolution_0": 16, "upsampling_steps": 1}}
    cfg["data"]["conv_config"] = _write(tmp_path, conv, "convocc.yaml")
    _cli(tmp_path, cfg, "d2c-vae", "train", "occ1.yaml")
    _cli(tmp_path, cfg, "ldm", "train", "occ2.yaml")
    assert any(f.endswith(".off") for f in os.listdir(os.path.join(save, "samples")))
    _cli(tmp_path, cfg, "ldm", "gen", "occ_gen.yaml")
    assert os.path.exists(os.path.join(save, "generation", "mesh_0.off"))
    _cli(tmp_path, cfg, "ldm", "eval", "occ_ev.yaml", eval_samples=3, mesh_batch=2)
    results = json.load(open(os.path.join(save, "eval.json")))
    assert isinstance(results, dict)
    assert not results or sorted(results) == ["1nna", "cov", "mmd"]
    _cli(tmp_path, cfg, "d2c-vae", "eval", "occ_ev1.yaml", eval_samples=8)
    results = json.load(open(os.path.join(save, "eval.json")))
    assert 0.0 <= results["iou"] <= 1.0


def test_parity_gate_config_parses_and_dispatches(monkeypatch, tmp_path):
    """configs/eval/celebahq_parity_gate.yaml (no weights or data here)
    parses with the port's reader and `main` dispatches it to
    Trainer.evaluate('ldm') on the card's or the CPU's pipeline; its gate
    ships a null published FID, which check_gates refuses loudly."""
    from ddmi_tpu_torch.cli import main as cli
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.evals.gates import check_gates

    monkeypatch.chdir(tmp_path)  # the config's save_pth is relative
    seen = {}
    monkeypatch.setattr(cli, "build_pipeline", lambda cfg, device: seen.update(
        cfg=cfg, device=device) or type("Pipe", (), {"device": device})())
    monkeypatch.setattr(cli, "build_dataset", lambda cfg, train=True: [])
    monkeypatch.setattr(Trainer, "evaluate", lambda self, exp: seen.update(exp=exp))
    monkeypatch.setattr(Trainer, "generate", lambda self: pytest.fail("gen dispatched"))
    cli.main(["--exp", "ldm", "--configs",
              os.path.join(ROOT, "configs/eval/celebahq_parity_gate.yaml"), "--device", "cpu"])
    cfg = seen["cfg"]
    assert seen["exp"] == "ldm" and cfg.exp == "ldm" and str(seen["device"]) == "cpu"
    assert cfg.data.mode == "eval" and cfg.data.extra["eval_samples"] == 10000
    assert cfg.model.ddpmconfig.sampling_timesteps == 50 and cfg.seed == 42
    with pytest.raises(ValueError, match="2401.12517"):
        check_gates({"fid": 1.0}, cfg.data.extra["quality_gates"])
