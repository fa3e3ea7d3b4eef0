"""A `model.DiT: True` config through the port's entry points on the CPU:
the converter's MDTv2 branch against the JAX package's
`convert_stage2_mdt`, then the converted save_pth served over
`SamplerService` and through `ddmi-torch` (train with a resume, gen).

The synthetic reference ldm file carries tests/test_interop.py's
`ref_mdt_state_dict` (the original maskedtransformer.py keys and shapes,
its relative_position_index buffers included) in 'diffusion' and 'ema',
beside the image stage-1 modules of tests/test_torch_convert.py.
"""

import functools
import glob
import json

import numpy as np
import pytest
import torch
import yaml

from test_interop import ref_mdt_state_dict
from test_torch_convert import CONFIGS, LC, _assert_equal, _port_files, _reference, _save

torch.set_num_threads(2)

DIT = dict(input_size=4, patch_size=2, in_channels=4, hidden_size=32, depth=4, num_heads=4,
           decode_layer=2, mask_ratio=0.3)


def _dit_config(tmp_path):
    raw = json.loads(json.dumps(CONFIGS["image"]))
    raw["model"].update({"DiT": True, "resume": True, "use_fp16": False, "amp": False,
                         "lr": 1e-4})
    raw["model"]["params"]["lossconfig"] = dict(LC)
    raw["model"]["params"]["ditconfig"] = dict(DIT)
    raw["data"].update({"mode": "train", "dataset": "synthetic", "data_dir": "/tmp/none",
                        "test_data_dir": "/tmp/none", "save_pth": str(tmp_path / "save"),
                        "batch_size": 2, "test_batch_size": 2})
    path = tmp_path / "dit.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path), raw


def _dit_reference():
    data = _reference("image")
    sd = ref_mdt_state_dict(4, 2, 4, 32, 4, 4, 2, masked=True)
    rng = np.random.default_rng(1)
    diffusion = {f"model.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    diffusion["mixing_logit"] = torch.from_numpy(
        rng.standard_normal((1, 4, 1, 1)).astype(np.float32))
    data["diffusion"] = diffusion
    data["ema"] = {f"ema_model.{k}": v + (0 if v.dtype == torch.int64 else 0.01)
                   for k, v in diffusion.items()}
    return data


def _jax_mdt(data, use_ema):
    from ddmi_tpu.core.config import DiTConfig
    from ddmi_tpu.interop.reference_ckpt import convert_stage2_mdt
    from ddmi_tpu_torch.interop import mdt_from_jax

    np_data = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v)
               for k, v in data.items()}
    cfg = DiTConfig(**DIT)
    j = convert_stage2_mdt(np_data, cfg, use_ema=use_ema)
    out = {f"unet.{k}": v for k, v in mdt_from_jax(j["unet"], cfg).items()}
    out["mixing_logit"] = torch.from_numpy(np.transpose(np.asarray(j["mixing_logit"]),
                                                        (0, 3, 1, 2)))
    return out


def test_dit_is_converted_served_trained_and_generated(tmp_path, monkeypatch):
    """The converter writes the MDTv2 weights and their EMA equal, bit for
    bit, to JAX's convert_stage2_mdt mapped by interop.mdt_from_jax; the
    service restores the EMA and answers a request (and the serving CLI
    refuses --turbo); `train` with model.resume continues stage 2 from the
    converted step (an epoch of 2 synthetic batches) and `gen` writes the
    generated images."""
    from ddmi_tpu_torch import data as port_data
    from ddmi_tpu_torch.cli import serve
    from ddmi_tpu_torch.cli.convert_reference_ckpt import convert
    from ddmi_tpu_torch.cli.main import main
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.serve.server import SamplerService

    monkeypatch.setattr(port_data, "SyntheticImages",
                        functools.partial(port_data.SyntheticImages, length=2))
    path, raw = _dit_config(tmp_path)
    data = _dit_reference()
    convert("ldm", path, _save(tmp_path, data), device="cpu", steps_per_epoch=2)
    s2 = _port_files(str(tmp_path / "save"))["stage2"][1]
    assert s2["step"] == 777
    _assert_equal(s2["params"], _jax_mdt(data, False), "dit params")
    _assert_equal(s2["ema"], _jax_mdt(data, True), "dit ema")

    svc = SamplerService(load_config(path, exp="ldm"), service_batch=1, resolution=16,
                         device="cpu")
    try:
        assert svc.step == 777 and svc.pipe.is_dit
        for k, v in svc.pipe.unet.state_dict().items():
            assert torch.equal(v, s2["ema"][f"unet.{k}"]), k
        img = svc.generate(1, seed=0, timeout=300)
        assert img.shape == (1, 16, 16, 3) and img.dtype == np.uint8
    finally:
        svc.close()
    with pytest.raises(ValueError, match="turbo"):
        serve.build_service(serve.parse_args(["--configs", path, "--device", "cpu",
                                              "--turbo", "2"]))

    main(["--exp", "ldm", "--configs", path, "--device", "cpu"])
    steps = sorted(int(f.split("/")[-1][:-3]) for f in glob.glob(f"{tmp_path}/save/stage2/*.pt"))
    assert steps[-1] == 779
    raw["data"]["mode"] = "gen"
    (tmp_path / "gen.yaml").write_text(yaml.safe_dump(raw))
    main(["--exp", "ldm", "--configs", str(tmp_path / "gen.yaml"), "--device", "cpu"])
    out = glob.glob(f"{tmp_path}/save/generation*")
    assert out, "gen wrote nothing"


def test_dit_evaluate_samples_with_the_ema(tmp_path, monkeypatch):
    """`eval --exp ldm` on a DiT config: Trainer.evaluate hands the FID
    protocol (stubbed here: tests/test_torch_cli_eval.py holds the FID
    itself against JAX's) a sampler that draws through MDTv2 with the
    newest stage-2 checkpoint's EMA weights, and writes eval.json."""
    from ddmi_tpu_torch.cli.convert_reference_ckpt import convert
    from ddmi_tpu_torch.cli.main import main
    from ddmi_tpu_torch.evals import fid

    path, raw = _dit_config(tmp_path)
    data = _dit_reference()
    convert("ldm", path, _save(tmp_path, data), device="cpu", steps_per_epoch=2)
    seen = {}

    def fid_n(scorer, sample_fn, reals, n_samples, batch, generator, protocol_n):
        seen["imgs"] = sample_fn(generator)
        return 1.5

    monkeypatch.setattr(fid, "test_fid_n", fid_n)
    raw["data"]["mode"] = "eval"
    raw["data"]["extra"] = {"eval_samples": 2}
    (tmp_path / "eval.yaml").write_text(yaml.safe_dump(raw))
    main(["--exp", "ldm", "--configs", str(tmp_path / "eval.yaml"), "--device", "cpu"])
    assert json.load(open(tmp_path / "save" / "eval.json"))["fid"] == 1.5
    imgs = seen["imgs"]
    assert imgs.shape == (2, 16, 16, 3) and torch.isfinite(imgs).all()
