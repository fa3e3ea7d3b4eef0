"""Video training through the port's Trainer, on the CPU, at the small
config of tests/test_torch_video_train.py: stage 1 then stage 2 in one save
directory with bit-exact resume of both, the eval hooks (stage 1's PSNR,
stage 2's EMA samples for video and image), the MEA backward's saved memory,
and a run in a fresh interpreter that never loads JAX.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ddmi_tpu_torch.core.config import config_from_dict
from test_torch_stage1_train import _assert_same, _state_arrays
from test_torch_video_train import B, RES, T, _cfg

torch.set_num_threads(1)


class _Clips:
    def __init__(self, length, seed=1):
        from ddmi_tpu_torch.data.video import SyntheticVideos

        self.src = SyntheticVideos(B, T, RES, length=length, seed=seed)

    def __len__(self):
        return len(self.src)

    def __iter__(self):
        return iter(self.src)


def _trainer(path, adversarial=False):
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.domains.video import VideoPipeline

    d = _cfg(adversarial=adversarial)
    d["data"]["save_pth"] = str(path)
    d["data"]["extra"] = {"prefetch": 0, "nan_check_every": 1}
    cfg = config_from_dict(d)
    return Trainer(cfg, VideoPipeline(cfg, device="cpu", seed=0), _Clips(2))


def test_video_stages_resume_bit_exact_and_hand_off(tmp_path):
    """Stage 1 (adversarial, so the 2D + 3D discriminators and their
    optimizer are in the state) over 2 epochs of 2 micro-steps in one run
    equals one epoch, a checkpoint, a new pipeline resuming and one more,
    bit for bit; each save's eval hook logs eval/psnr of 2 reconstructed
    clips.  Then stage 2 in the same directory takes the VAE and INR of the
    newest stage-1 checkpoint, and its 2 epochs equal 1 + resume + 1 bit for
    bit (parameters, EMA, moments, accumulator, counts); its eval hook saves
    an EMA video sample's frames after each save."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager

    one = _trainer(tmp_path / "one", adversarial=True).train_stage1(epochs=2)
    _trainer(tmp_path / "two", adversarial=True).train_stage1(epochs=1)
    two = _trainer(tmp_path / "two", adversarial=True).train_stage1(epochs=1, resume=True)
    assert one.step == two.step == 4
    _assert_same(_state_arrays(one), _state_arrays(two))
    recs = [json.loads(line) for line in open(tmp_path / "one" / "train.jsonl")]
    psnr = [r["eval/psnr"] for r in recs if "eval/psnr" in r]
    assert len(psnr) == 2 and all(np.isfinite(psnr)), recs
    assert not [r for r in recs if "s1/eval_hook_failures" in r]

    s2 = _trainer(tmp_path / "one")
    first = s2.train_stage2(epochs=2)
    saved = CheckpointManager(str(tmp_path / "one"), prefix="stage1").restore()["state"]["params"]
    for k, v in s2.pipe.vae.state_dict().items():
        assert torch.equal(v.float(), saved["vae." + k].float()), k
    for k, v in s2.pipe.mlp.state_dict().items():
        assert torch.equal(v, saved["mlp." + k]), k
    _trainer(tmp_path / "two").train_stage2(epochs=1)
    second = _trainer(tmp_path / "two").train_stage2(epochs=1, resume=True)
    assert first.step == second.step == 4
    _assert_same(_state_arrays(first), _state_arrays(second))
    frames = sorted(f for f in os.listdir(tmp_path / "one" / "samples"))
    assert [f for f in frames if f.startswith("ep0_video")] and [
        f for f in frames if f.startswith("ep1_video")], frames
    recs = [json.loads(line) for line in open(tmp_path / "one" / "train.jsonl")]
    assert not [r for r in recs if "s2/eval_hook_failures" in r]


def test_stage2_eval_hook_samples_images_with_the_ema_weights(tmp_path):
    """The image branch of default_stage2_eval_hook: 2 EMA samples saved
    under samples/ep<epoch>_*, and the trained parameters back bit for bit
    after it."""
    from ddmi_tpu_torch.core.trainer import Trainer, default_stage2_eval_hook
    from ddmi_tpu_torch.data.synthetic import SyntheticImages
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from test_torch_stage1_train import _cfg as image_cfg

    d = image_cfg()
    d["data"].update(save_pth=str(tmp_path), test_resolution=32,
                     extra={"prefetch": 0, "nan_check_every": 1})
    d["model"]["params"]["ddpmconfig"]["sampling_timesteps"] = 3
    cfg = config_from_dict(d)
    trainer = Trainer(cfg, ImagePipeline(cfg, device="cpu", seed=0),
                      SyntheticImages(2, 64, length=1, seed=0))
    state = trainer.train_stage2(epochs=1, save=False)
    with torch.no_grad():
        for k, e in state.ema.items():
            e.add_(0.01)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    default_stage2_eval_hook(trainer, state, 3)
    assert all(torch.equal(before[k], p) for k, p in state.params.items())
    assert all(p.dtype == torch.float32 for p in trainer.pipe.unet.parameters())
    saved = sorted(os.listdir(tmp_path / "samples"))
    assert saved and all(f.startswith("ep3") for f in saved), saved


def test_mea_backward_saves_memory_linear_in_n():
    """The streamed MEA under autograd at n = 8192, head dim 4: the bytes
    autograd saves for the backward (summed through saved_tensors_hooks)
    stay below 64 n d x 4 bytes, O(n d) (the scores would be n^2 x 4 =
    268 MB); the backward runs from them and matches a small dense
    attention's gradient shape."""
    from ddmi_tpu_torch.ops import mea

    n, d = 8192, 4
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 1, n, d), generator=g).requires_grad_() for _ in range(3))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = mea.attention(q, k, v)
    total = sum(saved)
    assert total <= 64 * n * d * 4, total
    out.sum().backward()
    assert all(t.grad.shape == (1, 1, n, d) and torch.isfinite(t.grad).all() for t in (q, k, v))


def test_port_video_training_never_imports_jax(tmp_path):
    """A fresh interpreter trains video stage 1 (adversarial), resumes it,
    reconstructs 2 clips and hands the checkpoint to stage 2 without loading
    jax or any module of the JAX package."""
    d = _cfg(adversarial=True)
    d["data"]["save_pth"] = str(tmp_path)
    code = textwrap.dedent(f"""
        import sys, warnings
        warnings.simplefilter("ignore")
        import torch
        torch.set_num_threads(1)
        from ddmi_tpu_torch.core.config import config_from_dict
        from ddmi_tpu_torch.core.trainer import Trainer
        from ddmi_tpu_torch.data.video import SyntheticVideos
        from ddmi_tpu_torch.domains.video import VideoPipeline
        from ddmi_tpu_torch.evals.lpips import build_perceptual
        d = {d!r}
        cfg = config_from_dict(d)
        data = SyntheticVideos(2, {T}, {RES}, length=2, seed=0)
        pipe = VideoPipeline(cfg, device="cpu", seed=0, perceptual=build_perceptual(cfg, "cpu"))
        Trainer(cfg, pipe, data).train_stage1(epochs=1)
        pipe = VideoPipeline(cfg, device="cpu", seed=0, perceptual=build_perceptual(cfg, "cpu"))
        st = Trainer(cfg, pipe, data).train_stage1(epochs=1, resume=True)
        assert st.step == 4, st.step
        out = pipe.reconstruct(torch.rand(2, {T}, {RES}, {RES}, 3))
        assert out.shape == (2, {T}, {RES}, {RES}, 3)
        d["model"]["params"]["lossconfig"]["adversarial"] = False
        cfg = config_from_dict(d)
        s2 = Trainer(cfg, VideoPipeline(cfg, device="cpu", seed=0), data).train_stage2(epochs=1)
        assert s2.step == 2
        assert "jax" not in sys.modules, "the port loaded jax"
        assert not [m for m in sys.modules if m.split(".")[0] == "ddmi_tpu"]
        print("OK")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize("name", ["sky", "folder"])
def test_video_frame_folders_load_as_the_jax_loader_does(tmp_path, name):
    """make_video_dataset over a frame-folder tree (two clips, one shorter
    than the window and loop-padded) yields the JAX package's batches bit
    for bit."""
    from PIL import Image

    from ddmi_tpu.data.video import make_video_dataset as jax_make
    from ddmi_tpu_torch.data.video import make_video_dataset

    rng = np.random.default_rng(0)
    for clip, frames in (("a", 6), ("b", 3)):
        os.makedirs(tmp_path / "train" / clip)
        for i in range(frames):
            Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(
                tmp_path / "train" / clip / f"{i:03d}.png")
    kw = dict(frames=4, resolution=16, seed=3, workers=2)
    got = list(make_video_dataset(name, str(tmp_path), 2, **kw))
    ref = list(jax_make(name, str(tmp_path), 2, **kw))
    assert len(got) == len(ref) == 1
    assert got[0].shape == (2, 4, 16, 16, 3) and np.array_equal(got[0], ref[0])
