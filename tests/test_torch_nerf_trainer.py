"""NeRF training of the PyTorch port, on the CPU, beside
tests/test_torch_nerf_train.py (its config): the srn-cars and synthetic
loaders against the JAX package's, bit for bit, with the convocc configs'
cloud widths; and the trainer's stage-1 -> stage-2 hand-off with
bit-exact resume, whose NeRF eval hooks log nothing and fail nothing, as
in the JAX trainer.
"""

import os

import numpy as np
import torch

from ddmi_tpu_torch.core.config import config_from_dict
from test_torch_nerf_train import B, N_CLOUD, RES, nerf_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trainer(path):
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.data.nerf import SyntheticNeRF
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline

    d = nerf_cfg()
    d["data"]["save_pth"] = str(path)
    d["data"]["extra"] = {"prefetch": 0, "nan_check_every": 1}
    cfg = config_from_dict(d)
    return Trainer(cfg, NeRFPipeline(cfg, device="cpu", seed=0),
                   SyntheticNeRF(B, N_CLOUD, RES, length=2, seed=1))


def test_nerf_stages_resume_bit_exact_and_hand_off(tmp_path):
    """Stage 1 over 2 epochs of 2 micro-steps in one run equals one epoch, a
    checkpoint, a new pipeline resuming and one more, bit for bit; stage 2
    in the same directory takes the pointnet, VAE and INR of the newest
    stage-1 checkpoint and its 2 epochs equal 1 + resume + 1 bit for bit.
    The default eval hooks run after every save and, as in the JAX
    trainer, log nothing, write nothing and count no failure."""
    import json

    from test_torch_stage1_train import _assert_same, _state_arrays

    skip = lambda *a: None
    one = _trainer(tmp_path / "one")
    s1 = one.train_stage1(epochs=2)
    _trainer(tmp_path / "two").train_stage1(epochs=1, eval_hook=skip)
    resumed = _trainer(tmp_path / "two").train_stage1(epochs=1, eval_hook=skip, resume=True)
    _assert_same(_state_arrays(s1), _state_arrays(resumed))
    s2 = one.train_stage2(epochs=2)
    _trainer(tmp_path / "two").train_stage2(epochs=1, eval_hook=skip)
    again = _trainer(tmp_path / "two").train_stage2(epochs=1, eval_hook=skip, resume=True)
    _assert_same(_state_arrays(s2), _state_arrays(again))
    recs = [json.loads(line) for line in open(tmp_path / "one" / "train.jsonl")]
    assert len([r for r in recs if "s1/loss" in r]) == 4
    assert len([r for r in recs if "s2/loss" in r]) == 4
    assert not [k for r in recs for k in r if k.startswith("eval/") or "failures" in k], recs
    assert sorted(os.listdir(tmp_path / "one")) == ["stage1", "stage2", "train.jsonl"]


def test_nerf_loaders_are_bit_identical_to_jax(tmp_path):
    """NeRFShapeNetDataset (uint8 RGBA views, an 80% prefix for training,
    the rest for testing) over two epochs of each split, SyntheticNeRF: the
    same arrays as the JAX package's, bit for bit.  The convocc configs
    give the pointnet 6 values per point for srn_cars and 3 for shapenet."""
    from ddmi_tpu.data.nerf import NeRFShapeNetDataset as JaxSet
    from ddmi_tpu.data.nerf import SyntheticNeRF as JaxSynth
    from ddmi_tpu_torch.core.convocc_config import load_convocc_config, pointnet_input_dim
    from ddmi_tpu_torch.data import NeRFShapeNetDataset, SyntheticNeRF

    rng = np.random.default_rng(0)
    for i in range(6):
        np.savez(tmp_path / f"obj{i}.npz",
                 images=rng.integers(0, 256, (3, 8, 8, 4), dtype=np.uint8),
                 cam_poses=rng.normal(size=(3, 4, 4)).astype(np.float32),
                 data=rng.normal(size=(50, 6)).astype(np.float32))
    pairs = []
    for train in (True, False):
        kw = dict(batch_size=2 if train else 1, train=train, pointcloud_n=30, seed=5)
        ours, ref = NeRFShapeNetDataset(str(tmp_path), **kw), JaxSet(str(tmp_path), **kw)
        assert ours.files == ref.files and len(ours) == len(ref) == 2
        pairs += [(a, b) for _ in range(2) for a, b in zip(ours, ref)]
    pairs += list(zip(SyntheticNeRF(2, 40, 8, length=2, seed=3), JaxSynth(2, 40, 8, length=2,
                                                                         seed=3)))
    assert len(pairs) == 10
    for a, b in pairs:
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    conv = lambda name: load_convocc_config(os.path.join(ROOT, "configs/convocc/pointcloud", name))
    assert pointnet_input_dim(conv("srncars_nerf_3plane.yaml")) == 6
    assert pointnet_input_dim(conv("shapenet_3plane.yaml")) == 3
