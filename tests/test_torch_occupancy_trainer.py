"""Occupancy training of the PyTorch port, on the CPU, beside
tests/test_torch_occupancy_train.py (its config and helpers): the ShapeNet
and synthetic loaders and read_voxels against the JAX package's, bit for
bit; the pointnet's gradients at 3 and 6 input values per point against
jax.grad (ties in the max pool, empty cells); the trainer's stage-1 ->
stage-2 hand-off with bit-exact resume and the eval hooks after each save;
the stage-1 eval hook's IoU against the JAX trainer's; and the stage-2
eval hook's mesh.
"""

import collections
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.interop import pointnet_from_jax
from test_torch_occupancy_train import (
    B, N_CLOUD, N_PTS, Setup, jax_eps, nchw, occ_batch, occ_cfg, random_params,
)

torch.set_num_threads(1)


def _trainer(path, seed_data=0):
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.data.shapenet import SyntheticOccupancy
    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline

    d = occ_cfg()
    d["data"]["save_pth"] = str(path)
    d["data"]["extra"] = {"prefetch": 0, "nan_check_every": 1}
    cfg = config_from_dict(d)
    return Trainer(cfg, OccupancyPipeline(cfg, device="cpu", seed=0),
                   SyntheticOccupancy(B, N_PTS, N_CLOUD, length=2, seed=seed_data))


def _arrays(state):
    from test_torch_stage1_train import _state_arrays

    return _state_arrays(state)


def test_occupancy_stages_resume_bit_exact_and_hand_off(tmp_path):
    """Stage 1 over 2 epochs of 2 micro-steps in one run equals one epoch, a
    checkpoint, a new pipeline resuming and one more, bit for bit; each
    save's eval hook logs eval/iou.  Stage 2 in the same directory takes the
    pointnet, VAE and INR of the newest stage-1 checkpoint, its 2 epochs
    equal 1 + resume + 1 bit for bit, and its eval hook writes a mesh per
    save."""
    import json

    from test_torch_stage1_train import _assert_same

    skip = lambda *a: None
    one = _trainer(tmp_path / "one")
    s1 = one.train_stage1(epochs=2)
    recs = [json.loads(line) for line in open(tmp_path / "one" / "train.jsonl")]
    iou = [r["eval/iou"] for r in recs if "eval/iou" in r]
    assert len(iou) == 2 and all(0.0 <= v <= 1.0 for v in iou), recs
    assert not [r for r in recs if "s1/eval_hook_failures" in r]
    _trainer(tmp_path / "two").train_stage1(epochs=1, eval_hook=skip)
    resumed = _trainer(tmp_path / "two").train_stage1(epochs=1, eval_hook=skip, resume=True)
    _assert_same(_arrays(s1), _arrays(resumed))

    s2 = one.train_stage2(epochs=2)
    assert one.pipe.vae.quant_conv_xy.weight.requires_grad is False
    files = sorted(os.listdir(tmp_path / "one" / "samples"))
    assert files == ["ep0.off", "ep1.off"], files
    recs = [json.loads(line) for line in open(tmp_path / "one" / "train.jsonl")]
    assert not [r for r in recs if "s2/eval_hook_failures" in r]
    half = _trainer(tmp_path / "two")
    half.train_stage2(epochs=1, eval_hook=skip)
    again = _trainer(tmp_path / "two").train_stage2(epochs=1, eval_hook=skip, resume=True)
    _assert_same(_arrays(s2), _arrays(again))


def test_occupancy_stage2_eval_hook_writes_a_readable_mesh(tmp_path):
    """default_stage2_eval_hook's occupancy branch: one EMA latent (NFE 4
    here), a 32^3 grid with no MISE refinement, written as ep<epoch>.off;
    the INR3D's output bias is set so the sampled field crosses the
    threshold, and the file parses to that many vertices and triangles with
    indices in range."""
    from ddmi_tpu_torch.core.trainer import default_stage2_eval_hook, ema_weights
    from ddmi_tpu_torch.geometry.generation import logit_threshold

    trainer = _trainer(tmp_path)
    pipe = trainer.pipe
    state = pipe.init_stage2()
    with ema_weights(pipe, state), torch.no_grad():
        g = torch.Generator().manual_seed(trainer.cfg.seed + 100 + 2)
        z = pipe.sample_latents(1, generator=g)
        grid = torch.rand(1, 4096, 3, generator=torch.Generator().manual_seed(0)) - 0.5
        logits = pipe.decode_logits_fn(z)(grid)
        pipe.mlp.net_out.bias += logit_threshold(0.2) - logits.median()
    default_stage2_eval_hook(trainer, state, 2)
    with open(tmp_path / "samples" / "ep2.off") as f:
        lines = f.read().split("\n")
    assert lines[0] == "OFF"
    nv, nf, _ = map(int, lines[1].split())
    verts = np.array([list(map(float, ln.split())) for ln in lines[2 : 2 + nv]])
    faces = np.array([list(map(int, ln.split())) for ln in lines[2 + nv : 2 + nv + nf]])
    assert nv > 0 and nf > 0 and verts.shape == (nv, 3) and np.isfinite(verts).all()
    assert (faces[:, 0] == 3).all() and faces[:, 1:].min() >= 0 and faces[:, 1:].max() < nv


def _shapenet_tree(root):
    from ddmi_tpu.data.binvox import BinvoxModel, write_voxels

    rng = np.random.default_rng(0)
    for c, models in (("cat_a", ["m0", "m1", "m2"]), ("cat_b", ["n0", "n1"])):
        for m in models:
            d = root / c / m
            d.mkdir(parents=True)
            pts = rng.uniform(-0.5, 0.5, (120, 3)).astype(np.float16 if c == "cat_a"
                                                           else np.float32)
            np.savez(d / "points.npz", points=pts,
                     occupancies=np.packbits(rng.random(120) < 0.3))
            np.savez(d / "pointcloud.npz", points=rng.normal(size=(90, 3)).astype(np.float32))
            write_voxels(str(d / "model.binvox"), BinvoxModel(rng.random((8, 8, 8)) < 0.4))
    (root / "cat_a" / "train.lst").write_text("m0\nm2\nm1\n")


def test_shapenet_loaders_are_bit_identical_to_jax(tmp_path):
    """ShapeNetOccupancyDataset (a .lst category with float16 points and one
    without, packed occupancies, voxels through read_voxels) over two
    epochs, SyntheticOccupancy, and read_voxels itself: the same arrays as
    the JAX package's, bit for bit."""
    from ddmi_tpu.data.binvox import read_voxels as jax_read
    from ddmi_tpu.data.shapenet import ShapeNetOccupancyDataset as JaxSet
    from ddmi_tpu.data.shapenet import SyntheticOccupancy as JaxSynth
    from ddmi_tpu_torch.data import ShapeNetOccupancyDataset, SyntheticOccupancy, read_voxels

    _shapenet_tree(tmp_path)
    kw = dict(points_subsample=64, pointcloud_n=50, seed=4, voxels_file="model.binvox")
    ours, ref = ShapeNetOccupancyDataset(str(tmp_path), 2, **kw), JaxSet(str(tmp_path), 2, **kw)
    assert len(ours) == len(ref) == 2 and ours.models == ref.models
    pairs = [(a, b) for _ in range(2) for a, b in zip(ours, ref)]
    pairs += list(zip(SyntheticOccupancy(3, 40, 30, length=2, seed=2),
                      JaxSynth(3, 40, 30, length=2, seed=2)))
    assert len(pairs) == 6
    for a, b in pairs:
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    path = str(tmp_path / "cat_b" / "n0" / "model.binvox")
    assert np.array_equal(read_voxels(path).data, jax_read(path).data)


@pytest.mark.parametrize("dim", [3, 6])
def test_pointnet_gradients_match_jax(dim):
    """LocalPoolPointnet's gradients with respect to its parameters and the
    points against jax.grad, on a cloud of dim values per point (6: xyz and
    rgb, as srn_cars) where every point appears twice (so the max pool
    ties) and most cells of the 8^2 planes are empty: within 1e-4 x
    max|ref| per tensor."""
    from ddmi_tpu.nn.pointnet import LocalPoolPointnet as JaxPN
    from ddmi_tpu_torch.nn.pointnet import LocalPoolPointnet

    rng = np.random.default_rng(dim)
    half = rng.uniform(-0.5, 0.5, (2, 12, dim)).astype(np.float32)
    p = np.concatenate([half, half[:, ::-1]], axis=1)
    w = {k: rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for k in ("xz", "xy", "yz")}
    jpn = JaxPN(c_dim=4, hidden_dim=16, plane_resolution=8, n_blocks=3)
    params = random_params(lambda: jpn.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, dim))), dim)

    def loss(params, p):
        fea = jpn.apply({"params": params}, p)
        return sum(jnp.sum(fea[k] * w[k]) for k in w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(p))
    pn = LocalPoolPointnet(c_dim=4, hidden_dim=16, plane_resolution=8, n_blocks=3, dim=dim)
    pn.load_state_dict(pointnet_from_jax(jax.tree_util.tree_map(np.asarray, params), 3))
    assert pn.fc_pos.weight.shape == (32, dim)
    x = torch.from_numpy(p).requires_grad_(True)
    fea = pn(x)
    sum((fea[k] * nchw(w[k])).sum() for k in w).backward()
    ref = pointnet_from_jax(jax.tree_util.tree_map(np.asarray, gp), 3)
    for k, prm in pn.named_parameters():
        r = ref[k].numpy()
        assert np.abs(prm.grad.numpy() - r).max() <= 1e-4 * np.abs(r).max(), k
    gx = np.asarray(gx)
    assert np.abs(x.grad.numpy() - gx).max() <= 1e-4 * np.abs(gx).max()


class _Log:
    def __init__(self):
        self.recs = []

    def log(self, step, metrics, prefix=""):
        self.recs.append({prefix + k: v for k, v in metrics.items()})


def test_occupancy_stage1_eval_hook_iou_matches_jax(tmp_path):
    """default_stage1_eval_hook's occupancy branch against the JAX
    trainer's on the same weights, test batch and eps (JAX's from key 0):
    the same IoU of logits > 0 against occ > 0.5 on the first shape, and
    neither counts a failure."""
    from ddmi_tpu.core.trainer import default_stage1_eval_hook as jax_hook
    from ddmi_tpu_torch.core.trainer import default_stage1_eval_hook

    s = Setup()
    batch = occ_batch(9)
    jt = types.SimpleNamespace(cfg=s.jcfg, pipe=s.jpipe, test_data=[batch], data=None,
                               logger=_Log(), save_dir=str(tmp_path))
    State = collections.namedtuple("State", "params step")
    jax_hook(jt, State(s.params, jnp.int32(0)), 0)
    eps = jax_eps(jax.random.PRNGKey(0), 1, 8, 8)
    s.pipe.posterior_eps = lambda b, g=None: eps
    try:
        pt = types.SimpleNamespace(cfg=s.cfg, pipe=s.pipe, test_data=[batch], data=None,
                                   logger=_Log(), save_dir=str(tmp_path))
        default_stage1_eval_hook(pt, types.SimpleNamespace(step=0), 0)
    finally:
        del s.pipe.posterior_eps
    assert jt.logger.recs and pt.logger.recs == jt.logger.recs, (pt.logger.recs, jt.logger.recs)
    assert 0.0 < pt.logger.recs[0]["eval/iou"] < 1.0
