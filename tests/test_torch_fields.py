"""The port's ONet field API (ddmi_tpu_torch/data/fields.py) against the
JAX package's, on the same synthetic model directory and the same seeds:
every field and transform gives the same arrays, bit for bit, and draws
the same numbers from its np.random.Generator (checked by the generator's
next draw after the load).  Also the subprocess check that the new
ConvONet modules load neither jax nor the JAX package.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ddmi_tpu.data import fields as jf
from ddmi_tpu_torch.data import fields as tf
from ddmi_tpu_torch.data.binvox import BinvoxModel, write_voxels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def model_dir(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32)
    occ = (np.linalg.norm(pts, axis=-1) < 0.3).astype(np.float32)
    np.savez(tmp_path / "points.npz", points=pts, occupancies=occ)
    np.savez(tmp_path / "points_packed.npz", points=pts.astype(np.float16),
             occupancies=np.packbits(occ.astype(bool)))
    os.makedirs(tmp_path / "points_multi")
    for i in range(3):
        np.savez(tmp_path / "points_multi" / f"points_multi_{i:02d}.npz",
                 points=pts + i, occupancies=occ)
    pc = rng.uniform(-0.5, 0.5, (400, 3)).astype(np.float32)
    nrm = rng.standard_normal((400, 3)).astype(np.float32)
    np.savez(tmp_path / "pointcloud.npz", points=pc, normals=nrm)
    vox = np.zeros((8, 8, 8), bool)
    vox[2:6, 2:6, 3:7] = True
    vox[1, 0, 5] = True
    with open(tmp_path / "model.binvox", "wb") as f:
        write_voxels(f, BinvoxModel(vox))
    return str(tmp_path)


def _same(a, b, what=""):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _both(make, load_args, seed):
    """The load of the field `make(module)` in both packages, each from a
    generator seeded `seed`, and the generators' next draws."""
    out = []
    for mod in (jf, tf):
        rng = np.random.default_rng(seed)
        data = make(mod).load(*load_args, rng=rng)
        out.append((data, rng.standard_normal()))
    return out


@pytest.mark.parametrize("name", ["points", "packed_f16", "multi", "subsample_int",
                                  "subsample_stratified"])
def test_points_fields_match_jax(model_dir, name):
    makes = {
        "points": lambda m: m.PointsField("points.npz"),
        "packed_f16": lambda m: m.PointsField("points_packed.npz", unpackbits=True),
        "multi": lambda m: m.PointsField("points_multi", multi_files=3),
        "subsample_int": lambda m: m.PointsField("points.npz", transform=m.SubsamplePoints(64)),
        "subsample_stratified": lambda m: m.PointsField(
            "points.npz", transform=m.SubsamplePoints((40, 24))),
    }
    (a, na), (b, nb) = _both(makes[name], (model_dir, 0, 0), seed=3)
    _same(a, b, name)
    assert na == nb


def test_pointcloud_fields_and_transforms_match_jax(model_dir):
    make = lambda m: m.PointCloudField("pointcloud.npz", transform=m.compose(
        m.SubsamplePointcloud(100), m.PointcloudNoise(0.005)))
    (a, na), (b, nb) = _both(make, (model_dir, 0, 0), seed=5)
    _same(a, b, "pointcloud")
    assert na == nb
    make = lambda m: m.PartialPointCloudField("pointcloud.npz", part_ratio=0.5)
    (a, na), (b, nb) = _both(make, (model_dir, 0, 0), seed=6)
    _same(a, b, "partial")
    assert na == nb
    assert tf.PointCloudField("pointcloud.npz").check_complete(["pointcloud.npz"])
    assert tf.IndexField().load("/nowhere", 7, 0) == 7


def test_voxels_and_patch_fields_match_jax(model_dir):
    (a, _), (b, _) = _both(lambda m: m.VoxelsField("model.binvox"), (model_dir, 0, 0), seed=0)
    _same(a, b, "voxels")
    assert a.shape == (8, 8, 8) and a.dtype == np.float32
    vol = {"query_vol": (np.array([-0.25] * 3), np.array([0.25] * 3)),
           "input_vol": (np.array([-0.3] * 3), np.array([0.3] * 3)),
           "plane_type": ["xz", "xy", "yz", "grid"], "reso": 8}
    make = lambda m: m.PatchPointsField("points.npz", transform=m.SubsamplePoints(32))
    (a, na), (b, nb) = _both(make, (model_dir, 0, vol), seed=7)
    _same(a, b, "patch points")
    assert na == nb
    make = lambda m: m.PatchPointCloudField("pointcloud.npz", transform=m.PointcloudNoise(0.01))
    (a, na), (b, nb) = _both(make, (model_dir, 0, vol), seed=8)
    _same(a, b, "patch pointcloud")
    assert na == nb


def test_normalize_coord_and_coord2index_match_jax():
    rng = np.random.default_rng(9)
    p = rng.uniform(-0.6, 0.6, (300, 3)).astype(np.float32)
    vol = (np.array([-0.5, -0.4, -0.5]), np.array([0.5, 0.45, 0.5]))
    for plane in ("xz", "xy", "yz", "grid"):
        _same(tf.normalize_coord(p, vol, plane), jf.normalize_coord(p, vol, plane), plane)
        _same(tf.coord2index(p, vol, 16, plane), jf.coord2index(p, vol, 16, plane), plane)


def test_convonet_modules_load_neither_jax_nor_the_jax_package():
    """A ConvONet step, an IoU, PointNet++, the fields and the new ops, in
    a fresh interpreter, without loading jax or any ddmi_tpu module."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from ddmi_tpu_torch.data import fields
        from ddmi_tpu_torch.domains.onet import ONetPipeline
        from ddmi_tpu_torch.nn.pointnetpp import PointNetPlusPlus
        from ddmi_tpu_torch.nn.stylegan import EqualConv2d, ModulatedConv, ToRGB
        from ddmi_tpu_torch.ops import fused, grid_sample, resample, upfirdn
        from ddmi_tpu_torch import interop
        pipe = ONetPipeline(c_dim=4, encoder_kwargs=dict(hidden_dim=8, plane_resolution=8,
                            n_blocks=2, unet=True, unet_depth=2, unet_start_filts=4),
                            decoder_kwargs=dict(hidden_size=8, n_blocks=2), device="cpu")
        rng = np.random.default_rng(0)
        batch = {"inputs": rng.uniform(-0.5, 0.5, (2, 64, 3)).astype(np.float32),
                 "points": rng.uniform(-0.5, 0.5, (2, 32, 3)).astype(np.float32),
                 "occ": (rng.uniform(size=(2, 32)) > 0.5).astype(np.float32)}
        state, m = pipe.train_step(pipe.init(), batch)
        assert np.isfinite(m["loss"]) and 0.0 <= pipe.eval_iou(batch) <= 1.0
        xyz, f = PointNetPlusPlus(c_dim=8)(torch.rand(1, 600, 3) - 0.5)
        assert f.shape == (1, 600, 8)
        assert "jax" not in sys.modules, "the port loaded jax"
        assert not [m for m in sys.modules if m.split(".")[0] == "ddmi_tpu"]
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
