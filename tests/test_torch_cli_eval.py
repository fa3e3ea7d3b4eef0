"""The PyTorch port's Trainer.evaluate against the JAX trainer's, on the CPU,
on weights carried across by ddmi_tpu_torch/interop.py: the stage-1
(d2c-vae) protocols of the image domain (rFID through InceptionV3, read by
both sides from the same `data.extra.inception_pth` file in the JAX
package's .npz format) and of the occupancy domain (the IoU of the query
points, and the voxel IoU of binvox grids), on the same test batches and
the same draws: the port is fed JAX's posterior eps (from JAX's keys), and
the INR's noise gains are zero on both sides (JAX draws that noise from
jax.random, the port from the render kernel's Philox stream).

Tolerances: the rFID within 1e-3 relative.  Its features agree to about
1e-6 (tests/test_torch_metric_nets.py) and the reconstructions to 1e-4
(tests/test_torch_stage1_train.py), but 4 samples span 3 of the 2048
feature dimensions, so both covariances are singular and the square root
of their product amplifies those differences.  The IoUs exactly: the
logits agree to 1e-5 and no query point lies that near the threshold.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config
from ddmi_tpu_torch.core.checkpoint import CheckpointManager
from ddmi_tpu_torch.core.config import config_from_dict

torch.set_num_threads(4)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def _fill(shapes, seed):
    """Seeded random leaves of the given shapes: kernels N(0, 1 / fan_in),
    norm scales 1 + N(0, 0.05^2), the rest N(0, 0.05^2); the INR's noise
    gains zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [str(getattr(p, "key", p)) for p in path]
        x = rng.standard_normal(s.shape).astype(np.float32)
        if "noise" in keys:
            return np.zeros(s.shape, np.float32)
        if keys[-1] == "kernel":
            return x / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))
        return (1.0 if keys[-1] == "scale" else 0.0) + 0.05 * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _save_stage1(pipe, save_dir):
    """A stage-1 checkpoint of the pipeline's stage-1 modules, in the
    trainer's layout (what Trainer.load_stage1 reads)."""
    params = {k: v.detach().clone() for k, v in pipe.stage1_params().items()}
    CheckpointManager(save_dir, prefix="stage1").save(1, {"state": {"params": params}})


@pytest.fixture(scope="module")
def inception_pth(tmp_path_factory):
    """A random InceptionV3 (the port's He-normal draws, BatchNorm
    statistics randomised) saved as the JAX package reads
    data.extra.inception_pth: an .npz whose "params" holds the flax tree."""
    from ddmi_tpu.evals.inception import load_torch_inception
    from ddmi_tpu_torch.evals.inception import InceptionV3

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        net = InceptionV3()
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.05, generator=g)
                m.running_var.uniform_(0.8, 1.2, generator=g)
    path = str(tmp_path_factory.mktemp("weights") / "inception.npz")
    np.savez(path, params=load_torch_inception(net.state_dict()))
    return path, net.state_dict()


def test_metric_weights_load_from_the_jax_npz(tmp_path, inception_pth):
    """Trainer._image_scorer reads data.extra.inception_pth (the JAX
    package's .npz) through interop.inception_from_jax: the port's network
    holds the saved weights bit for bit; without the file it warns."""
    from ddmi_tpu_torch.core.trainer import Trainer

    path, sd = inception_pth
    pipe = types.SimpleNamespace(device=torch.device("cpu"))
    cfg = config_from_dict({"data": {"save_pth": str(tmp_path), "extra": {
        "inception_pth": path}}})
    got = Trainer(cfg, pipe, [])._image_scorer().model.state_dict()
    assert sorted(got) == sorted(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    cfg = config_from_dict({"data": {"save_pth": str(tmp_path)}})
    with pytest.warns(UserWarning, match="random-init network"):
        Trainer(cfg, pipe, [])._image_scorer()


def _jax_rfid(d, params, save_dir):
    """The JAX trainer's evaluate('d2c-vae') rFID on config dict d with the
    stage-1 `params`, in a process of its own: it runs beside the port's,
    and each ends in a 2048 x 2048 matrix square root on the host, which
    holds the interpreter.  The suite's JAX settings (tests/conftest.py)
    are applied first, as in the test's own process."""
    import conftest  # noqa: F401

    from ddmi_tpu.core.trainer import Trainer as JaxTrainer
    from ddmi_tpu.data.synthetic import SyntheticImages as JaxImages
    from ddmi_tpu.domains.image import ImagePipeline as JaxPipe

    jcfg = jax_config(d)
    jt = JaxTrainer(jcfg, JaxPipe(jcfg), JaxImages(2, 32, length=4), save_dir=save_dir)
    jt.load_stage1 = lambda: types.SimpleNamespace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    return float(jt.evaluate("d2c-vae")["rfid"])


def test_evaluate_rfid_matches_jax(tmp_path, inception_pth):
    """evaluate('d2c-vae') on the tiny image config of tests/test_cli_smoke.py:
    the same rFID as the JAX trainer's over 2 test batches of 2 (its
    reconstructions at the anchor, JAX's eps from key 0), both reading the
    same InceptionV3 file; both print the protocol and truncation lines
    and write eval.json.  JAX's evaluation runs in a spawned process beside
    the port's (`_jax_rfid`)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from ddmi_tpu.domains.image import ImagePipeline as JaxPipe
    from test_torch_cli import _base_cfg

    d = _base_cfg(str(tmp_path / "port"))
    d["data"]["extra"] = {"inception_pth": inception_pth[0], "eval_samples": 16}
    jcfg, cfg = jax_config(d), config_from_dict(d)
    key = jax.random.PRNGKey(0)
    params = _fill(jax.eval_shape(lambda: JaxPipe(jcfg).init_stage1(key, 4)).params, 1)
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        ref_future = pool.submit(_jax_rfid, d, params, str(tmp_path / "jax"))
        got = _port_rfid(cfg, params, key, tmp_path)
        ref = ref_future.result(timeout=600)
    finally:
        pool.shutdown()
    assert np.isfinite(ref) and ref > 0
    assert abs(got - ref) <= 1e-3 * ref, (got, ref)
    assert os.path.exists(tmp_path / "port" / "eval.json")
    assert os.path.exists(tmp_path / "jax" / "eval.json")


def _port_rfid(cfg, params, key, tmp_path):
    """The port's evaluate('d2c-vae') rFID on the same weights and eps."""
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.data.synthetic import SyntheticImages
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.interop import mlp_image_from_jax, vae_from_jax

    pipe = ImagePipeline(cfg, device="cpu", seed=0)
    pipe.load_state_dicts(vae=vae_from_jax(params["vae"], cfg.model.ddconfig),
                          mlp=mlp_image_from_jax(params["mlp"], cfg.model.mlpconfig))
    _save_stage1(pipe, str(tmp_path / "port"))
    pipe.load_state_dicts(vae=ImagePipeline(cfg, device="cpu", seed=1).vae.state_dict())
    recon = pipe.reconstruct
    rng_post = jax.random.split(key)[0]
    pipe.reconstruct = lambda x, generator=None: recon(
        x, eps=_nchw(jax.random.normal(rng_post, (x.shape[0], 8, 8, 8), jnp.float32)))
    return Trainer(cfg, pipe, SyntheticImages(2, 32, length=4)).evaluate("d2c-vae")["rfid"]


def test_evaluate_occupancy_iou_matches_jax(tmp_path):
    """evaluate('d2c-vae') on the occupancy tests' tiny config
    (tests/test_torch_occupancy_train.py's weights): the same IoU of the
    query points over 2 test batches (each batch's eps from JAX's key of
    its index) and the same voxel IoU of each shape's 8^3 binvox grid
    (eps from key 0, the points in padded chunks); then
    load_stage1_params restores the checkpoint's weights into zeroed
    modules."""
    from ddmi_tpu.core.trainer import Trainer as JaxTrainer
    from ddmi_tpu_torch.core.trainer import Trainer
    from test_torch_occupancy_train import Setup, jax_eps, occ_batch

    s = Setup()
    rng = np.random.default_rng(13)
    batches = [dict(occ_batch(20 + i), voxels=(rng.random((2, 8, 8, 8)) < 0.3).astype(
        np.float32)) for i in range(3)]
    extra = {"eval_samples": 4}
    jcfg = s.jcfg.__class__(**{**s.jcfg.__dict__, "data": s.jcfg.data.__class__(
        **{**s.jcfg.data.__dict__, "extra": extra})})
    jt = JaxTrainer(jcfg, s.jpipe, batches, save_dir=str(tmp_path / "jax"))
    jt.load_stage1 = lambda: types.SimpleNamespace(params=s.params)
    ref = jt.evaluate("d2c-vae")

    import dataclasses

    cfg = dataclasses.replace(s.cfg, data=dataclasses.replace(
        s.cfg.data, extra=extra, save_pth=str(tmp_path / "port")))
    _save_stage1(s.pipe, str(tmp_path / "port"))
    s.pipe.posterior_eps = lambda b, g=None: jax_eps(
        jax.random.PRNGKey(g.initial_seed()), b, 8, 8)
    try:
        got = Trainer(cfg, s.pipe, batches).evaluate("d2c-vae")
    finally:
        del s.pipe.posterior_eps
    assert sorted(got) == sorted(ref) == ["iou", "iou_voxels"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])
    assert 0.0 < ref["iou"] < 1.0 and 0.0 < ref["iou_voxels"] < 1.0
    # load_stage1_params: the checkpoint's stage-1 weights, in the pipeline
    saved = s.port_names(s.params)
    with torch.no_grad():
        for p in s.pipe.stage1_params().values():
            p.zero_()
    params = Trainer(cfg, s.pipe, batches).load_stage1_params()
    assert sorted(params) == sorted(saved)
    assert all(np.array_equal(params[k].detach().numpy(), saved[k]) for k in saved)
