"""PointNet++ in the port against the JAX package on the CPU: the
farthest-point sample and the ball query give the same indices exactly
(the JAX package's start at point 0, the nsample lowest in-radius indices
padded with the first), the helpers the same values, and the whole
encoder, on the same weights (interop.pointnetpp_from_jax) and points:
each of its six stages within 1e-5 * max(1, max|ref|) of JAX's on the same
inputs (fp32 both sides), the whole within 1e-4 (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddmi_tpu.nn import pointnetpp as jp
from ddmi_tpu_torch import interop
from ddmi_tpu_torch.nn import pointnetpp as tp

torch.set_num_threads(1)


def _close(got, ref, what="", rel=1e-5):
    got, ref = np.asarray(got.detach(), np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _cloud(seed, b=2, n=600):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)


def test_sampling_and_grouping_indices_match_jax():
    xyz = _cloud(0)
    jxyz, txyz = jnp.asarray(xyz), torch.from_numpy(xyz)
    fps = tp.farthest_point_sample(txyz, 64)
    assert np.array_equal(fps.numpy(), np.asarray(jp.farthest_point_sample(jxyz, 64)))
    assert (fps[:, 0] == 0).all()
    new = tp.index_points(txyz, fps)
    _close(new, jp.index_points(jxyz, jnp.asarray(fps.numpy())), "index_points")
    _close(tp.square_distance(new, txyz),
           jp.square_distance(jnp.asarray(new.numpy()), jxyz), "square_distance")
    for radius, nsample in ((0.2, 32), (0.1, 16), (0.4, 64)):
        got = tp.query_ball_point(radius, nsample, txyz, new)
        ref = jp.query_ball_point(radius, nsample, jxyz, jnp.asarray(new.numpy()))
        assert np.array_equal(got.numpy(), np.asarray(ref)), radius
    # at radius 0.1 some groups are short: padded with their first member
    short = tp.query_ball_point(0.1, 16, txyz, new)
    assert (short == short[..., :1]).sum() > short.shape[0] * short.shape[1]


def test_pointnetpp_matches_jax():
    """Each set abstraction and feature propagation on the same inputs within
    1e-5 * max(1, max|ref|); the whole encoder within 1e-4, where fp32
    rounding through its six batch-statistics stages is the limit: JAX's
    own fp32 run lies 2.5e-5 * max|ref| from a float64 run of the port here,
    and the port's fp32 run lies no farther from it."""
    xyz = _cloud(1)
    jm = jp.PointNetPlusPlus(c_dim=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(xyz))["params"]
    rng = np.random.default_rng(2)

    def leaf(path, s):
        name = str(path[-1].key)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(s.shape[0])
        return (1.0 if name == "scale" else 0.0) + 0.1 * x

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    ref_xyz, ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(xyz))
    sd = interop.pointnetpp_from_jax(params)
    tm = tp.PointNetPlusPlus(c_dim=16)
    tm.load_state_dict(sd)
    t = torch.from_numpy(xyz)
    with torch.no_grad():
        got_xyz, got = tm(t)
        tm64 = tp.PointNetPlusPlus(c_dim=16).double()
        tm64.load_state_dict({k: v.double() for k, v in sd.items()})
        _, f64 = tm64(t.double())
    assert got.shape == (2, 600, 16)
    _close(got_xyz, ref_xyz, "xyz")
    _close(got, ref, "features", rel=1e-4)
    jax_to_64 = float(np.abs(np.asarray(ref, np.float64) - f64.numpy()).max())
    assert float((got.double() - f64).abs().max()) <= max(jax_to_64, 1e-5)

    # stage by stage, on the port's inputs to each
    n = lambda a: jnp.asarray(a.numpy())
    sa = lambda *a, **k: jp.PointNetSetAbstraction(*a, **k).apply
    fp = lambda mlp: jp.PointNetFeaturePropagation(mlp).apply
    with torch.no_grad():
        l1x, l1 = tm.sa1(t, t)
        l2x, l2 = tm.sa2(l1x, l1)
        l3x, l3 = tm.sa3(l2x, l2)
        f3 = tm.fp3(l2x, l3x, l2, l3)
        f2 = tm.fp2(l1x, l2x, l1, f3)
        f1 = tm.fp1(t, l1x, None, f2)
    _close(l1, sa(512, 0.2, 32, (64, 64, 128))({"params": params["sa1"]}, n(t), n(t))[1], "sa1")
    _close(l2, sa(128, 0.4, 64, (128, 128, 256))({"params": params["sa2"]}, n(l1x), n(l1))[1],
           "sa2")
    _close(l3, sa(None, None, None, (256, 512, 1024), group_all=True)(
        {"params": params["sa3"]}, n(l2x), n(l2))[1], "sa3")
    _close(f3, fp((256, 256))({"params": params["fp3"]}, n(l2x), n(l3x), n(l2), n(l3)), "fp3")
    _close(f2, fp((256, 128))({"params": params["fp2"]}, n(l1x), n(l2x), n(l1), n(f3)), "fp2")
    _close(f1, fp((128, 128, 16))({"params": params["fp1"]}, n(t), n(l1x), None, n(f2)), "fp1")
