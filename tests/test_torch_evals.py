"""The PyTorch port's eval drivers and 3D metrics against the JAX package's,
on the CPU: FID's statistics, Fréchet distance and drivers (test_rfid,
test_fid_n) with their printed protocol lines, FVD's preprocessing and
PSNR, the Chamfer matrix, MMD / COV / 1-NNA, the mesh evaluator and the
voxel IoU, the quality gates case for case with tests/test_gates.py, and
the geometry bindings (kd-tree, point-in-mesh, voxelisation).

The drivers are fed the same fixed arrays on both sides through stub
scorers (a fixed linear feature map), so that every number is the same
numpy computation; the metric networks themselves are held to JAX in
tests/test_torch_metric_nets.py.  Tolerances: statistics and distances
within 1e-6 relative (the same numpy and scipy calls); the Chamfer matrix
and MMD within 1e-5 relative (fp32 reductions in other orders), COV and
1-NNA exact; the mesh metrics, the voxel IoU and the geometry bindings
exact (the same C++ core and numpy draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(4)


class _StubScorer:
    """A fixed linear feature map of the flattened images (numpy or
    torch)."""

    def __init__(self, d_in, d_out=16, seed=0):
        self.W = np.random.default_rng(seed).standard_normal((d_in, d_out))

    def features(self, images):
        out = [np.asarray(b).reshape(len(b), -1) @ self.W for b in images]
        return np.concatenate(out, axis=0)

    embeddings = features

    def fvd(self, real, fake):
        from ddmi_tpu_torch.evals.fid import activation_statistics, frechet_distance

        a, b = self.features(real), self.features(fake)
        return frechet_distance(*activation_statistics(a), *activation_statistics(b))


@pytest.mark.parametrize("n,d", [(300, 32), (20, 48)])
def test_statistics_and_frechet_distance_match_jax(n, d):
    """activation_statistics and frechet_distance against JAX's on the same
    features, within 1e-6 relative: a well-posed case, and fewer samples
    than dimensions (singular covariances, a complex square root whose
    small imaginary part is dropped)."""
    from ddmi_tpu.evals.fid import activation_statistics as jstats, frechet_distance as jfd
    from ddmi_tpu_torch.evals.fid import activation_statistics, frechet_distance

    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, d)).astype(np.float32)
    b = (1.3 * rng.standard_normal((n, d)) + 0.2).astype(np.float32)
    for got, ref in zip(activation_statistics(a), jstats(a)):
        assert np.array_equal(got, ref)
    ref = jfd(*jstats(a), *jstats(b))
    got = frechet_distance(*activation_statistics(a), *activation_statistics(b))
    assert np.isfinite(got) and abs(got - ref) <= 1e-6 * abs(ref), (got, ref)
    assert abs(frechet_distance(*activation_statistics(a), *activation_statistics(a))) < 1e-3


@pytest.mark.parametrize("max_batches", [3, 512])
def test_rfid_matches_jax_with_its_protocol_lines(capsys, max_batches):
    """test_rfid on the same batches and reconstructions: the same rFID
    (1e-6) and the same printed line (the truncation count, or the full
    loader's)."""
    from ddmi_tpu.evals.fid import test_rfid as jax_rfid
    from ddmi_tpu_torch.evals.fid import test_rfid

    rng = np.random.default_rng(1)
    batches = [rng.random((4, 4, 4, 1)) for _ in range(5)]
    recons = {id(b): b + 0.05 * rng.standard_normal(b.shape) for b in batches}
    scorer = _StubScorer(16)
    ref = jax_rfid(scorer, lambda b: recons[id(b)], iter(batches), max_batches=max_batches)
    ref_out = capsys.readouterr().out
    got = test_rfid(scorer, lambda b: torch.from_numpy(recons[id(b)]), iter(batches),
                    max_batches=max_batches)
    assert capsys.readouterr().out == ref_out
    assert abs(got - ref) <= 1e-6 * abs(ref)
    assert ("truncated at max_batches=3" in ref_out) == (max_batches == 3)


@pytest.mark.parametrize("n_samples,protocol_n", [(40, 10000), (16, 16)])
def test_fid_n_matches_jax_with_its_protocol_lines(capsys, n_samples, protocol_n):
    """test_fid_n on the same fixed sample arrays (JAX's sample_fn takes a
    split key, the port's a torch generator; both return the next array):
    the same FID and the same printed progress and protocol lines."""
    from ddmi_tpu.evals.fid import test_fid_n as jax_fid_n
    from ddmi_tpu_torch.evals.fid import test_fid_n

    rng = np.random.default_rng(2)
    samples = [rng.standard_normal((8, 4, 4, 1)) for _ in range(6)]
    reals = [rng.standard_normal((8, 4, 4, 1)) for _ in range(4)]
    scorer = _StubScorer(16)
    it = iter(samples)
    ref = jax_fid_n(scorer, lambda key: next(it), reals, n_samples=n_samples, batch=8,
                    protocol_n=protocol_n)
    ref_out = capsys.readouterr().out
    it = iter(samples)
    gens = []
    got = test_fid_n(scorer, lambda g: gens.append(g) or torch.from_numpy(next(it)), reals,
                     n_samples=n_samples, batch=8, protocol_n=protocol_n)
    assert capsys.readouterr().out == ref_out
    assert abs(got - ref) <= 1e-6 * abs(ref)
    assert len(set(map(id, gens))) == 1 and isinstance(gens[0], torch.Generator)
    assert ("PROTOCOL IS 10000" in ref_out) == (protocol_n == 10000)


def test_fvd_preprocess_psnr_and_drivers_match_jax():
    """FVD's preprocess_video (resize to 224^2, to [-1, 1]) against JAX's
    within 1e-5; psnr over the same batches and reconstructions; test_rfvd
    and test_fvd_sample on a stub scorer: the same numbers."""
    from ddmi_tpu.evals import fvd as jfvd
    from ddmi_tpu_torch.evals import fvd

    rng = np.random.default_rng(3)
    v = rng.random((1, 3, 256, 200, 3)).astype(np.float32)
    ref = np.asarray(jfvd.preprocess_video(jnp.asarray(v)))
    got = fvd.preprocess_video(torch.from_numpy(v)).numpy()
    assert got.shape == ref.shape == (1, 3, 224, 224, 3)
    assert np.abs(got - ref).max() <= 1e-5
    batches = [rng.random((2, 3, 8, 8, 3)).astype(np.float32) for _ in range(3)]
    recon = lambda b: np.clip(b + 0.02 * np.sin(b * 40), 0, 1)
    assert fvd.psnr(lambda b: torch.from_numpy(recon(b)), batches, max_batches=2) == \
        pytest.approx(jfvd.psnr(recon, batches, max_batches=2), rel=1e-6)
    scorer = _StubScorer(3 * 8 * 8 * 3)
    assert fvd.test_rfvd(scorer, recon, batches) == pytest.approx(
        jfvd.test_rfvd(scorer, recon, batches), rel=1e-6)
    fakes = [rng.random((2, 3, 8, 8, 3)) for _ in range(3)]
    it = iter(fakes)
    ref = jfvd.test_fvd_sample(scorer, lambda key: next(it), batches, n_samples=5)
    it = iter(fakes)
    assert fvd.test_fvd_sample(scorer, lambda g: next(it), batches, n_samples=5) == \
        pytest.approx(ref, rel=1e-6)


def _clouds(seed, n, p=96):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 1.5, (n, 1, 3))
    return (rng.standard_normal((n, p, 3)) * scale).astype(np.float32)


def test_chamfer_matrix_and_mmd_cov_1nna_match_jax():
    """chamfer_matrix (tiled over reference rows) within 1e-5 relative of
    JAX's; mmd_cov_1nna on seeded clouds: MMD within 1e-5 relative, COV
    and 1-NNA exact."""
    from ddmi_tpu.evals import metrics_3d as jm
    from ddmi_tpu_torch.evals import metrics_3d as m

    ref, gen = _clouds(4, 7), _clouds(5, 6)
    d_ref = np.asarray(jm.chamfer_matrix(ref, gen, tile=3))
    d = m.chamfer_matrix(ref, gen, tile=3, device="cpu")
    assert d.shape == d_ref.shape == (7, 6)
    assert np.abs(d - d_ref).max() <= 1e-5 * np.abs(d_ref).max()
    r, g = jm.mmd_cov_1nna(ref, gen), m.mmd_cov_1nna(ref, gen, device="cpu")
    assert sorted(g) == sorted(r) == ["1nna", "cov", "mmd"]
    assert abs(g["mmd"] - r["mmd"]) <= 1e-5 * r["mmd"]
    assert g["cov"] == r["cov"] and g["1nna"] == r["1nna"]
    assert np.array_equal(m.normalize_unit_sphere(ref), jm.normalize_unit_sphere(ref))


def _sphere_mesh(radius=0.3, n=24):
    from ddmi_tpu_torch.geometry import marching_cubes

    lin = np.linspace(-0.5, 0.5, n)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    verts, tris = marching_cubes(radius - np.sqrt(x**2 + y**2 + z**2), 0.0)
    return verts / (n - 1) - 0.5, tris


def test_eval_mesh_and_voxel_iou_match_jax():
    """eval_mesh (Chamfer-L1 / L2, F-score, IoU through the kd-tree and the
    inside test) and voxel_iou (a fixed logits function at the cell
    centres, in padded chunks) against JAX's: the same numbers."""
    from ddmi_tpu.evals import metrics_3d as jm
    from ddmi_tpu_torch.evals import metrics_3d as m

    verts, tris = _sphere_mesh()
    rng = np.random.default_rng(6)
    gt = rng.standard_normal((500, 3))
    gt = 0.3 * gt / np.linalg.norm(gt, axis=1, keepdims=True)
    pts = rng.uniform(-0.5, 0.5, (800, 3))
    occ = (np.linalg.norm(pts, axis=1) < 0.32).astype(np.float32)
    ref = jm.eval_mesh(verts, tris, gt, pts, occ, n_surface=2000)
    assert m.eval_mesh(verts, tris, gt, pts, occ, n_surface=2000) == ref
    assert 0.5 < ref["iou"] < 1.0 and ref["fscore"] > 0
    empty = m.eval_mesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64), gt, pts, occ)
    assert empty == jm.eval_mesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64), gt, pts, occ)
    vox = rng.random((10, 12, 9)) < 0.3
    fn = lambda p: 4.0 * (0.3 - np.linalg.norm(np.asarray(p), axis=-1))
    ref = jm.voxel_iou(fn, vox, chunk=256)
    assert m.voxel_iou(lambda p: torch.from_numpy(fn(p)), vox, chunk=256) == ref
    assert 0.0 < ref < 1.0


_GATE_CASES = [  # (results, gates): tests/test_gates.py's, case for case
    ({"fid": 7.30}, {"fid": {"published": 7.25, "tol_pct": 2.0}}),
    ({"fid": 7.45}, {"fid": {"published": 7.25, "tol_pct": 2.0}}),
    ({"fid": 5.0}, {"fid": {"published": 7.25}}),
    ({"cov": 0.544}, {"cov": {"published": 0.55, "tol_pct": 2.0}}),
    ({"cov": 0.50}, {"cov": {"published": 0.55, "tol_pct": 2.0}}),
    ({"psnr": 10.0}, {"psnr": {"published": 9.0, "direction": "min"}}),
    ({"mmd": 1.01}, {"mmd": 1.0}),
    ({"mmd": 1.03}, {"mmd": 1.0}),
    ({"fid": 1.0}, {"fid": {"published": None}}),
    ({"fid": 1.0}, {"fvd": {"published": 100.0}}),
    ({"fid": 1.0}, {"fid": {"published": 2.0, "direction": "lower"}}),
    ({"mmd": 0.9, "cov": 0.6}, {"mmd": {"published": 1.0}, "cov": {"published": 0.55}}),
    ({"mmd": 0.9, "cov": 0.1}, {"mmd": {"published": 1.0}, "cov": {"published": 0.55}}),
]


@pytest.mark.parametrize("results,gates", _GATE_CASES)
def test_check_gates_matches_jax(results, gates):
    """check_gates: the same verdict and detail as JAX's, or the same
    ValueError (a missing published value, a bad direction)."""
    from ddmi_tpu.evals.gates import check_gates as jax_gates
    from ddmi_tpu_torch.evals.gates import check_gates

    try:
        ref = jax_gates(results, gates)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            check_gates(results, gates)
        assert str(got.value) == str(e)
        return
    assert check_gates(results, gates) == ref


def test_geometry_bindings_match_jax():
    """KDTree, check_mesh_contains and voxelize_mesh of the port's geometry
    library against ddmi_tpu.geometry's: the same distances, indices,
    inside tests and voxels."""
    from ddmi_tpu import geometry as jg
    from ddmi_tpu_torch import geometry as g

    rng = np.random.default_rng(7)
    p, q = rng.random((700, 3)), rng.random((300, 3))
    (dist, idx), (jd, ji) = g.KDTree(p).query(q), jg.KDTree(p).query(q)
    assert np.array_equal(dist, jd) and np.array_equal(idx, ji)
    brute = np.sqrt(((q[:, None] - p[None]) ** 2).sum(-1))
    assert np.allclose(dist, brute.min(1)) and np.array_equal(idx, brute.argmin(1))
    verts, tris = _sphere_mesh()
    pts = rng.uniform(-0.5, 0.5, (2000, 3))
    inside = g.check_mesh_contains(verts, tris, pts)
    assert np.array_equal(inside, jg.check_mesh_contains(verts, tris, pts))
    assert np.array_equal(inside, np.linalg.norm(pts, axis=1) < 0.3) or \
        (inside != (np.linalg.norm(pts, axis=1) < 0.3)).mean() < 0.01
    vox = g.voxelize_mesh(verts + 0.5, tris, 16)
    assert vox.shape == (16, 16, 16) and vox.dtype == bool
    assert np.array_equal(vox, jg.voxelize_mesh(verts + 0.5, tris, 16)) and vox.any()
