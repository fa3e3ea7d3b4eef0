"""The ported occupancy slice against the JAX package, on the same weights
(converted by ddmi_tpu_torch/interop.py) and the same numpy inputs: the
coordinate helpers, the triplane lookup, INR3D (fp32, and under bf16
parameters), the pointnet's cell index and pooling, the triplane encoder and
posterior, the decoder's HDBF taps, `OccupancyPipeline.sample_latents` at
NFE 4 and the logits, the port's geometry library (MISE, marching cubes),
the lockstep mesh extractor, mesh refinement, the occupancy
`SamplerService`, and the weight bridge.

Tolerances: the fp32 coordinate helpers max|diff| <= 1e-6 * max(1,
max|ref|), the cell index exact; modules <= 1e-4 * max(1, max|ref|) (fp32
both sides, different sum orders); INR3D on bf16 parameters <= 1e-2 *
max(1, max|ref|) (bf16 roundings of the plane samples and net_res1 in
another order); the slice's latents and logits <= 1e-3 * max(1, max|ref|)
after 4 DDIM steps, as the other slices are held; meshes from one field are
identical (the same C++ on the same float64 grid).
"""

import copy
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.interop import (
    mlp3d_from_jax,
    pointnet_from_jax,
    triplane_vae_from_jax,
    unet_from_jax,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DD = dict(double_z=True, z_channels=32, resolution=32, in_channels=8, out_ch=8, ch=32,
          ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[],
          hdbf_resolutions=[8, 16], inter_attn_resolutions=[32, 16], attn_type="vanilla")
CFG = {
    "model": {
        "use_fp16": False, "embed_dim": 8,
        "pointnet": {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 32, "n_blocks": 3},
        "params": {
            "ddconfig": DD,
            "unetconfig": dict(image_size=8, in_channels=24, model_channels=32,
                               out_channels=24, num_res_blocks=1, attention_resolutions=[2],
                               channel_mult=[1, 2], num_head_channels=16),
            "ddpmconfig": dict(timesteps=20, image_size=8, channels=24,
                               sampling_timesteps=4, mixed_init=-6.0),
            "mlpconfig": dict(in_ch=3, out_ch=1, ch=64, latent_dim=8),
        },
    },
    "data": {"domain": "occupancy"},
}


def _close(got, ref, what="", rel=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _random_params(init_fn, seed):
    """Seeded random parameters of the shapes `init_fn()` would make, without
    running the init (jax.eval_shape): kernels N(0, 1 / fan_in), biases
    N(0, 0.05^2), norm scales 1 + N(0, 0.05^2); every leaf nonzero, so no
    branch is skipped."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))
        return (1.0 if name == "scale" else 0.0) + 0.05 * x

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn)["params"])


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _pyramids(rng, b, res=(8, 16, 32), c=8):
    """Three random (xy, yz, xz) pyramids, NHWC numpy, coarse to fine."""
    return tuple([rng.standard_normal((b, r, r, c)).astype(np.float32) for r in res]
                 for _ in range(3))


def _port_pyramids(pyr, dtype=torch.float32):
    return tuple([_nchw(p).to(dtype) for p in levels] for levels in pyr)


# ------------------------------------------------------- coordinates


def test_normalize_coordinate_matches_jax_at_the_clip_edges():
    from ddmi_tpu.nn.inr import normalize_coordinate as jax_norm
    from ddmi_tpu.nn.inr import sample_plane_coords as jax_coords
    from ddmi_tpu_torch.nn.inr import normalize_coordinate, sample_plane_coords

    rng = np.random.default_rng(0)
    edge = 0.5 * (1 + 0.1 + 10e-6)  # maps to exactly 1 before the clip
    p = np.concatenate([
        rng.uniform(-0.7, 0.7, (200, 3)),
        np.array([[edge, -edge, 0.0], [-edge, edge, edge], [0.55, -0.55, 0.6],
                  [-0.6, 0.6, -0.55], [np.nextafter(edge, 0), 0.0, -edge]]),
    ]).astype(np.float32)
    for plane in ("xz", "xy", "yz"):
        ref = np.asarray(jax_norm(jnp.asarray(p), plane=plane))
        got = normalize_coordinate(torch.from_numpy(p), plane=plane)
        assert got.dtype == torch.float32
        assert float(got.max()) <= 1 - 10e-6 and float(got.min()) >= 0.0
        assert float(got.max()) == np.float32(1 - 10e-6)  # the clip is reached
        _close(got, ref, f"normalize_coordinate {plane}", rel=1e-6)
        _close(sample_plane_coords(torch.from_numpy(p), plane),
               jax_coords(jnp.asarray(p), plane), f"sample_plane_coords {plane}", rel=1e-6)


def test_coordinate2index_matches_jax():
    from ddmi_tpu.nn.inr import normalize_coordinate as jax_norm
    from ddmi_tpu.nn.pointnet import coordinate2index as jax_index
    from ddmi_tpu_torch.nn.inr import normalize_coordinate
    from ddmi_tpu_torch.nn.pointnet import coordinate2index

    rng = np.random.default_rng(1)
    p = rng.uniform(-0.6, 0.6, (2, 500, 3)).astype(np.float32)
    for reso in (8, 32, 64):
        for plane in ("xz", "xy", "yz"):
            ref = np.asarray(jax_index(jax_norm(jnp.asarray(p), plane=plane), reso))
            got = coordinate2index(normalize_coordinate(torch.from_numpy(p), plane=plane), reso)
            assert got.dtype == torch.int64
            assert np.array_equal(got.numpy(), ref), (reso, plane)
            assert int(got.max()) < reso * reso


def test_triplane_pe_add_matches_jax():
    from ddmi_tpu.nn.inr import sample_plane_coords as jax_coords
    from ddmi_tpu.nn.inr import triplane_pe_add as jax_pe
    from ddmi_tpu_torch.nn.inr import sample_plane_coords, triplane_pe_add

    rng = np.random.default_rng(2)
    planes = [rng.standard_normal((2, 16, 16, 5)).astype(np.float32) for _ in range(3)]
    p = rng.uniform(-0.6, 0.6, (2, 300, 3)).astype(np.float32)
    keys = ("xy", "yz", "xz")
    ref = jax_pe([jnp.asarray(a) for a in planes], [jax_coords(jnp.asarray(p), k) for k in keys])
    got = triplane_pe_add([_nchw(a) for a in planes],
                          [sample_plane_coords(torch.from_numpy(p), k) for k in keys])
    assert got.shape == (2, 300, 5)
    _close(got, ref, "triplane_pe_add", rel=1e-5)


# -------------------------------------------------------------- INR3D


def _inr3d(seed=0, ch=64, lat=8):
    from ddmi_tpu.core.config import MLPConfig
    from ddmi_tpu.nn.inr import INR3D as JaxINR3D
    from ddmi_tpu_torch.core.config import MLPConfig as TorchMLP
    from ddmi_tpu_torch.nn.inr import INR3D

    jm = JaxINR3D(MLPConfig(in_ch=3, out_ch=1, ch=ch, latent_dim=lat))
    pyr = _pyramids(np.random.default_rng(seed), 1, c=lat)
    p = _random_params(lambda: jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 3)),
                                       tuple([jnp.asarray(a) for a in lv] for lv in pyr)), seed)
    m = INR3D(TorchMLP(in_ch=3, out_ch=1, ch=ch, latent_dim=lat))
    m.load_state_dict(mlp3d_from_jax(p), strict=True)
    return jm, p, m


def test_inr3d_matches_jax():
    jm, p, m = _inr3d()
    rng = np.random.default_rng(3)
    pyr = _pyramids(rng, 2)
    pts = rng.uniform(-0.55, 0.55, (2, 400, 3)).astype(np.float32)
    ref = jm.apply({"params": p}, jnp.asarray(pts),
                   tuple([jnp.asarray(a) for a in lv] for lv in pyr))
    with torch.no_grad():
        got = m(torch.from_numpy(pts), _port_pyramids(pyr))
    assert got.shape == (2, 400) and got.dtype == torch.float32
    _close(got, ref, "INR3D")


@pytest.mark.parametrize("plane_dtype", ["bfloat16", "float32"])
def test_inr3d_under_bf16_parameters_follows_jax_dtype_flow(plane_dtype):
    """bf16 parameters, fp32 query points: net_p runs on the fp32 points, so
    the logits come back fp32 (JAX's promotion), with the plane samples and
    net_res1 in the planes' dtype."""
    jm, p, m = _inr3d(seed=4)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    m.to(torch.bfloat16)
    rng = np.random.default_rng(5)
    pyr = _pyramids(rng, 2)
    pts = rng.uniform(-0.55, 0.55, (2, 400, 3)).astype(np.float32)
    jdt = jnp.bfloat16 if plane_dtype == "bfloat16" else jnp.float32
    ref = jm.apply({"params": jp}, jnp.asarray(pts),
                   tuple([jnp.asarray(a, jdt) for a in lv] for lv in pyr))
    with torch.no_grad():
        got = m(torch.from_numpy(pts), _port_pyramids(pyr, getattr(torch, plane_dtype)))
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, np.asarray(ref, np.float32), f"INR3D bf16 params, {plane_dtype} planes",
           rel=1e-2)


# ----------------------------------------------------------- pointnet


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_segment_pool_matches_jax_on_empty_cells_and_negative_features(reduce):
    from ddmi_tpu.nn.pointnet import _segment_max, _segment_mean
    from ddmi_tpu_torch.nn.pointnet import segment_pool

    rng = np.random.default_rng(6)
    vals = -np.abs(rng.standard_normal((2, 40, 3))).astype(np.float32) - 0.1
    idx = rng.integers(0, 7, (2, 40))  # cells 7..15 stay empty
    fn = _segment_max if reduce == "max" else _segment_mean
    ref = np.stack([np.asarray(fn(jnp.asarray(vals[b]), jnp.asarray(idx[b]), 16))
                    for b in range(2)])
    got = segment_pool(torch.from_numpy(vals), torch.from_numpy(idx), 16, reduce).numpy()
    assert (got[:, 7:] == 0).all() and (ref[:, :7] < 0).all()  # occupied cells stay negative
    _close(got, ref, f"segment {reduce}", rel=1e-6)


@pytest.mark.parametrize("scatter_type", ["max", "mean"])
def test_pointnet_matches_jax(scatter_type):
    """A clustered cloud (most cells empty), random perturbed weights; the
    planes in the JAX package's {xz, xy, yz} layout."""
    from ddmi_tpu.nn.pointnet import LocalPoolPointnet as JaxPointnet
    from ddmi_tpu_torch.nn.pointnet import LocalPoolPointnet

    rng = np.random.default_rng(7)
    centers = rng.uniform(-0.4, 0.4, (6, 3))
    cloud = (centers[rng.integers(0, 6, (2, 300))]
             + 0.03 * rng.standard_normal((2, 300, 3))).astype(np.float32)
    jm = JaxPointnet(c_dim=8, hidden_dim=32, plane_resolution=16, n_blocks=3,
                     scatter_type=scatter_type)
    p = _random_params(lambda: jm.init(jax.random.PRNGKey(1), jnp.asarray(cloud)), 7)
    ref = jm.apply({"params": p}, jnp.asarray(cloud))
    m = LocalPoolPointnet(c_dim=8, hidden_dim=32, plane_resolution=16, n_blocks=3,
                          scatter_type=scatter_type)
    m.load_state_dict(pointnet_from_jax(p, 3), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(cloud))
    assert set(got) == {"xz", "xy", "yz"}
    for k in ("xz", "xy", "yz"):
        r = np.asarray(ref[k])
        assert (r == 0).all(axis=-1).mean() > 0.5  # most cells are empty
        _close(_nhwc(got[k]), r, f"pointnet {scatter_type} {k}")


def test_pointnet_refuses_the_unported_options(tmp_path):
    import yaml

    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline
    from ddmi_tpu_torch.nn.pointnet import LocalPoolPointnet

    with pytest.raises(NotImplementedError):
        LocalPoolPointnet(unet=True)
    path = tmp_path / "voxel.yaml"
    path.write_text(yaml.safe_dump({"model": {"encoder": "voxel_simple_local"}}))
    cfg = copy.deepcopy(CFG)
    cfg["data"]["conv_config"] = str(path)
    with pytest.raises(NotImplementedError, match="voxel_simple_local"):
        OccupancyPipeline(config_from_dict(cfg), device="cpu")


# ------------------------------------------------------- triplane VAE


@pytest.fixture(scope="module")
def shared():
    """JAX pipeline + params (zero-init leaves perturbed, mixing logit
    random) and the port state_dicts made from them."""
    from ddmi_tpu.domains.occupancy import OccupancyPipeline as JaxPipe

    jcfg = jax_config(CFG)
    pipe = JaxPipe(jcfg)
    k = jax.random.PRNGKey(0)
    planes = tuple(jnp.zeros((1, 32, 32, 8)) for _ in range(3))
    pyr = tuple([jnp.zeros((1, r, r, 8)) for r in (8, 16, 32)] for _ in range(3))
    s1 = {
        "pointnet": _random_params(lambda: pipe.pointnet.init(k, jnp.zeros((1, 64, 3))), 0),
        "vae": _random_params(lambda: pipe.vae.init({"params": k}, planes, k), 1),
        "mlp": _random_params(lambda: pipe.mlp.init(k, jnp.zeros((1, 8, 3)), pyr), 2),
    }
    s2 = {"unet": _random_params(lambda: pipe.unet.init(
              k, jnp.zeros((1, 8, 8, 24)), jnp.zeros((1,), jnp.int32)), 3),
          "mixing_logit": np.random.default_rng(4).standard_normal(
              (1, 1, 1, 24)).astype(np.float32)}
    m = jcfg.model
    sds = {
        "unet": unet_from_jax(s2["unet"], m.unetconfig),
        "pointnet": pointnet_from_jax(s1["pointnet"], 3),
        "vae": triplane_vae_from_jax(s1["vae"], m.ddconfig),
        "mlp": mlp3d_from_jax(s1["mlp"]),
        "mixing_logit": torch.from_numpy(s2["mixing_logit"]),
    }
    return pipe, s1, s2, sds


def _vae(shared):
    """The JAX VAE and params of the slice fixture, and the port's whole
    TriplaneAutoencoder loaded from them."""
    from ddmi_tpu_torch.core.config import DDConfig as TorchDD
    from ddmi_tpu_torch.nn.triplane_vae import TriplaneAutoencoder

    jpipe, s1, _, sds = shared
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in DD.items()}
    ae = TriplaneAutoencoder(TorchDD(**kw), embed_dim=8, with_encoder=True)
    ae.load_state_dict(sds["vae"], strict=True)
    return jpipe.vae, s1["vae"], ae


def test_triplane_encoder_and_posterior_match_jax(shared):
    jae, p, ae = _vae(shared)
    rng = np.random.default_rng(9)
    planes = [rng.standard_normal((2, 32, 32, 8)).astype(np.float32) for _ in range(3)]
    ref = jae.apply({"params": p}, tuple(jnp.asarray(a) for a in planes), method=jae.encode)
    eps = [rng.standard_normal((2, 8, 8, 8)).astype(np.float32) for _ in range(3)]
    with torch.no_grad():
        got = ae.encode(tuple(_nchw(a) for a in planes))
        for name, g, r, e in zip(("xy", "yz", "xz"), got, ref, eps):
            _close(_nhwc(g.mean), r.mean, f"posterior mean {name}")
            _close(_nhwc(g.logvar), r.logvar, f"posterior logvar {name}")
            want = np.asarray(r.mean) + np.exp(0.5 * np.asarray(r.logvar)) * e
            _close(_nhwc(g.sample(_nchw(e))), want, f"posterior sample {name}")


def test_triplane_decoder_hdbf_taps_match_jax(shared):
    jae, p, ae = _vae(shared)
    z = np.random.default_rng(11).standard_normal((2, 8, 8, 24)).astype(np.float32)
    ref = jae.apply({"params": p}, jnp.asarray(z), method=jae.decode)
    with torch.no_grad():
        got = ae.decode(_nchw(z))
    for name, g_pyr, r_pyr in zip(("xy", "yz", "xz"), got, ref):
        assert [g.shape[-1] for g in g_pyr] == [8, 16, 32]
        for g, r in zip(g_pyr, r_pyr):
            _close(_nhwc(g), r, f"pyramid {name}")


# ---------------------------------------------------------- the slice


def _port_pipe(sds):
    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline

    pipe = OccupancyPipeline(config_from_dict(CFG), device="cpu")
    pipe.load_state_dicts(**sds)
    return pipe


def test_sample_latents_and_logits_match_jax(shared):
    """DDIM at NFE 4 from the same noise, the decoded pyramids and the
    logits at query points, within 1e-3 * max(1, max|ref|)."""
    jpipe, s1, s2, sds = shared
    rng = np.random.default_rng(12)
    noise = rng.standard_normal((2, 8, 8, 24)).astype(np.float32)
    z_ref = jpipe.sample_latents(s2, jax.random.PRNGKey(0), 2, noise=jnp.asarray(noise))
    pipe = _port_pipe(sds)
    z = pipe.sample_latents(2, noise=_nchw(noise))
    assert z.shape == (2, 24, 8, 8) and z.dtype == torch.float32
    _close(_nhwc(z), z_ref, "latents", rel=1e-3)
    pts = rng.uniform(-0.55, 0.55, (2, 500, 3)).astype(np.float32)
    ref = jpipe.decode_logits_fn(s1, z_ref)(jnp.asarray(pts))
    got = pipe.decode_logits_fn(z)(torch.from_numpy(pts))
    assert got.shape == (2, 500)
    assert float(np.std(np.asarray(ref))) > 1e-2  # the field is not flat
    _close(got.detach(), ref, "logits", rel=1e-3)


def test_encode_latents_and_occupancy_logits_match_jax(shared):
    """Point cloud -> pointnet -> encoder -> posterior draws from the same
    noise -> z [xy | xz | yz], and the logits of the decoded field."""
    jpipe, s1, _, sds = shared
    rng = np.random.default_rng(13)
    cloud = rng.uniform(-0.45, 0.45, (2, 300, 3)).astype(np.float32)
    eps = [rng.standard_normal((2, 8, 8, 8)).astype(np.float32) for _ in range(3)]
    fea = jpipe.pointnet.apply({"params": s1["pointnet"]}, jnp.asarray(cloud))
    posts = jpipe.vae.apply({"params": s1["vae"]}, (fea["xy"], fea["yz"], fea["xz"]),
                            method=jpipe.vae.encode)
    xy, yz, xz = (np.asarray(q.mean) + np.exp(0.5 * np.asarray(q.logvar)) * e
                  for q, e in zip(posts, eps))
    z_ref = np.concatenate([xy, xz, yz], -1)
    pipe = _port_pipe(sds)
    z = pipe.encode_latents(torch.from_numpy(cloud), eps=[_nchw(e) for e in eps])
    _close(_nhwc(z), z_ref, "encoded latents")
    pts = rng.uniform(-0.55, 0.55, (2, 200, 3)).astype(np.float32)
    ref = jpipe.logits_from_pyramids(s1, jnp.asarray(pts),
                                     jpipe.decode_pyramids(s1, jnp.asarray(z_ref)))
    got = pipe.occupancy_logits(torch.from_numpy(cloud), torch.from_numpy(pts),
                                [_nchw(e) for e in eps])
    _close(got, ref, "occupancy_logits")


def test_decode_of_fp32_latents_on_bf16_parameters_matches_jax(shared):
    """The service's decode: the JAX service casts the stage-1 parameters to
    bf16 (serve/server.py::_bf16) and decodes fp32 DDIM latents with them,
    which flax promotes to an fp32 decode on bf16-valued weights.  The port
    with a bf16 VAE decodes fp32 z the same way: every plane of the three
    pyramids is fp32 and within 1e-5 relative (Frobenius) of JAX's."""
    from ddmi_tpu.serve.server import _bf16

    jpipe, s1, _, sds = shared
    z = np.random.default_rng(21).standard_normal((2, 8, 8, 24)).astype(np.float32)
    ref = jpipe.decode_pyramids(_bf16(jax.tree_util.tree_map(jnp.asarray, s1)), jnp.asarray(z))
    pipe = _port_pipe(sds)
    pipe.vae.to(torch.bfloat16)
    got = pipe.decode_pyramids(_nchw(z))
    for g_planes, r_planes in zip(got, ref):
        for g, r in zip(g_planes, r_planes):
            r = np.asarray(r)
            assert g.dtype == torch.float32 and r.dtype == np.float32
            g = _nhwc(g)
            rel = np.linalg.norm(g - r) / np.linalg.norm(r)
            assert rel <= 1e-5, rel


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline
    from ddmi_tpu_torch.serve.server import SamplerService

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = config_from_dict(CFG)
    for make in (lambda: OccupancyPipeline(cfg),
                 lambda: SamplerService(cfg, service_batch=2, allow_init=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert OccupancyPipeline(cfg, device="cpu").device.type == "cpu"


def test_shapenet_config_matches_jax():
    """The port's readers give the JAX package's values on
    configs/ldm/shapenet.yaml, its convocc block (pointnet and generation
    kwargs, with the defaults threshold 0.2, resolution0 64, 2 upsampling
    steps, no simplification, no refinement) and the stage-1 config."""
    import dataclasses

    from ddmi_tpu.core.config import load_config as jax_load
    from ddmi_tpu.core.convocc_config import generation_kwargs as jax_gen
    from ddmi_tpu.core.convocc_config import load_convocc_config as jax_convocc
    from ddmi_tpu.core.convocc_config import pointnet_kwargs as jax_pn
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.convocc_config import (
        encoder_name,
        generation_kwargs,
        load_convocc_config,
        pointnet_kwargs,
    )

    cwd = os.getcwd()
    os.chdir(ROOT)  # data.conv_config is relative to the working directory
    try:
        for name in ("configs/ldm/shapenet.yaml", "configs/d2c-vae/shapenet.yaml"):
            ours, ref = load_config(name), jax_load(name)
            for a, b in [(ours.model, ref.model), (ours.data, ref.data)] + [
                    (getattr(ours.model, k), getattr(ref.model, k))
                    for k in ("ddconfig", "mlpconfig")]:
                for f in dataclasses.fields(a):
                    if f.name == "extra" or dataclasses.is_dataclass(getattr(a, f.name)):
                        continue
                    assert getattr(a, f.name) == getattr(b, f.name), (name, f.name)
        conv, jconv = load_convocc_config(ours.data.conv_config), jax_convocc(
            ref.data.conv_config)
        assert encoder_name(conv) == "pointnet_local_pool"
        assert pointnet_kwargs(conv) == jax_pn(jconv)
        assert generation_kwargs(conv) == jax_gen(jconv) == {
            "threshold": 0.2, "resolution0": 64, "upsampling_steps": 2,
            "simplify_nfaces": None, "refinement_step": 0}
        assert generation_kwargs({}) == jax_gen({})
        assert generation_kwargs({"generation": {"refinement_step": 7},
                                  "test": {"threshold": 0.4}}) == jax_gen(
            {"generation": {"refinement_step": 7}, "test": {"threshold": 0.4}})
    finally:
        os.chdir(cwd)


# ------------------------------------------------------------ geometry


def _field(n=33, seed=14):
    """A bumpy ellipsoid's logit field on an n^3 grid, float64."""
    lin = np.linspace(-0.55, 0.55, n)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt((x / 0.4) ** 2 + (y / 0.3) ** 2 + (z / 0.35) ** 2)
    bump = 0.1 * np.sin(9 * x + seed) * np.cos(7 * y)
    return 8.0 * (1.0 - r + bump)


def test_marching_cubes_and_simplify_match_jax_geometry():
    from ddmi_tpu import geometry as jax_geo
    from ddmi_tpu_torch import geometry

    grid = np.pad(_field(), 1, constant_values=-1e6)
    thr = float(np.log(0.2) - np.log(0.8))
    v, t = geometry.marching_cubes(grid, thr)
    rv, rt = jax_geo.marching_cubes(grid, thr)
    assert len(t) > 1000
    assert np.array_equal(v, rv) and np.array_equal(t, rt)
    sv, st = geometry.simplify_mesh(v, t, 500, 5.0)
    rsv, rst = jax_geo.simplify_mesh(rv, rt, 500, 5.0)
    assert np.array_equal(sv, rsv) and np.array_equal(st, rst) and len(st) <= 600
    assert geometry.lib_path().parent.name == "geometry"
    assert geometry.lib_path().exists()  # built under build/geometry/


def test_mise_matches_jax_geometry():
    from ddmi_tpu import geometry as jax_geo
    from ddmi_tpu_torch import geometry

    field = _field(65)
    thr = float(np.log(0.2) - np.log(0.8))
    ours, ref = geometry.MISE(16, 2, thr), jax_geo.MISE(16, 2, thr)
    waves = 0
    while True:
        q, rq = ours.query(), ref.query()
        assert np.array_equal(q, rq)
        if not len(q):
            break
        vals = field[q[:, 0], q[:, 1], q[:, 2]]
        ours.update(q, vals)
        ref.update(rq, vals)
        waves += 1
    assert waves == 3
    assert np.array_equal(ours.to_dense(), ref.to_dense())
    ours.close()


def _analytic_group_fn(centers):
    """eval_group_fn of an ellipsoid per slot: (g, bs, 3) -> (g, bs)."""
    def fn(pts):
        pts = np.asarray(pts, np.float64)
        d = (pts - centers[:, None, :]) / np.array([0.4, 0.3, 0.35])
        bump = 0.1 * np.sin(9 * pts[..., 0]) * np.cos(7 * pts[..., 1])
        return (8.0 * (1.0 - np.sqrt((d**2).sum(-1)) + bump)).astype(np.float32)
    return fn


@pytest.mark.parametrize("upsampling_steps", [0, 2])
def test_generate_meshes_batched_matches_jax(upsampling_steps):
    """One numpy field per slot through both lockstep extractors: the same
    meshes, the same round count, the same points per round, and the
    inactive slot skipped (empty mesh, no points asked of it)."""
    from ddmi_tpu.geometry.generation import generate_meshes_batched as jax_batched
    from ddmi_tpu_torch.geometry.generation import generate_meshes_batched

    centers = np.array([[0.0, 0.0, 0.0], [0.05, -0.03, 0.02], [0.1, 0.0, 0.0]])
    active = [True, False, True]
    kw = dict(threshold=0.2, resolution0=12 if upsampling_steps == 0 else 8,
              upsampling_steps=upsampling_steps, points_batch_size=700, workers=2,
              active=active)
    calls = {"jax": [], "port": []}

    def recorded(tag):
        inner = _analytic_group_fn(centers)

        def fn(pts):
            calls[tag].append(np.array(pts))
            return inner(pts)
        return fn

    ref = jax_batched(recorded("jax"), 3, **kw)
    stats = {}
    got = generate_meshes_batched(recorded("port"), 3, stats=stats, **kw)
    assert len(calls["jax"]) == len(calls["port"]) == stats["rounds"] > 2
    for a, b in zip(calls["jax"], calls["port"]):
        assert a.shape == b.shape == (3, 700, 3) and np.array_equal(a, b)
    if upsampling_steps:
        assert all(not c[1].any() for c in calls["port"])  # the inactive slot asks nothing
    assert len(got) == 3 and len(got[1][0]) == 0 and len(got[1][1]) == 0
    for (v, t), (rv, rt) in zip(got, ref):
        assert np.array_equal(v, rv) and np.array_equal(t, rt)
    assert len(got[0][1]) > 100 and not np.array_equal(got[0][0], got[2][0])
    assert stats["points"] > 0


def test_mesh_generator_matches_jax():
    from ddmi_tpu.geometry.generation import MeshGenerator as JaxGen
    from ddmi_tpu_torch.geometry.generation import MeshGenerator

    c = np.zeros((1, 3))
    fn = _analytic_group_fn(c)
    ref = JaxGen(lambda p: fn(np.asarray(p)), resolution0=8, upsampling_steps=2,
                 points_batch_size=900).generate()
    got = MeshGenerator(lambda p: torch.from_numpy(fn(p.numpy())), resolution0=8,
                        upsampling_steps=2, points_batch_size=900).generate()
    assert len(got[1]) > 100
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def test_sample_surface_points_matches_jax():
    from ddmi_tpu.geometry.generation import sample_surface_points as jax_sample
    from ddmi_tpu_torch import geometry
    from ddmi_tpu_torch.geometry.generation import sample_surface_points

    v, t = geometry.marching_cubes(np.pad(_field(17), 1, constant_values=-1e6), 0.0)
    assert np.array_equal(sample_surface_points(v, t, 2048, seed=3),
                          jax_sample(v, t, 2048, seed=3))


# ---------------------------------------------------------- refinement


R0, SLOPE = 0.35, 20.0


def _sphere_jax(pts):
    return SLOPE * (R0 - jnp.linalg.norm(pts, axis=-1))


def _sphere_torch(pts):
    return SLOPE * (R0 - torch.linalg.norm(pts, dim=-1))


def _jax_refinement_loss(v, faces, eps, logits_fn, threshold, normal_weight):
    """The loss of ddmi_tpu/geometry/generation.py::_refine_runner, unpadded
    (mask all ones, denom = number of faces)."""
    fv = v[faces]
    fp = (fv * eps[:, :, None]).sum(axis=1)
    fn = jnp.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 1])
    fn = fn / jnp.sqrt((fn**2).sum(axis=1, keepdims=True) + 1e-20)
    prob = lambda p: jax.nn.sigmoid(logits_fn(p[None])[0])
    face_value = prob(fp)
    nt = -jax.grad(lambda p: prob(p).sum())(fp)
    nt = nt / jnp.sqrt((nt**2).sum(axis=1, keepdims=True) + 1e-20)
    n = faces.shape[0]
    return (((face_value - threshold) ** 2).sum() / n
            + normal_weight * ((fn - nt) ** 2).sum(axis=1).sum() / n)


def _sphere_mesh():
    from ddmi_tpu_torch.geometry.generation import MeshGenerator

    return MeshGenerator(_sphere_torch, threshold=0.5, resolution0=16,
                         upsampling_steps=0).generate()


def test_refinement_loss_gradient_and_rmsprop_step_match_jax():
    """On an INR3D field (so the second derivative runs through
    F.grid_sample): the loss and its vertex gradient against jax.grad of the
    same expression on the same Dirichlet draws, then one optax rmsprop
    step against the port's rule."""
    import optax

    from ddmi_tpu_torch.geometry.generation import refinement_loss, rmsprop_step

    jm, p, m = _inr3d(seed=15)
    pyr = _pyramids(np.random.default_rng(16), 1)
    jpyr = tuple([jnp.asarray(a) for a in lv] for lv in pyr)
    tpyr = _port_pyramids(pyr)
    verts, tris = _sphere_mesh()
    rng = np.random.default_rng(17)
    v0 = (verts + 0.01 * rng.standard_normal(verts.shape)).astype(np.float32)
    eps = rng.dirichlet([0.5, 0.5, 0.5], len(tris)).astype(np.float32)

    jfield = lambda q: jm.apply({"params": p}, q, jpyr)
    jloss = lambda v: _jax_refinement_loss(v, jnp.asarray(tris), jnp.asarray(eps), jfield,
                                           0.2, 0.01)
    ref_loss, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(v0))
    vg = torch.from_numpy(v0).requires_grad_(True)
    loss = refinement_loss(vg, torch.from_numpy(tris), torch.from_numpy(eps),
                           lambda q: m(q, tpyr), 0.2, 0.01)
    g, = torch.autograd.grad(loss, vg)
    _close(loss.detach(), ref_loss, "refinement loss")
    _close(g, ref_grad, "refinement vertex gradient")
    assert float(np.abs(np.asarray(ref_grad)).max()) > 0

    opt = optax.rmsprop(1e-4, decay=0.99, eps=1e-8)
    want = jnp.asarray(v0)
    state = opt.init(want)
    v, nu = torch.from_numpy(v0.copy()), torch.zeros(v0.shape)
    for k in (1.0, 0.5):  # the second step sees a nonzero nu
        gk = np.array(ref_grad) * k
        upd, state = opt.update(jnp.asarray(gk), state, want)
        want = optax.apply_updates(want, upd)
        rmsprop_step(v, torch.from_numpy(gk), nu, 1e-4)
    _close(v, want, "rmsprop", rel=1e-6)
    _close(nu, state[0].nu, "rmsprop nu", rel=1e-6)


def test_refine_drops_error_to_analytic_surface():
    """The counterpart of tests/test_mesh_refinement.py: a 16^3 sphere mesh
    degraded by 0.02-sigma vertex noise is pulled back onto the analytic
    sphere, the error falling below 0.3 of its start in 100 steps."""
    from ddmi_tpu_torch.geometry.generation import refine_mesh

    verts, tris = _sphere_mesh()
    err = lambda v: float(np.abs(np.linalg.norm(v, axis=1) - R0).mean())
    rng = np.random.default_rng(0)
    pert = (verts + 0.02 * rng.standard_normal(verts.shape)).astype(np.float32)
    out = refine_mesh(pert, tris, _sphere_torch, threshold=0.5, steps=100, lr=1e-3,
                      generator=torch.Generator().manual_seed(0))
    assert out.shape == pert.shape and np.isfinite(out).all()
    assert err(out) < 0.3 * err(pert), (err(pert), err(out))
    assert refine_mesh(pert[:0], tris[:0], _sphere_torch).shape == (0, 3)


def test_mesh_generator_refinement_keeps_the_topology():
    from ddmi_tpu_torch.geometry.generation import MeshGenerator

    v0, t0 = _sphere_mesh()
    v1, t1 = MeshGenerator(_sphere_torch, threshold=0.5, resolution0=16, upsampling_steps=0,
                           refinement_step=20, refinement_lr=1e-3,
                           generator=torch.Generator().manual_seed(0)).generate()
    assert np.array_equal(t0, t1) and v1.shape == v0.shape
    assert float(np.abs(v1 - v0).max()) > 0
    assert float(np.abs(np.linalg.norm(v1, axis=1) - R0).mean()) < 4e-3


# ------------------------------------------------------------- service


MESH_KW = dict(resolution0=8, upsampling_steps=1, points_batch_size=512, workers=2)


def test_occupancy_service_coalesces_and_repeats(shared):
    """Two concurrent requests share one batch of 2; each gets a list of
    (verts, faces) inside the box; a seed repeats its meshes exactly; the
    meshes are JAX's lockstep extractor's on the same latents."""
    from ddmi_tpu.geometry.generation import generate_meshes_batched as jax_batched
    from ddmi_tpu_torch.serve.server import SamplerService

    jpipe, s1, _, sds = shared
    # recentre the random field on the threshold, so that the iso-surface
    # cuts through the box (a trained field's does) instead of the pad ring
    pipe = _port_pipe(sds)
    noise = np.random.default_rng(41).standard_normal((1, 8, 8, 24)).astype(np.float32)
    grid = np.stack(np.meshgrid(*[np.linspace(-0.5, 0.5, 9)] * 3, indexing="ij"), -1)
    logits = pipe.decode_logits_fn(pipe.sample_latents(1, noise=_nchw(noise)))(
        torch.from_numpy(grid.reshape(1, -1, 3).astype(np.float32)))
    shift = float(np.log(0.2) - np.log(0.8)) - float(logits.detach().median())
    sds = {**sds, "mlp": {**sds["mlp"], "net_out.bias": sds["mlp"]["net_out.bias"] + shift}}
    s1 = {**s1, "mlp": {**s1["mlp"], "net_out": {
        "kernel": s1["mlp"]["net_out"]["kernel"],
        "bias": sds["mlp"]["net_out.bias"].numpy()}}}
    svc = SamplerService(config_from_dict(CFG), service_batch=2, linger_ms=500,
                         device="cpu", state_dicts=sds, mesh_kwargs=MESH_KW)
    assert svc.res == 16
    batches = []
    run = svc._extract_meshes

    def counting(z, count):
        batches.append((z.clone(), count))
        return run(z, count)

    svc._extract_meshes = counting
    results = {}
    try:
        threads = [
            threading.Thread(target=lambda s=s: results.__setitem__(s, svc.generate(1, seed=s)))
            for s in (41, 42)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        solo = svc.generate(1, seed=42)
    finally:
        svc.close()
    assert [c for _, c in batches] == [2, 1]  # the two requests shared one batch
    for s in (41, 42):
        (v, f), = results[s]
        assert v.ndim == 2 and v.shape[1] == 3 and f.shape[1] == 3
        assert np.isfinite(v).all() and (np.abs(v) <= 0.55 + 1e-4).all()
    for s in (41, 42):  # the surface lies inside the box, not on the pad ring
        (v, f), = results[s]
        assert len(f) > 0 and (np.abs(v).max(axis=1) < 0.5).mean() > 0.2
    assert np.array_equal(results[42][0][0], solo[0][0])  # a seed reproduces its mesh
    assert np.array_equal(results[42][0][1], solo[0][1])
    z = jnp.asarray(_nhwc(batches[0][0]))
    pyr = jpipe.decode_pyramids(s1, z)
    ref = jax_batched(lambda pts: jpipe.logits_from_pyramids(s1, jnp.asarray(pts), pyr), 2,
                      threshold=0.2, **MESH_KW)
    for s, (rv, rt) in zip((41, 42), ref):
        (v, f), = results[s]
        assert f.shape == rt.shape and np.abs(v - rv).max() < 1e-3


# ---------------------------------------------------------- weight bridge


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape)
        assert np.array_equal(a, b), path


def test_bridge_round_trips_through_the_reference_converters():
    """mlp3d_from_jax, pointnet_from_jax and triplane_vae_from_jax give
    state_dicts that the port's modules load strictly and that
    reference_ckpt.convert_{mlp_3d,pointnet,triplane_vae} map back onto the
    JAX trees bit for bit."""
    from ddmi_tpu.core.config import DDConfig
    from ddmi_tpu.interop.reference_ckpt import (
        convert_mlp_3d,
        convert_pointnet,
        convert_triplane_vae,
    )
    from ddmi_tpu.nn.pointnet import LocalPoolPointnet as JaxPointnet
    from ddmi_tpu.nn.triplane_vae import TriplaneAutoencoder as JaxAE
    from ddmi_tpu_torch.core.config import DDConfig as TorchDD
    from ddmi_tpu_torch.nn.pointnet import LocalPoolPointnet
    from ddmi_tpu_torch.nn.triplane_vae import TriplaneAutoencoder

    _, t, m = _inr3d(seed=20)
    sd = mlp3d_from_jax(t)
    m.load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_mlp_3d(sd), t)

    t = _random_params(lambda: JaxPointnet(c_dim=8, hidden_dim=32, plane_resolution=16,
                                           n_blocks=4).init(jax.random.PRNGKey(0),
                                                            jnp.zeros((1, 16, 3))), 22)
    sd = pointnet_from_jax(t, 4)
    LocalPoolPointnet(c_dim=8, hidden_dim=32, plane_resolution=16, n_blocks=4).load_state_dict(
        sd, strict=True)
    _assert_trees_equal(convert_pointnet(sd, n_blocks=4), t)

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in DD.items()}
    for attn_type, attn_res in (("vanilla", (16,)), ("none", ())):
        kw.update(attn_type=attn_type, attn_resolutions=attn_res)
        dd = DDConfig(**kw)
        planes = tuple(jnp.zeros((1, 32, 32, 8)) for _ in range(3))
        t = _random_params(lambda: JaxAE(dd, embed_dim=8).init(
            {"params": jax.random.PRNGKey(1)}, planes, jax.random.PRNGKey(2)), 23)
        sd = triplane_vae_from_jax(t, dd)
        TriplaneAutoencoder(TorchDD(**kw), embed_dim=8,
                            with_encoder=True).load_state_dict(sd, strict=True)
        _assert_trees_equal(convert_triplane_vae(sd, dd), t)


def test_port_occupancy_service_never_imports_jax():
    """A fresh interpreter serves a tiny occupancy config (2 DDIM steps, a
    16^3 MISE grid) and encodes a point cloud without loading jax or any
    module of the JAX package, the geometry library included."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        from ddmi_tpu_torch.core.config import config_from_dict
        from ddmi_tpu_torch.serve.server import SamplerService
        cfg = config_from_dict({"model": {"embed_dim": 4,
            "pointnet": {"c_dim": 8, "hidden_dim": 16, "plane_resolution": 16, "n_blocks": 2},
            "params": {
            "unetconfig": dict(in_channels=12, model_channels=32, out_channels=12,
                               attention_resolutions=[2], num_res_blocks=1,
                               channel_mult=[1, 2], num_head_channels=16),
            "ddconfig": dict(z_channels=16, resolution=16, in_channels=8, out_ch=8, ch=32,
                             ch_mult=[1, 2, 2], num_res_blocks=1, hdbf_resolutions=[4, 8],
                             inter_attn_resolutions=[8]),
            "mlpconfig": dict(in_ch=3, out_ch=1, ch=32, latent_dim=8),
            "ddpmconfig": dict(timesteps=20, channels=12, sampling_timesteps=2)}},
            "data": {"domain": "occupancy"}})
        s = SamplerService(cfg, service_batch=2, device="cpu", allow_init=True,
                           mesh_kwargs=dict(resolution0=8, upsampling_steps=1,
                                            points_batch_size=512, workers=1))
        out = s.generate(1, seed=0)
        z = s.pipe.encode_latents(torch.rand(1, 100, 3) - 0.5,
                                  generator=torch.Generator().manual_seed(0))
        s.close()
        assert len(out) == 1 and out[0][0].shape[-1] == 3, out
        assert z.shape == (1, 12, 4, 4), z.shape
        assert "jax" not in sys.modules, "the port loaded jax"
        assert not [m for m in sys.modules if m.split(".")[0] == "ddmi_tpu"]
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize("span", [0.9, 1.2])  # inside the planes; past the border too
def test_grid_sample_under_a_coordinate_gradient_matches_jax(span):
    """With the coordinates carrying a gradient, grid_sample_2d runs its
    gather form: the values of the F.grid_sample form, and the first and
    second derivatives in the coordinates of JAX's grid_sample_2d."""
    from ddmi_tpu.ops.grid_sample import grid_sample_2d as jax_sample
    from ddmi_tpu_torch.ops.grid_sample import grid_sample_2d

    rng = np.random.default_rng(30)
    feat = rng.standard_normal((2, 9, 13, 5)).astype(np.float32)
    grid = rng.uniform(-span, span, (2, 40, 2)).astype(np.float32)
    w = rng.standard_normal((2, 40, 5)).astype(np.float32)
    f = lambda g: jnp.sum(jax_sample(jnp.asarray(feat), g, align_corners=True) * w)
    ref_grad = jax.grad(f)(jnp.asarray(grid))
    ref_hvp = jax.grad(lambda g: jnp.sum(jax.grad(f)(g) ** 2))(jnp.asarray(grid))

    g = torch.from_numpy(grid).requires_grad_(True)
    out = grid_sample_2d(torch.from_numpy(feat), g)
    _close(out.detach(), grid_sample_2d(torch.from_numpy(feat), torch.from_numpy(grid)),
           "gather form vs F.grid_sample", rel=1e-6)
    d, = torch.autograd.grad((out * torch.from_numpy(w)).sum(), g, create_graph=True)
    dd, = torch.autograd.grad((d**2).sum(), g)
    _close(d.detach(), ref_grad, "d/dgrid", rel=1e-5)
    _close(dd, ref_hvp, "second derivative", rel=1e-4)
