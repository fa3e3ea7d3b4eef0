"""The ported NeRF-generation slice against the JAX package, on the same
weights (converted by ddmi_tpu_torch/interop.py) and the same numpy inputs:
rays, camera path, frequency embedding, grid sampling, the triplane lookup,
compositing, INRNeRF, the fold and the plain version of the fused NeRF MLP
kernel, the triplane decoder, `NeRFPipeline.sample_nerfs` at NFE 4, and
the NeRF `SamplerService`.

Tolerances: the fp32 geometry and compositing helpers max|diff| <= 1e-5 *
max(1, max|ref|); modules <= 1e-4 * max(1, max|ref|) (fp32 both sides,
different sum orders); the fold is bit-identical; the plain kernel version
against the JAX kernel in interpret mode (both bf16 operands and fp32 sums,
in different orders, so a bf16 rounding of h may flip): rgb <= 0.005, sigma
<= 0.01 * max(1, max|sigma|); the slice's pixels within 1e-3 after 4 DDIM
steps, as the image and video slices are held.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.interop import mlp_nerf_from_jax, triplane_decoder_from_jax, unet_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = {
    "model": {
        "use_fp16": False, "embed_dim": 8,
        "pointnet": {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 16, "n_blocks": 2},
        "params": {
            "ddconfig": dict(double_z=True, z_channels=32, resolution=16, in_channels=8,
                             out_ch=8, ch=32, ch_mult=[1, 2], num_res_blocks=1,
                             attn_resolutions=[], hdbf_resolutions=[],
                             inter_attn_resolutions=[16], attn_type="vanilla"),
            "unetconfig": dict(image_size=8, in_channels=24, model_channels=32,
                               out_channels=24, num_res_blocks=1, attention_resolutions=[2],
                               channel_mult=[1, 2], num_head_channels=16),
            "ddpmconfig": dict(timesteps=20, image_size=8, channels=24,
                               sampling_timesteps=4, mixed_init=-6.0),
            "mlpconfig": dict(in_ch=3, out_ch=4, ch=32, latent_dim=8, D=2, W=32, skips=[1],
                              multires=4, multires_views=2, N_samples=16, white_bkgd=True),
        },
    },
    "data": {"domain": "nerf"},
}


def _close(got, ref, what="", rel=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _perturb_zeros(tree, rng):
    """Seeded N(0, 0.05^2) values for every all-zero leaf."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_zeros(v, rng)
        else:
            a = np.asarray(v)
            out[k] = (0.05 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a
    return out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------ helpers


def test_freq_embedding_matches_jax():
    from ddmi_tpu.nn.inr import FreqEmbedding as JaxEmbed
    from ddmi_tpu_torch.nn.inr import FreqEmbedding

    x = np.random.default_rng(0).uniform(-3, 3, (7, 5, 3)).astype(np.float32)
    for n in (4, 10):
        ref = JaxEmbed(n).apply({}, jnp.asarray(x))
        got = FreqEmbedding(n)(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape[-1] == FreqEmbedding(n).out_dim()
        _close(got, ref, f"FreqEmbedding({n})", rel=1e-5)


def test_rays_and_camera_path_match_jax():
    from ddmi_tpu.domains.nerf import NeRFPipeline as JaxPipe
    from ddmi_tpu.domains.nerf import get_rays as jax_rays
    from ddmi_tpu_torch.domains.nerf import get_rays, spherical_poses

    ref_poses = np.asarray(JaxPipe.spherical_poses(None, 8))
    poses = spherical_poses(8)
    _close(poses, ref_poses, "spherical_poses", rel=1e-5)
    for H, W in ((8, 8), (12, 20)):
        for k in (0, 3):
            ro, rd = jax_rays(H, W, jnp.asarray(ref_poses[k]))
            o, d = get_rays(H, W, poses[k])
            _close(o, ro, "rays_o", rel=1e-5)
            _close(d, rd, "rays_d", rel=1e-5)


@pytest.mark.parametrize("span", [0.9, 1.2])  # inside the planes; past the border too
def test_grid_sample_2d_matches_jax(span):
    """The NeRF path's settings: align_corners=True, border padding."""
    from ddmi_tpu.ops.grid_sample import grid_sample_2d as jax_sample
    from ddmi_tpu_torch.ops.grid_sample import grid_sample_2d

    rng = np.random.default_rng(1)
    feat = rng.standard_normal((2, 9, 13, 5)).astype(np.float32)
    grid = rng.uniform(-span, span, (2, 40, 2)).astype(np.float32)
    ref = jax_sample(jnp.asarray(feat), jnp.asarray(grid), align_corners=True,
                     padding_mode="border")
    got = grid_sample_2d(torch.from_numpy(feat), torch.from_numpy(grid))
    _close(got, ref, f"grid_sample_2d span {span}", rel=1e-5)


def test_sample_triplane_matches_jax():
    from ddmi_tpu.domains.nerf import sample_triplane as jax_triplane
    from ddmi_tpu_torch.domains.nerf import sample_triplane

    rng = np.random.default_rng(2)
    planes = {k: rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
              for k in ("xy", "yz", "xz")}
    pts = rng.uniform(-4, 4, (10, 6, 3)).astype(np.float32)
    ref = jax_triplane({k: jnp.asarray(v) for k, v in planes.items()}, jnp.asarray(pts))
    got = sample_triplane({k: _nchw(v) for k, v in planes.items()}, torch.from_numpy(pts))
    assert got.shape == (10, 6, 24)
    _close(got, ref, "sample_triplane", rel=1e-5)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_raw2outputs_matches_jax(white_bkgd):
    from ddmi_tpu.domains.nerf import raw2outputs as jax_composite
    from ddmi_tpu_torch.domains.nerf import raw2outputs

    rng = np.random.default_rng(3)
    raw = rng.standard_normal((12, 16, 4)).astype(np.float32) * 3
    z = np.sort(rng.uniform(2, 6, (12, 16)), -1).astype(np.float32)
    rd = rng.standard_normal((12, 3)).astype(np.float32)
    ref = jax_composite(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd), white_bkgd)
    got = raw2outputs(torch.from_numpy(raw), torch.from_numpy(z), torch.from_numpy(rd),
                      white_bkgd)
    for name, g, r in zip(("rgb", "weights", "acc"), got, ref):
        _close(g, r, name, rel=1e-5)


# ------------------------------------------------------- INRNeRF + kernel


def _nerf_mlps(depth, skips, width=256, in_xyz=159, in_dir=27, seed=0):
    """A JAX INRNeRF's params (zero biases perturbed) and the port module
    loaded with them."""
    from ddmi_tpu.nn.inr import INRNeRF as JaxNeRF
    from ddmi_tpu_torch.nn.inr import INRNeRF

    jm = JaxNeRF(depth=depth, width=width, in_channels_xyz=in_xyz,
                 in_channels_dir=in_dir, skips=skips)
    p = jm.init(jax.random.PRNGKey(seed), jnp.zeros((4, in_xyz + in_dir)))["params"]
    p = _perturb_zeros(p, np.random.default_rng(seed))
    m = INRNeRF(depth, width, in_xyz, in_dir, skips)
    m.load_state_dict(mlp_nerf_from_jax(p, depth), strict=True)
    return jm, p, m


SHAPES = [(6, (2, 4)), (8, (2, 4, 6)), (2, ())]


@pytest.mark.parametrize("depth,skips", SHAPES)
def test_inr_nerf_matches_jax(depth, skips):
    jm, p, m = _nerf_mlps(depth, skips)
    x = np.random.default_rng(4).standard_normal((100, 186)).astype(np.float32)
    ref = jm.apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    _close(got, ref, f"INRNeRF D={depth}")


@pytest.mark.parametrize("depth,skips", SHAPES)
def test_fold_nerf_params_is_bit_identical_to_jax(depth, skips):
    from ddmi_tpu.ops.pallas.nerf_mlp import fold_nerf_params as jax_fold
    from ddmi_tpu_torch.ops.nerf_mlp import fold_nerf_params

    _, p, m = _nerf_mlps(depth, skips)
    ref = jax_fold(p, depth, 256, 159, 27, skips)
    got = fold_nerf_params(m)
    for name in ("wx", "wh", "b", "w_sig", "b_sig", "w_fin", "b_fin", "w_dirf", "w_dird",
                 "b_dir", "w_rgb", "b_rgb"):
        r = np.asarray(getattr(ref, name).astype(jnp.float32))
        g = getattr(got, name)
        assert g.dtype == torch.bfloat16 and g.shape == r.shape, (name, g.shape, r.shape)
        assert np.array_equal(g.float().numpy(), r), name
    assert (got.depth, got.width, got.in_xyz, got.in_dir, got.skips) == (
        ref.depth, ref.width, ref.in_xyz, ref.in_dir, ref.skips)


@pytest.mark.parametrize("depth,skips", SHAPES)
def test_nerf_mlp_plain_matches_jax_kernel(depth, skips):
    """nerf_mlp_plain (the kernel's CPU version) against the JAX kernel in
    interpret mode on 300 points, and, folded in fp32, against the JAX
    INRNeRF module (the port's CPU path at width 256)."""
    from ddmi_tpu.ops.pallas.nerf_mlp import fold_nerf_params as jax_fold
    from ddmi_tpu.ops.pallas.nerf_mlp import nerf_mlp_fused as jax_kernel
    from ddmi_tpu_torch.ops.nerf_mlp import fold_nerf_params, nerf_mlp_fused, nerf_mlp_plain

    jm, p, m = _nerf_mlps(depth, skips)
    x = np.random.default_rng(5).standard_normal((300, 186)).astype(np.float32)
    ref = np.asarray(jax_kernel(jax_fold(p, depth, 256, 159, 27, skips), jnp.asarray(x),
                                block=128, interpret=True))
    got = nerf_mlp_plain(fold_nerf_params(m), torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (300, 4)
    assert np.abs(got[:, :3] - ref[:, :3]).max() <= 0.005
    sig_tol = 0.01 * max(1.0, float(np.abs(ref[:, 3]).max()))
    assert np.abs(got[:, 3] - ref[:, 3]).max() <= sig_tol

    fp32 = nerf_mlp_fused(fold_nerf_params(m, torch.float32), torch.from_numpy(x))
    _close(fp32, jm.apply({"params": p}, jnp.asarray(x)), "fp32 plain vs INRNeRF")


def test_fold_refuses_widths_outside_the_predicate():
    from ddmi_tpu_torch.nn.inr import INRNeRF
    from ddmi_tpu_torch.ops.nerf_mlp import fold_nerf_params, supported

    assert supported(256) and not supported(128) and not supported(512)
    with pytest.raises(NotImplementedError):
        fold_nerf_params(INRNeRF(4, 128, 159, 27, (2,)))


def test_kernel_supported_counts_the_cuda_kernels_input_panels():
    from ddmi_tpu_torch.ops.nerf_mlp import kernel_supported

    assert kernel_supported(256, 159, 27)  # srn_cars: 3 + 1 panels, resident
    assert kernel_supported(256, 447, 64) and kernel_supported(256, 320, 150)  # 8 panels
    # 9 panels and more stream through the kernel's input buffer
    assert kernel_supported(256, 512, 27) and kernel_supported(256, 327, 129)
    assert kernel_supported(256, 603, 87)
    assert not kernel_supported(128, 159, 27) and not kernel_supported(512, 159, 27)
    assert not kernel_supported(256, 0, 27) and not kernel_supported(256, 159, 0)


@pytest.mark.parametrize("multires, multires_views, width, kernel",
                         [(4, 2, 256, True), (4, 11, 256, True), (50, 21, 256, True),
                          (4, 2, 128, False)])
def test_fold_mlp_follows_the_cuda_kernels_predicate(multires, multires_views, width, kernel):
    """`NeRFPipeline.fold_mlp` folds the MLP at width 256 whatever its input
    widths (in_dir 69 from multires_views 11; in_xyz 327 and in_dir 129,
    9 panels, which the CUDA kernel streams), as JAX's predicate does, and
    returns None at width 128, where `run_mlp` runs the INRNeRF module;
    both agree with the module (fp32) within 1e-4 * max(1, max|ref|)."""
    import copy

    from ddmi_tpu_torch.domains.nerf import NeRFPipeline
    from ddmi_tpu_torch.ops.nerf_mlp import kernel_supported

    cfg = copy.deepcopy(CFG)
    cfg["model"]["params"]["mlpconfig"].update(D=2, W=width, skips=[1], multires=multires,
                                               multires_views=multires_views)
    pipe = NeRFPipeline(config_from_dict(cfg), device="cpu")
    m = pipe.mlp
    assert kernel_supported(m.width, m.in_channels_xyz, m.in_channels_dir) == kernel
    folded = pipe.fold_mlp()
    assert (folded is not None) == kernel
    rng = np.random.default_rng(multires)
    x = torch.from_numpy(rng.standard_normal(
        (2, 8, m.in_channels_xyz + m.in_channels_dir)).astype(np.float32))
    with torch.no_grad():
        got, ref = pipe.run_mlp(x, folded), m(x)
    assert got.shape == (2, 8, 4)
    _close(got, ref, "run_mlp vs INRNeRF")


# ------------------------------------------------------ triplane decoder


DECODE_DD = dict(double_z=True, z_channels=16, resolution=16, in_channels=8, out_ch=8,
                 ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8],
                 hdbf_resolutions=[8], inter_attn_resolutions=[16, 8], attn_type="vanilla")


def test_triplane_decode_matches_jax():
    from ddmi_tpu.core.config import DDConfig
    from ddmi_tpu.nn.triplane_vae import TriplaneAutoencoder as JaxAE
    from ddmi_tpu_torch.core.config import DDConfig as TorchDD
    from ddmi_tpu_torch.nn.triplane_vae import TriplaneAutoencoder

    dd = DDConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in DECODE_DD.items()})
    jae = JaxAE(dd, embed_dim=4)
    planes = tuple(jnp.zeros((1, 16, 16, 8)) for _ in range(3))
    rng = np.random.default_rng(6)
    p = _perturb_zeros(jae.init({"params": jax.random.PRNGKey(0)}, planes,
                                jax.random.PRNGKey(1))["params"], rng)
    tdd = TorchDD(**{k: tuple(v) if isinstance(v, list) else v for k, v in DECODE_DD.items()
                     if k not in ("in_channels",)})
    ae = TriplaneAutoencoder(tdd, embed_dim=4)
    ae.load_state_dict(triplane_decoder_from_jax(p, dd), strict=True)
    z = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    ref = jae.apply({"params": p}, jnp.asarray(z), method=jae.decode)
    with torch.no_grad():
        got = ae.decode(_nchw(z))
    for name, g_pyr, r_pyr in zip(("xy", "yz", "xz"), got, ref):
        assert len(g_pyr) == len(r_pyr) == 2
        for g, r in zip(g_pyr, r_pyr):
            _close(_nhwc(g), r, f"plane {name}")


# ----------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def shared():
    """JAX pipeline + params (zero-init leaves perturbed, mixing logit
    random) and the port state_dicts made from them."""
    from ddmi_tpu.domains.nerf import NeRFPipeline as JaxPipe

    jcfg = jax_config(CFG)
    pipe = JaxPipe(jcfg)
    rng = np.random.default_rng(0)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    planes = tuple(jnp.zeros((1, 16, 16, 8)) for _ in range(3))
    in_dim = pipe.mlp.in_channels_xyz + pipe.mlp.in_channels_dir
    s1 = {"vae": _perturb_zeros(pipe.vae.init({"params": k1}, planes, k2)["params"], rng),
          "mlp": _perturb_zeros(pipe.mlp.init(k3, jnp.zeros((8, in_dim)))["params"], rng)}
    unet = pipe.unet.init(k4, jnp.zeros((1, 8, 8, 24)), jnp.zeros((1,), jnp.int32))["params"]
    s2 = {"unet": _perturb_zeros(unet, rng),
          "mixing_logit": rng.standard_normal((1, 1, 1, 24)).astype(np.float32)}
    m = jcfg.model
    sds = {
        "unet": unet_from_jax(s2["unet"], m.unetconfig),
        "vae": triplane_decoder_from_jax(s1["vae"], m.ddconfig),
        "mlp": mlp_nerf_from_jax(s1["mlp"], pipe.mlp.depth),
        "mixing_logit": torch.from_numpy(s2["mixing_logit"]),
    }
    return pipe, s1, s2, sds


def _port_pipe(sds):
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline

    pipe = NeRFPipeline(config_from_dict(CFG), device="cpu")
    pipe.load_state_dicts(**sds)
    return pipe


def test_sample_nerfs_matches_jax(shared):
    jpipe, s1, s2, sds = shared
    noise = np.random.default_rng(1).standard_normal((2, 8, 8, 24)).astype(np.float32)
    ref = np.asarray(jpipe.sample_nerfs(s2, s1, jax.random.PRNGKey(2), batch=2, n_views=2,
                                        H=8, W=8, noise=jnp.asarray(noise)))
    pipe = _port_pipe(sds)
    assert (pipe.mlp.in_channels_xyz, pipe.mlp.in_channels_dir, pipe.n_samples) == (
        jpipe.mlp.in_channels_xyz, jpipe.mlp.in_channels_dir, jpipe.n_samples)
    got = pipe.sample_nerfs(2, n_views=2, H=8, W=8, noise=_nchw(noise)).numpy()
    assert got.shape == ref.shape == (2, 2, 8, 8, 3)
    # the render's spread is ten times the tolerance, so a flat image cannot pass
    assert float(ref.std()) > 10 * 1e-3
    assert float(np.abs(got - ref).max()) <= 1e-3


def test_nerf_service_coalesces_concurrent_requests(shared):
    from ddmi_tpu_torch.serve.server import SamplerService

    *_, sds = shared
    svc = SamplerService(config_from_dict(CFG), service_batch=2, resolution=8, n_views=2,
                         linger_ms=500, device="cpu", state_dicts=sds)
    batches = []
    run = svc.pipe.sample_nerfs

    def counting(*a, **k):
        batches.append(a)
        return run(*a, **k)

    svc.pipe.sample_nerfs = counting
    results = {}
    try:
        threads = [
            threading.Thread(target=lambda s=s: results.__setitem__(s, svc.generate(1, seed=s)))
            for s in (31, 32)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        solo = svc.generate(1, seed=32)
    finally:
        svc.close()
    assert len(batches) == 2, batches  # the two requests shared one batch
    assert {s: r.shape for s, r in results.items()} == {31: (1, 2, 8, 8, 3),
                                                        32: (1, 2, 8, 8, 3)}
    assert all(r.dtype == np.uint8 for r in results.values())
    assert np.array_equal(results[32], solo)  # a seed reproduces its scene


def test_srn_cars_config_matches_jax():
    """The port's readers give the JAX package's values on
    configs/ldm/srn_cars.yaml and its convocc render block, and the JAX
    NeRF pipeline's MLP widths (xyz 3 * 32 + 63 = 159, dir 27)."""
    import dataclasses

    from ddmi_tpu.core.config import load_config as jax_load
    from ddmi_tpu.core.convocc_config import load_convocc_config as jax_convocc
    from ddmi_tpu.core.convocc_config import nerf_kwargs as jax_kwargs
    from ddmi_tpu.domains.nerf import NeRFPipeline as JaxPipe
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.convocc_config import load_convocc_config, nerf_kwargs
    from ddmi_tpu_torch.nn.inr import FreqEmbedding

    cwd = os.getcwd()
    os.chdir(ROOT)  # data.conv_config is relative to the working directory
    try:
        path = os.path.join(ROOT, "configs/ldm/srn_cars.yaml")
        ours, ref = load_config(path), jax_load(path)
        for a, b in [(ours.model, ref.model), (ours.data, ref.data)] + [
                (getattr(ours.model, k), getattr(ref.model, k))
                for k in ("unetconfig", "ddconfig", "mlpconfig", "ddpmconfig")]:
            for f in dataclasses.fields(a):
                if f.name == "extra" or dataclasses.is_dataclass(getattr(a, f.name)):
                    continue
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        for k in ("D", "W", "skips"):
            assert tuple(np.atleast_1d(ours.model.mlpconfig.extra[k])) == tuple(
                np.atleast_1d(ref.model.mlpconfig.extra[k]))
        kw = nerf_kwargs(load_convocc_config(ours.data.conv_config))
        ref_kw = jax_kwargs(jax_convocc(ref.data.conv_config))
        assert kw == {k: ref_kw[k] for k in kw}
        jpipe = JaxPipe(ref)
    finally:
        os.chdir(cwd)
    in_xyz = 3 * ours.model.ddconfig.out_ch + FreqEmbedding(kw["multires"]).out_dim()
    assert (in_xyz, FreqEmbedding(kw["multires_views"]).out_dim(), kw["N_samples"]) == (
        jpipe.mlp.in_channels_xyz, jpipe.mlp.in_channels_dir, jpipe.n_samples) == (159, 27, 256)


def test_nerf_entry_points_need_the_card_unless_asked_for_the_cpu():
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline
    from ddmi_tpu_torch.serve.server import SamplerService

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = config_from_dict(CFG)
    for make in (lambda: NeRFPipeline(cfg),
                 lambda: SamplerService(cfg, service_batch=2, allow_init=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert NeRFPipeline(cfg, device="cpu").device.type == "cpu"


def test_render_rays_under_autograd_matches_jax_gradients():
    """With a gradient recorded, `NeRFPipeline.render_rays` takes the INRNeRF
    module even at the fused MLP's width (256): the MLP weights' gradients
    (fp32) match jax.grad through JAX's render on the same weights, planes
    and rays, within 1e-4 * max(1, max|ref|) per tensor."""
    import copy

    from ddmi_tpu.domains.nerf import NeRFPipeline as JaxPipe
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline, get_rays, spherical_poses

    cfg = copy.deepcopy(CFG)
    cfg["model"]["params"]["mlpconfig"].update(D=4, W=256, skips=[2])
    jpipe = JaxPipe(jax_config(cfg))
    rng = np.random.default_rng(11)
    in_dim = jpipe.mlp.in_channels_xyz + jpipe.mlp.in_channels_dir
    p = _perturb_zeros(jpipe.mlp.init(jax.random.PRNGKey(3), jnp.zeros((8, in_dim)))["params"],
                       rng)
    planes = {k: rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
              for k in ("xy", "yz", "xz")}
    ro, rd = (a.reshape(-1, 3).numpy() for a in get_rays(4, 4, spherical_poses(1)[0]))
    w = rng.standard_normal((16, 3)).astype(np.float32)

    def loss(params):
        rgb = jpipe.render_rays(params, {k: jnp.asarray(v) for k, v in planes.items()},
                                jnp.asarray(ro), jnp.asarray(rd), jax.random.PRNGKey(0),
                                perturb=0.0)
        return jnp.sum(rgb * jnp.asarray(w))

    want = mlp_nerf_from_jax(jax.grad(loss)(p), 4)
    pipe = NeRFPipeline(config_from_dict(cfg), device="cpu")
    pipe.mlp.load_state_dict(mlp_nerf_from_jax(p, 4), strict=True)
    rgb = pipe.render_rays({k: _nchw(v) for k, v in planes.items()}, torch.from_numpy(ro),
                           torch.from_numpy(rd), pipe.fold_mlp())
    assert rgb.grad_fn is not None
    (rgb * torch.from_numpy(w)).sum().backward()
    for name, par in pipe.mlp.named_parameters():
        assert par.grad is not None, name
        _close(par.grad, want[name], f"d{name}")
