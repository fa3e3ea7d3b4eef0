"""The ported video-generation slice against the JAX package, on the same
weights (converted by ddmi_tpu_torch/interop.py) and the same numpy inputs:
TriplaneUNet, the 1D cross-plane attention blocks and the UNet attention
tiers, the video decoder, INRVideo, `VideoPipeline.sample_videos` at NFE 4,
and the video `SamplerService`.

The config is tiny but routes through every attention tier of the port:
the fused block (UNet ds 2, C 128), mha_vmem (the UNet's cross-plane
attentions and the decoder's bottleneck), the dense MEA path (decoder at
32^2, n = 1536) and flash (decoder at 64^2, n = 5120, hd 32).  On the CPU
each tier runs its plain version; the JAX package on the CPU takes its
non-Pallas paths, which compute the same exact attention.

Tolerances: modules max|diff| <= 1e-4 * max(1, max|ref|) (fp32 both sides,
different sum orders); the slice's pixels in [0, 1] within 1e-3 after 4 DDIM
steps, as tests/test_torch_slice.py holds the image slice.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict as jax_config
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.interop import (
    mlp_video_from_jax,
    triplane_unet_from_jax,
    video_decoder_from_jax,
)

torch.set_num_threads(1)

CFG = {
    "model": {
        "use_fp16": False, "embed_dim": 8,
        "params": {
            "unetconfig": dict(in_channels=8, model_channels=64, out_channels=8,
                               num_res_blocks=1, attention_resolutions=[2],
                               channel_mult=[1, 2], num_head_channels=16),
            "ddconfig": dict(double_z=True, timesformer_channels=64, patch_size=8,
                             splits=1, resolution=64, z_channels=32, in_channels=3,
                             out_ch=8, ch=32, ch_mult=[1, 1, 2, 2], num_res_blocks=1,
                             attn_resolutions=[], hdbf_resolutions=[16, 32],
                             inter_attn_resolutions=[8, 32, 64],
                             attn_type="vanilla-multihead"),
            "mlpconfig": dict(in_ch=3, out_ch=3, ch=64, latent_dim=8),
            "ddpmconfig": dict(timesteps=20, channels=8, sampling_timesteps=4,
                               mixed_init=-6.0),
        },
    },
    "data": {"domain": "video", "frames": 8},
}


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
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


@pytest.fixture(scope="module")
def shared():
    """JAX pipeline + params (zero-init leaves perturbed, mixing logit
    random) and the port state_dicts made from them."""
    from ddmi_tpu.domains.video import VideoPipeline

    jcfg = jax_config(CFG)
    pipe = VideoPipeline(jcfg)
    rng = np.random.default_rng(0)
    # compiled inits: flax's eager init of the TimeSformer and the UNet
    # dispatches thousands of single ops, each compiled on its own
    s1 = _perturb_zeros(jax.jit(pipe.init_stage1_params)(jax.random.PRNGKey(0)), rng)
    s2 = jax.jit(pipe.init_stage2_params)(jax.random.PRNGKey(1))
    s2 = {"unet": _perturb_zeros(s2["unet"], rng),
          "mixing_logit": rng.standard_normal((1, 1, 8)).astype(np.float32)}
    m = pipe.cfg.model
    unet_cfg = pipe.unet.cfg  # plane_sizes filled in by the pipeline
    sds = {
        "unet": triplane_unet_from_jax(s2["unet"], unet_cfg),
        "vae": video_decoder_from_jax(s1["vae"], m.ddconfig),
        "mlp": mlp_video_from_jax(s1["mlp"]),
        "mixing_logit": torch.from_numpy(s2["mixing_logit"]),
    }
    return pipe, s1, s2, sds


def _port_pipe(sds):
    from ddmi_tpu_torch.domains.video import VideoPipeline

    pipe = VideoPipeline(config_from_dict(CFG), device="cpu")
    pipe.load_state_dicts(**sds)
    return pipe


def test_triplane_unet_matches_jax(shared):
    jpipe, _, s2, sds = shared
    pipe = _port_pipe(sds)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, jpipe.n_latent_tokens, 8)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    ref = jax.jit(jpipe.unet.apply)({"params": s2["unet"]}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = pipe.unet(torch.from_numpy(x), torch.from_numpy(t).long())
    _close(got, ref, "TriplaneUNet")


def test_video_decoder_matches_jax(shared):
    jpipe, s1, _, sds = shared
    pipe = _port_pipe(sds)
    z = np.random.default_rng(3).standard_normal((2, jpipe.n_latent_tokens, 8)).astype(np.float32)
    ref = jax.jit(lambda p, z: jpipe.vae.apply({"params": p}, z, method=jpipe.vae.decode))(
        s1["vae"], jnp.asarray(z))
    with torch.no_grad():
        got = pipe.vae.decode(torch.from_numpy(z))
    for name, g_pyr, r_pyr in zip(("xy", "yt", "xt"), got, ref):
        assert len(g_pyr) == len(r_pyr) == 3
        for g, r in zip(g_pyr, r_pyr):
            _close(_nhwc(g), r, f"hdbf {name}")


def test_inr_video_matches_jax(shared):
    from ddmi_tpu.ops.resample import pixel_center_lin
    from ddmi_tpu_torch.ops.resample import pixel_center_lin as torch_lin

    jpipe, s1, _, sds = shared
    pipe = _port_pipe(sds)
    rng = np.random.default_rng(4)
    shapes = {"xy": [(2, r, r, 8) for r in (16, 32, 64)],
              "t": [(2, 8, r, 8) for r in (16, 32, 64)]}
    pyr = [[rng.standard_normal(s).astype(np.float32) for s in shapes[k]]
           for k in ("xy", "t", "t")]
    coords = {"axes": (pixel_center_lin(3), pixel_center_lin(20), pixel_center_lin(24))}
    ref = jax.jit(lambda params, pyr: jpipe.mlp.apply({"params": params}, coords, pyr))(
        s1["mlp"], tuple([jnp.asarray(a) for a in p] for p in pyr))
    with torch.no_grad():
        got = pipe.mlp([[_nchw(a) for a in p] for p in pyr],
                       (torch_lin(3), torch_lin(20), torch_lin(24)))
    _close(got, ref, "INRVideo")


def test_sample_videos_matches_jax(shared):
    jpipe, s1, s2, sds = shared
    noise = np.random.default_rng(1).standard_normal(
        (2, jpipe.n_latent_tokens, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda s2, s1, rng, z: jpipe.sample_videos(
        s2, s1, rng, batch=2, noise=z))(s2, s1, jax.random.PRNGKey(2), jnp.asarray(noise)))
    got = _port_pipe(sds).sample_videos(2, noise=torch.from_numpy(noise)).numpy()
    assert got.shape == ref.shape == (2, 8, 64, 64, 3)
    assert float(ref.std()) > 1e-3  # the comparison sees a non-constant video
    assert float(np.abs(got - ref).max()) <= 1e-3


def test_video_service_coalesces_concurrent_requests(shared):
    from ddmi_tpu_torch.serve.server import SamplerService

    *_, sds = shared
    svc = SamplerService(config_from_dict(CFG), service_batch=2, linger_ms=500,
                         device="cpu", state_dicts=sds)
    batches = []
    run = svc.pipe.sample_videos

    def counting(*a, **k):
        batches.append(a)
        return run(*a, **k)

    svc.pipe.sample_videos = counting
    results = {}
    try:
        threads = [
            threading.Thread(target=lambda s=s: results.__setitem__(s, svc.generate(1, seed=s)))
            for s in (21, 22)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        solo = svc.generate(1, seed=22)
    finally:
        svc.close()
    assert len(batches) == 2, batches  # the two requests shared one batch
    assert {s: r.shape for s, r in results.items()} == {
        21: (1, 8, 64, 64, 3), 22: (1, 8, 64, 64, 3)}
    assert all(r.dtype == np.uint8 for r in results.values())
    # the initial latent is per request, so a seed reproduces its video
    # wherever it sits in a batch
    assert np.array_equal(results[22], solo)


@pytest.mark.parametrize(
    "n,C,expand",
    [
        (48, 256, False),    # mha_vmem, hd 16
        (520, 512, False),   # mha_vmem at n 520 (a ragged 64-row q tile), hd 32
        (1536, 64, False),   # no Pallas tier: MEA dense, hd 4
        (2048, 256, False),  # flash, hd 16
        (48, 32, True),      # expand: mha_vmem, hd 32
        (2560, 32, True),    # expand: MEA streamed (n > 2048), hd 32
    ],
)
def test_attn_block_1d_matches_jax(n, C, expand):
    from ddmi_tpu.nn.attention1d import AttnBlock1D, AttnBlock1DExpand
    from ddmi_tpu_torch.interop import _attn1d
    from ddmi_tpu_torch.nn import attention1d as t1d

    jm = AttnBlock1DExpand() if expand else AttnBlock1D(num_heads=16)
    rng = np.random.default_rng(n + C)
    x = rng.standard_normal((2, n, C)).astype(np.float32)
    p = _perturb_zeros(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    ref = jm.apply({"params": p}, jnp.asarray(x))
    m = t1d.AttnBlock1DExpand(C) if expand else t1d.AttnBlock1D(C, 16)
    sd = {}
    _attn1d(sd, "blk", p)
    m.load_state_dict({k[4:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    _close(got, ref, "AttnBlock1D")


@pytest.mark.parametrize(
    "H,W,C,heads",
    [
        (4, 4, 128, 2),     # fused block, hd 64, n 16
        (4, 4, 64, 4),      # C % 128 != 0: mha_vmem, hd 16
        (36, 36, 64, 4),    # n 1296 > 1024: flash, hd 16
        (6, 6, 64, 4),      # n 36, not a multiple of 8: dense
    ],
)
def test_unet_attention_block_tiers_match_jax(H, W, C, heads):
    from ddmi_tpu.nn.unet import AttentionBlock
    from ddmi_tpu_torch.interop import _adm_attn
    from ddmi_tpu_torch.nn.unet import AttentionBlock as TorchAttn

    jm = AttentionBlock(heads)
    rng = np.random.default_rng(H * C)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    p = _perturb_zeros(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    ref = jm.apply({"params": p}, jnp.asarray(x))
    sd = {}
    _adm_attn(sd, "blk", p, heads)
    m = TorchAttn(C, heads)
    m.load_state_dict({k[4:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = m(_nchw(x))
    _close(_nhwc(got), ref, "AttentionBlock")


def test_separable_grid_sample_align_corners_matches_jax():
    from ddmi_tpu.ops.resample import separable_grid_sample
    from ddmi_tpu_torch.ops.resample import separable_grid_sample as torch_sample

    rng = np.random.default_rng(9)
    plane = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    xs = np.linspace(-1.1, 1.1, 13).astype(np.float32)   # past the border too
    ys = rng.uniform(-1, 1, 9).astype(np.float32)
    for align in (True, False):
        ref = separable_grid_sample(jnp.asarray(plane), jnp.asarray(xs), jnp.asarray(ys),
                                    align_corners=align)
        got = torch_sample(_nchw(plane), torch.from_numpy(xs), torch.from_numpy(ys),
                           align_corners=align)
        _close(got, ref, f"align_corners={align}")


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    """Without a CUDA device the pipelines and the service refuse the
    default device, and run when given device="cpu"."""
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.domains.video import VideoPipeline
    from ddmi_tpu_torch.serve.server import SamplerService

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = config_from_dict(CFG)
    for make in (lambda: VideoPipeline(cfg),
                 lambda: SamplerService(cfg, service_batch=2, allow_init=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    image_cfg = config_from_dict({"data": {"domain": "image"}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImagePipeline(image_cfg)
    assert VideoPipeline(cfg, device="cpu").device.type == "cpu"
