"""The port's two kernels: their plain PyTorch versions (what a wrapper runs
on a CPU tensor) against the JAX package's Pallas kernels in interpret mode
and against the JAX reference paths, on the same numpy-made inputs; the INR
render's Philox noise reference against Random123's known answers; and the
kernel sources the build names.  The CUDA kernels themselves are tested on
the card in tests/test_torch_cuda.py.

Tolerance for fp32 parity: max|diff| <= 1e-4 * max(1, max|ref|), because the
two frameworks sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import MLPConfig
from ddmi_tpu.nn.inr import INRImage
from ddmi_tpu.ops.pallas import inr_decode as jax_inr
from ddmi_tpu.ops.pallas.attn_block import _dense_block_ref, fused_attention_block
from ddmi_tpu.ops.resample import pixel_center_lin
from ddmi_tpu_torch.interop import mlp_image_from_jax
from ddmi_tpu_torch.nn.inr import INRImage as TorchINR
from ddmi_tpu_torch.ops import attn_block, inr_decode
from ddmi_tpu_torch.ops.resample import pixel_center_lin as torch_lin

torch.set_num_threads(1)


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _attn_args(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (
        f(B, H, W, C), 1.0 + 0.1 * f(C), 0.1 * f(C), f(C, 3 * C) / np.sqrt(C),
        0.1 * f(3 * C), f(C, C) / np.sqrt(C), 0.1 * f(C),
    )


@pytest.mark.parametrize(
    "B,H,W,C,nh",
    [
        (2, 32, 32, 128, 4),   # n = 1024: the JAX kernel's hc = 1 regime
        (2, 16, 16, 128, 4),   # n = 256: hc = 4
        (1, 8, 8, 256, 8),     # n = 64: hc = 8
        (1, 16, 16, 256, 8),   # n = 256, two head chunks
    ],
)
def test_attention_block_plain_matches_jax(B, H, W, C, nh):
    args = _attn_args(0, B, H, W, C)
    scale = (C // nh) ** -0.5
    got = attn_block.fused_attention_block(*map(torch.from_numpy, args), nh, scale)
    jargs = [jnp.asarray(a) for a in args]
    pallas = fused_attention_block(*jargs, nh, scale, 32, 1e-5, True)
    _close(got, pallas, "vs pallas interpret")
    _close(got, _dense_block_ref(*jargs, nh, scale), "vs dense ref")


CH, LATENT, RES = 64, 16, 16


def _inr_params():
    cfg = MLPConfig(in_ch=2, out_ch=3, ch=CH, latent_dim=LATENT)
    hdbf = [jnp.zeros((1, r, r, LATENT)) for r in (8, 16, 32)]
    p = INRImage(cfg).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16, 2)), hdbf, 1.0,
    )["params"]
    # biases are zero at init: randomise them so parity is not vacuous;
    # noise gains stay 0 so both sides are deterministic
    rng = np.random.default_rng(7)

    def jiggle(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = jiggle(v)
            elif k in ("act_bias", "bias"):
                out[k] = (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    p = jiggle(p)
    m = TorchINR(cfg)
    m.load_state_dict(mlp_image_from_jax(p, cfg))
    return cfg, p, m


def test_inr_decode_plain_matches_jax():
    cfg, p, m = _inr_params()
    rng = np.random.default_rng(3)
    planes = [rng.standard_normal((2, r, r, LATENT)).astype(np.float32) for r in (8, 16, 32)]
    si = 0.7
    got = inr_decode.render_tokens_fused(
        m, [torch.from_numpy(a).permute(0, 3, 1, 2) for a in planes], RES, si, 0
    )
    jplanes = [jnp.asarray(a) for a in planes]
    pallas = jax_inr.render_tokens_fused(
        p, jplanes, RES, si, seed=0, ch=CH, tile=256, interpret=True
    )
    _close(got, pallas, "vs pallas interpret")
    lin = pixel_center_lin(RES)
    ref = INRImage(cfg).apply(
        {"params": p}, None, jplanes, si, grid_1d=(lin, lin),
        rngs={"noise": jax.random.PRNGKey(5)},
    )
    _close(got, ref, "vs INRImage")
    # and the port's own unfused INRImage module
    tl = torch_lin(RES)
    mod = m([torch.from_numpy(a).permute(0, 3, 1, 2) for a in planes], si, grid_1d=(tl, tl))
    _close(got, mod.detach(), "vs port INRImage")


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain path only for a CPU tensor."""
    x = torch.zeros((1, 8, 8, 64), device="meta")
    with pytest.raises(ValueError):
        attn_block.fused_attention_block(x, *([x] * 6), 2, 0.1)


def test_attention_block_supported_is_the_jax_predicate():
    """The kernel zero-pads any head dim to its flash instance, so its
    predicate is the JAX kernel's over every shape."""
    from ddmi_tpu.ops.pallas.attn_block import supported as jax_supported

    for n in (8, 16, 36, 64, 256, 1000, 1024, 1032):
        for C in (128, 256, 384, 512, 640, 1024, 2048):
            for nh in (1, 2, 3, 4, 5, 8, 16, 32, 64):
                assert attn_block.supported(n, C, nh) == jax_supported(n, C, nh), (n, C, nh)


@pytest.mark.parametrize(
    "B,H,W,C,nh",
    [
        (1, 8, 8, 128, 16),    # hd 8 -> the 16 instance
        (2, 4, 8, 384, 16),    # hd 24 -> 32
        (1, 8, 8, 384, 8),     # hd 48 -> 64
    ],
)
def test_attention_block_plain_matches_jax_at_padded_head_dims(B, H, W, C, nh):
    """Head dims the kernel zero-pads (8, 24, 48): the plain version against
    the Pallas kernel in interpret mode and the dense reference."""
    args = _attn_args(C + nh, B, H, W, C)
    scale = (C // nh) ** -0.5
    got = attn_block.fused_attention_block(*map(torch.from_numpy, args), nh, scale)
    jargs = [jnp.asarray(a) for a in args]
    _close(got, fused_attention_block(*jargs, nh, scale, 32, 1e-5, True), "vs pallas interpret")
    _close(got, _dense_block_ref(*jargs, nh, scale), "vs dense ref")


@pytest.mark.parametrize("B,n,C", [(2, 64, 128), (1, 16, 512), (2, 256, 256)])
def test_group_norm_apply_matches_jax(B, n, C):
    """The kernel's GroupNorm step (statistics, fold, multiply-add) against
    ddmi_tpu/ops/fused.py::group_norm, fp32."""
    from ddmi_tpu.ops.fused import group_norm

    rng = np.random.default_rng(n + C)
    x = (2.0 + 3.0 * rng.standard_normal((B, n, C))).astype(np.float32)
    w, b = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32), rng.standard_normal(C).astype(
        np.float32)
    got = attn_block.group_norm_apply(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(b), 32, 1e-5)
    assert got.dtype == torch.float32
    _close(got, group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 32, 1e-5), "gn")


def test_attention_block_module_entry_matches_jax_signature():
    """`attention_block` on the module's layout (head-major qkv Conv1d
    weight, proj Conv1d weight) equals `fused_attention_block` on the JAX
    layout, and the two layout maps invert each other exactly."""
    B, H, W, C, nh = 2, 8, 8, 256, 8
    x, gs, gb, wq, bq, wp, bp = map(torch.from_numpy, _attn_args(9, B, H, W, C))
    mq, mb, mp = attn_block.jax_to_module_layout(wq, bq, wp, nh)
    assert mq.shape == (3 * C, C) and mp.shape == (C, C)
    back = attn_block.module_to_jax_layout(mq[:, :, None], mb, mp[:, :, None], nh)
    assert all(torch.equal(a, b) for a, b in zip(back, (wq, bq, wp)))
    got = attn_block.attention_block(x, gs, gb, mq[:, :, None].contiguous(), mb,
                                     mp[:, :, None].contiguous(), bp, nh, 32**-0.5)
    ref = attn_block.fused_attention_block(x, gs, gb, wq, bq, wp, bp, nh, 32**-0.5)
    assert torch.equal(got, ref)


# Random123's published known-answer vectors for philox4x32-10 (kat_vectors):
# counter, key -> output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    words = inr_decode.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w) for w in words) == want


def _philox_ints(ctr, key):
    """Philox4x32-10 on Python integers: the textbook round, a second
    implementation to hold the tensor one against."""
    m = 0xFFFFFFFF
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & m, (p0 >> 32) ^ c[3] ^ k[1], p0 & m]
        k = [(k[0] + 0x9E3779B9) & m, (k[1] + 0xBB67AE85) & m]
    return c


def test_philox_normal_draws_are_the_kernel_stream():
    """philox_normal's integer bits are Philox4x32-10 on the counter (token,
    conv, 0, 0) and the key (seed, NOISE_KEY), exactly; its Gaussians are
    Box-Muller of the first two words in fp32, to float rounding."""
    seed, n = 1234567, 40
    got = inr_decode.philox_normal(seed, n)
    assert got.shape == (n, inr_decode.NCONV) and got.dtype == torch.float32
    for tok in (0, 1, 17, n - 1):
        for conv in (0, 5, 11):
            w0, w1, _, _ = _philox_ints((tok, conv, 0, 0), (seed, inr_decode.NOISE_KEY))
            u1 = np.float32(((w0 >> 8) + 1) / 16777216.0)
            u2 = np.float32((w1 >> 8) / 16777216.0)
            want = np.sqrt(-2.0 * np.log(np.float64(u1))) * np.cos(2 * np.pi * np.float64(u2))
            assert abs(float(got[tok, conv]) - want) <= 1e-5 * max(1.0, abs(want)), (tok, conv)


def test_philox_normal_seeds():
    a, b = inr_decode.philox_normal(7, 4096), inr_decode.philox_normal(7, 4096)
    c = inr_decode.philox_normal(8, 4096)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(torch.isfinite(a).all())
    assert abs(a.mean().item()) < 0.03 and abs(a.std().item() - 1.0) < 0.03
    # seeds are taken modulo 2^32, as the kernel takes them
    assert torch.equal(inr_decode.philox_normal(7 + 2**32, 16), a[:16])


def test_inr_decode_plain_noise_from_the_draws():
    """With a noise gain, the plain version draws the kernel's Philox noise
    by default, takes given draws instead, and is deterministic in both."""
    cfg, p, m = _inr_params()
    with torch.no_grad():
        for i in (1, 2, 3, 4):
            for c in ("conv1", "conv2", "conv3"):
                getattr(getattr(m, f"net_res{i}"), c).noise.weight.fill_(0.2)
    folded = inr_decode.fold_inr_image_params(m, 0.7)
    assert folded.has_noise
    rng = np.random.default_rng(4)
    planes = [torch.from_numpy(rng.standard_normal((1, LATENT, r, r)).astype(np.float32))
              for r in (8, 16, 32)]
    toks = inr_decode.render_tokens(planes, RES, 0.7, cfg.in_ch)
    N = toks[0].shape[0]
    draws = inr_decode.philox_normal(3, N)
    a = inr_decode.inr_decode_plain(folded, *toks, 3, noise=draws)
    assert torch.equal(a, inr_decode.inr_decode_plain(folded, *toks, 3, noise=draws.clone()))
    assert torch.equal(a, inr_decode.inr_decode_plain(folded, *toks, 3))
    assert not torch.equal(a, inr_decode.inr_decode_plain(folded, *toks, 4))
    other = torch.from_numpy(rng.standard_normal((N, 12)).astype(np.float32))
    assert not torch.equal(a, inr_decode.inr_decode_plain(folded, *toks, 3, noise=other))


def test_kernel_sources_exist():
    """Every library the build names has its csrc/<name>.cu, every library a
    wrapper loads is one of them, and every header a source includes exists
    (a deleted source or header fails here, before the card)."""
    import re
    from pathlib import Path

    from ddmi_tpu_torch.ops import build

    csrc = build.CSRC
    for name in build.LIBRARIES:
        assert (csrc / f"{name}.cu").is_file(), name
    ops = Path(build.__file__).parent
    loaded = set()
    for f in ops.glob("*.py"):
        text = f.read_text()
        loaded |= set(re.findall(r'build\.load\("(\w+)"\)', text))
        loaded |= set(re.findall(r'load_entries\(\s*"(\w+)"', text))
    assert loaded and loaded <= set(build.LIBRARIES), loaded
    for src in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert (csrc / inc).is_file(), (src.name, inc)
