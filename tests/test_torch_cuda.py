"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from ddmi_tpu_torch.core.config import MLPConfig, config_from_dict
from ddmi_tpu_torch.nn.inr import INRImage, INRNeRF
from ddmi_tpu_torch.ops import attention, attn_block, flash_attention, inr_decode, nerf_mlp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _attn_args(seed, B, H, C, dev, W=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    return (f(B, H, W or H, C).bfloat16(), 1.0 + 0.1 * f(C), 0.1 * f(C),
            (f(C, 3 * C) / C**0.5).bfloat16(), 0.1 * f(3 * C),
            (f(C, C) / C**0.5).bfloat16(), 0.1 * f(C))


@pytest.mark.parametrize("H,C,nh", [(32, 512, 16), (16, 1024, 32), (8, 2048, 64)])
def test_attention_block_kernel_matches_plain(cuda_device, H, C, nh):
    """bf16 kernel vs the fp32 plain version on the same bf16 inputs, at the
    celebahq shapes: max|err| <= 0.031 and correlation >= 0.99999 (the bar
    the JAX package holds its bf16 kernel to)."""
    x, gs, gb, wq, bq, wp, bp = _attn_args(1, 2, H, C, cuda_device)
    before = attn_block.fused_attention_block.launches
    out = attn_block.fused_attention_block(x, gs, gb, wq, bq, wp, bp, nh, 32**-0.5)
    ref = attn_block.attention_block_plain(
        x.float(), gs, gb, wq.float(), bq, wp.float(), bp, nh, 32**-0.5
    )
    again = attn_block.fused_attention_block(x, gs, gb, wq, bq, wp, bp, nh, 32**-0.5)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    corr = torch.corrcoef(torch.stack([out.float().flatten(), ref.flatten()]))[0, 1].item()
    assert err <= 0.031 and corr >= 0.99999, (err, corr)
    assert torch.equal(out, again)
    assert attn_block.fused_attention_block.launches == before + 2


# (B, H, W, C, heads): the celebahq UNet's blocks, srn_cars', skytimelapse's
# (hd 64), and head dims the qkv GEMM zero-pads to an instance (8, 24, 48)
MODULE_BLOCK_SHAPES = [
    (8, 32, 32, 512, 16), (8, 16, 16, 1024, 32), (8, 8, 8, 2048, 64),
    (2, 8, 8, 512, 16), (2, 4, 4, 1024, 32),
    (2, 16, 16, 512, 8), (4, 8, 16, 512, 8), (2, 8, 8, 1024, 16), (4, 4, 8, 1024, 16),
    (2, 4, 4, 1536, 24), (4, 2, 4, 1536, 24),
    (2, 8, 8, 128, 16), (2, 4, 8, 384, 16), (1, 8, 8, 384, 8),
]


@pytest.mark.parametrize("B,H,W,C,nh", MODULE_BLOCK_SHAPES)
def test_attention_block_module_entry_matches_plain(cuda_device, B, H, W, C, nh):
    """The entry the UNet calls, on bf16 parameters in the module's layout
    (norm, head-major qkv Conv1d, proj Conv1d), against the fp32 plain
    version on the same values: the bars above, a bit-identical repeat and
    one launch per call."""
    rng = np.random.default_rng(B * C + nh + H * W)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device)
    bf = torch.bfloat16
    x = f(B, H, W, C).to(bf)
    nw, nb = (1.0 + 0.1 * f(C)).to(bf), (0.1 * f(C)).to(bf)
    wq, bq = (f(3 * C, C, 1) / C**0.5).to(bf), (0.1 * f(3 * C)).to(bf)
    wp, bp = (f(C, C, 1) / C**0.5).to(bf), (0.1 * f(C)).to(bf)
    s = (C // nh) ** -0.5
    before = attn_block.fused_attention_block.launches
    out = attn_block.attention_block(x, nw, nb, wq, bq, wp, bp, nh, s)
    again = attn_block.attention_block(x, nw, nb, wq, bq, wp, bp, nh, s)
    jq, jb, jp = attn_block.module_to_jax_layout(wq.float(), bq.float(), wp.float(), nh)
    ref = attn_block.attention_block_plain(x.float(), nw.float(), nb.float(), jq, jb, jp,
                                           bp.float(), nh, s)
    torch.cuda.synchronize()
    assert out.shape == x.shape and out.dtype == bf
    err = (out.float() - ref).abs().max().item()
    corr = torch.corrcoef(torch.stack([out.float().flatten(), ref.flatten()]))[0, 1].item()
    assert err <= 0.031 and corr >= 0.99999, (err, corr)
    assert torch.equal(out, again)
    assert attn_block.fused_attention_block.launches == before + 2


@pytest.mark.parametrize("H,W,C", [(16, 16, 512), (8, 16, 512), (8, 8, 1024),
                                   (4, 8, 1024), (4, 4, 1536), (2, 4, 1536)])
def test_attention_block_kernel_matches_plain_at_head_dim_64(cuda_device, H, W, C):
    """The triplane UNet's shapes (hd 64, n 256...8, so the 64-row q tile is
    ragged below 64): the same bars as at the celebahq shapes."""
    nh = C // 64
    x, gs, gb, wq, bq, wp, bp = _attn_args(3, 2, H, C, cuda_device, W)
    out = attn_block.fused_attention_block(x, gs, gb, wq, bq, wp, bp, nh, 64**-0.5)
    ref = attn_block.attention_block_plain(
        x.float(), gs, gb, wq.float(), bq, wp.float(), bp, nh, 64**-0.5
    )
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    corr = torch.corrcoef(torch.stack([out.float().flatten(), ref.flatten()]))[0, 1].item()
    assert err <= 0.031 and corr >= 0.99999, (err, corr)


def _qkv(seed, B, nh, n, hd, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, nh, n, hd), generator=g, device=dev).bfloat16() for _ in range(3)]


def _check_attention(out, ref):
    """bf16 kernel vs fp32 plain on the same bf16 inputs: max|err| <=
    0.02 * max|ref| (bf16 rounding of the probabilities and the output) and
    correlation >= 0.9999."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[0, 1].item()
    assert err <= 0.02 * ref.abs().max().item() and corr >= 0.9999, (err, corr)


# the (n, hd) of every mha_vmem call of the skytimelapse video path, as
# chip_smoke.py's video breakdown records them (batch 2, 16 heads)
MHA_VIDEO_SHAPES = [(32, 64), (32, 96), (128, 32), (128, 64), (128, 96), (512, 16), (512, 32),
                    (512, 64)]


@pytest.mark.parametrize("n,hd", MHA_VIDEO_SHAPES + [
    (8, 128), (1024, 128), (1000, 128), (8, 64), (32, 32), (1000, 48), (512, 8), (128, 24),
    (64, 40), (128, 48), (256, 96), (64, 112), (256, 100)])
def test_mha_vmem_kernel_matches_plain(cuda_device, n, hd):
    """On the flash core's instances (16, 32, 64, 128) at the video path's
    shapes, at head dims that TMA's zero fill pads to the next instance (8,
    24, 40, 48, 96, 112), at n from 8 to 1024, and at a head dim that is
    not a multiple of 8 (100), which the wrapper pads; a repeat is
    bit-identical and each call counts one launch."""
    q, k, v = _qkv(n + hd, 2, 16, n, hd, cuda_device)
    before = attention.mha_vmem.launches
    out = attention.mha_vmem(q, k, v, hd**-0.5)
    again = attention.mha_vmem(q, k, v, hd**-0.5)
    ref = attention.mha_plain(q, k, v, hd**-0.5)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
    _check_attention(out, ref)
    assert torch.equal(out, again)
    assert attention.mha_vmem.launches == before + 2


@pytest.mark.parametrize("hd", [96, 40])
def test_mha_vmem_runs_one_kernel_without_a_pad(cuda_device, hd):
    """At a head dim that is a multiple of 8 the call is one launch of the
    flash core and nothing else: no padded copies in, no slice out."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _qkv(7, 2, 16, 32, hd, cuda_device)
    attention.mha_vmem(q, k, v, hd**-0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        attention.mha_vmem(q, k, v, hd**-0.5)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    assert len(names) == 1 and "flash_fwd_kernel" in names[0], names


@pytest.mark.parametrize("B,nh,n,hd", [(2, 16, 2048, 16), (2, 16, 2048, 32),
                                       (2, 8, 5120, 32), (2, 8, 20480, 128),
                                       (1, 4, 4096 + 37, 64), (2, 4, 1000, 16), (1, 2, 1000, 128),
                                       (2, 4, 2048, 48), (1, 4, 1000, 96), (1, 2, 600, 8)])
def test_flash_attention_kernel_matches_plain(cuda_device, B, nh, n, hd):
    """The Hopper forward at each instance (hd 16, 32, 64, 128), at head
    dims the wrapper zero-pads (48, 96, 8) and at ragged n; a repeat is
    bit-identical."""
    q, k, v = _qkv(n + hd, B, nh, n, hd, cuda_device)
    before = flash_attention.flash_attention.launches
    out = flash_attention.flash_attention(q, k, v, hd**-0.5)
    again = flash_attention.flash_attention(q, k, v, hd**-0.5)
    ref = flash_attention.flash_plain(q, k, v, hd**-0.5)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
    _check_attention(out, ref)
    assert torch.equal(out, again)
    assert flash_attention.flash_attention.launches == before + 2


def test_attention_kernels_refuse_head_dims_without_an_instance(cuda_device):
    """Head dims up to 128 are zero-padded to an instance; above 128 there
    is none."""
    q = torch.zeros((1, 2, 64, 144), device=cuda_device, dtype=torch.bfloat16)
    for fn in (attention.mha_vmem, flash_attention.flash_attention):
        with pytest.raises(NotImplementedError):
            fn(q, q, q, 0.3)


def test_attention_block_kernel_refuses_unsupported_shape(cuda_device):
    x, gs, gb, wq, bq, wp, bp = _attn_args(2, 1, 6, 512, cuda_device)  # n = 36
    with pytest.raises(NotImplementedError):
        attn_block.fused_attention_block(x, gs, gb, wq, bq, wp, bp, 16, 32**-0.5)


def _inr_folded(dev, out_ch=3):
    """A celebahq-width INRImage (ch 256, latent 64) with seeded nonzero
    biases, folded at si 1."""
    torch.manual_seed(0)
    m = INRImage(MLPConfig(in_ch=2, out_ch=out_ch, ch=256, latent_dim=64)).to(dev)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias") and "modulation" not in name:
                p.copy_(0.1 * torch.randn_like(p))
    return inr_decode.fold_inr_image_params(m, 1.0)


def _inr_tokens(dev, N):
    """Three (N, 128) bf16 token sets: 64 latent + 2 coordinate columns, the
    rest zero, as render_tokens gives them."""
    g = torch.Generator(device=dev).manual_seed(N)
    toks = [torch.randn((N, 128), generator=g, device=dev).bfloat16() for _ in range(3)]
    for t in toks:
        t[:, 66:] = 0
    return toks


def _inr_check(out, ref):
    """bf16 kernel vs the plain version on the same bf16 operands (fp32
    sums in another order may flip a bf16 rounding between the 13
    products): mean|err| / mean|ref| < 0.02, the smoke's bar."""
    assert out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
    out, ref = out.float(), ref.float()
    assert ((out - ref).abs().mean() / ref.abs().mean()).item() < 0.02


@pytest.mark.parametrize("N", [8 * 256 * 256, 4096 * 128 - 37])
def test_inr_decode_kernel_matches_plain(cuda_device, N):
    """At the celebahq render's N (8 x 256^2 tokens, from render_tokens) and
    at a ragged N, whose last tile the kernel masks: against the plain
    version, a bit-identical repeat, one count per call."""
    folded = _inr_folded(cuda_device)
    if N == 8 * 256 * 256:
        planes = [torch.randn(8, 64, r, r, device=cuda_device).bfloat16() for r in (64, 128, 256)]
        toks = inr_decode.render_tokens(planes, 256, 1.0, 2)
    else:
        toks = _inr_tokens(cuda_device, N)
    before = inr_decode.inr_decode_fused.launches
    out = inr_decode.inr_decode_fused(folded, *toks, 0)
    again = inr_decode.inr_decode_fused(folded, *toks, 0)
    ref = inr_decode.inr_decode_plain(folded, *toks, 0)
    torch.cuda.synchronize()
    assert out.shape == (N, 3)
    _inr_check(out, ref)
    assert torch.equal(out, again)
    assert inr_decode.inr_decode_fused.launches == before + 2


@pytest.mark.parametrize("N", [8 * 256 * 256, 4096 * 128 - 37, 37])
def test_inr_decode_noise_matches_plain_on_the_kernel_draws(cuda_device, N):
    """With noise gains: the kernel against the plain version fed the
    kernel's own Philox draws (philox_normal), a bit-identical repeat of a
    seed, and another seed that differs."""
    folded = _inr_folded(cuda_device)
    with torch.no_grad():
        folded.noise_w.copy_(torch.linspace(0.1, 0.6, 12, device=cuda_device))
    folded.has_noise = True
    toks = _inr_tokens(cuda_device, N)
    a = inr_decode.inr_decode_fused(folded, *toks, 5)
    b = inr_decode.inr_decode_fused(folded, *toks, 5)
    c = inr_decode.inr_decode_fused(folded, *toks, 6)
    draws = inr_decode.philox_normal(5, N, device=cuda_device)
    ref = inr_decode.inr_decode_plain(folded, *toks, 5, noise=draws)
    torch.cuda.synchronize()
    _inr_check(a, ref)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the plain version's default noise is the same draws
    assert torch.equal(ref, inr_decode.inr_decode_plain(folded, *toks, 5))


def test_inr_decode_kernel_takes_other_out_ch(cuda_device):
    """out_ch 16, the most the kernel takes (its ToRGB columns in shared
    memory leave a 3-stage ring)."""
    folded = _inr_folded(cuda_device, out_ch=16)
    toks = _inr_tokens(cuda_device, 1000)
    out = inr_decode.inr_decode_fused(folded, *toks, 0)
    ref = inr_decode.inr_decode_plain(folded, *toks, 0)
    torch.cuda.synchronize()
    _inr_check(out, ref)


def test_inr_decode_kernel_refuses_what_it_does_not_take(cuda_device):
    folded = _inr_folded(cuda_device)
    toks = _inr_tokens(cuda_device, 256)
    with pytest.raises(ValueError):  # token width other than 128
        inr_decode.inr_decode_fused(folded, *(t[:, :64].contiguous() for t in toks), 0)
    with pytest.raises(ValueError):  # not contiguous
        inr_decode.inr_decode_fused(folded, toks[0].t().contiguous().t(), *toks[1:], 0)
    with pytest.raises(ValueError):  # not bf16
        inr_decode.inr_decode_fused(folded, toks[0].float(), *toks[1:], 0)
    with pytest.raises(ValueError):  # not on a 16-byte boundary: no TMA source
        flat = torch.zeros(256 * 128 + 1, device=cuda_device, dtype=torch.bfloat16)
        inr_decode.inr_decode_fused(folded, flat[1:].view(256, 128), *toks[1:], 0)
    with pytest.raises(ValueError):  # no tokens
        inr_decode.inr_decode_fused(folded, *(t[:0] for t in toks), 0)
    wide = _inr_folded(cuda_device, out_ch=3)
    wide.out_ch = 17
    with pytest.raises(ValueError):  # more output channels than ToRGB's 16
        inr_decode.inr_decode_fused(wide, *toks, 0)


def _nerf_mlp(dev, width=256, in_xyz=159, in_dir=27):
    """The srn_cars NeRF MLP (D 6, skips 2 and 4, xyz 159, dir 27) with
    seeded weights and nonzero biases."""
    torch.manual_seed(0)
    m = INRNeRF(6, width, in_xyz, in_dir, (2, 4)).to(dev)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn_like(p))
    return m


@pytest.mark.parametrize("N", [300, 1_048_576, 1_048_576 - 37, 64])
def test_nerf_mlp_kernel_matches_plain(cuda_device, N):
    """The kernel vs its plain version on the same bf16 operands (fp32 sums
    in another order, so a bf16 rounding of h may flip): rgb max|err| <=
    0.005, sigma <= 0.01 * max(1, max|sigma|), at ragged N (a last 128-point
    tile part full, one warpgroup's rows all past N) and at the render's
    4096 rays x 256 samples; a repeat is bit-identical, one launch a call."""
    folded = nerf_mlp.fold_nerf_params(_nerf_mlp(cuda_device))
    g = torch.Generator(device=cuda_device).manual_seed(N)
    x = torch.randn((N, 186), generator=g, device=cuda_device).bfloat16()
    before = nerf_mlp.nerf_mlp_fused.launches
    out = nerf_mlp.nerf_mlp_fused(folded, x)
    again = nerf_mlp.nerf_mlp_fused(folded, x)
    ref = nerf_mlp.nerf_mlp_plain(folded, x)
    torch.cuda.synchronize()
    assert out.shape == (N, 4) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert (out[:, :3] - ref[:, :3]).abs().max().item() <= 0.005
    sig_tol = 0.01 * max(1.0, ref[:, 3].abs().max().item())
    assert (out[:, 3] - ref[:, 3]).abs().max().item() <= sig_tol
    assert torch.equal(out, again)
    assert nerf_mlp.nerf_mlp_fused.launches == before + 2


@pytest.mark.parametrize("in_xyz, in_dir", [(51, 69), (160, 69), (320, 150), (447, 64)])
def test_nerf_mlp_kernel_takes_other_input_widths(cuda_device, in_xyz, in_dir):
    """Input widths other than srn_cars': a dir input of two and three
    panels, an odd in_xyz + in_dir (229, 511: the wrapper pads the odd side
    with a zero column) and the most panels the kernel takes (8, a 2-stage
    ring), at a ragged N, within the bars of the srn_cars test."""
    assert nerf_mlp.kernel_supported(256, in_xyz, in_dir)
    folded = nerf_mlp.fold_nerf_params(_nerf_mlp(cuda_device, 256, in_xyz, in_dir))
    N = 3 * 128 + 41
    g = torch.Generator(device=cuda_device).manual_seed(in_xyz)
    x = torch.randn((N, in_xyz + in_dir), generator=g, device=cuda_device).bfloat16()
    out = nerf_mlp.nerf_mlp_fused(folded, x)
    again = nerf_mlp.nerf_mlp_fused(folded, x)
    ref = nerf_mlp.nerf_mlp_plain(folded, x)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out[:, :3] - ref[:, :3]).abs().max().item() <= 0.005
    sig_tol = 0.01 * max(1.0, ref[:, 3].abs().max().item())
    assert (out[:, 3] - ref[:, 3]).abs().max().item() <= sig_tol
    assert torch.equal(out, again)


def test_nerf_mlp_kernel_refuses_what_it_does_not_take(cuda_device):
    folded = nerf_mlp.fold_nerf_params(_nerf_mlp(cuda_device))
    x = torch.zeros((64, 186), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        nerf_mlp.nerf_mlp_fused(dataclasses.replace(folded, width=128), x)
    with pytest.raises(NotImplementedError):
        nerf_mlp.fold_nerf_params(_nerf_mlp(cuda_device, width=128))
    with pytest.raises(ValueError):
        nerf_mlp.nerf_mlp_fused(folded, x.float())
    with pytest.raises(ValueError):
        nerf_mlp.nerf_mlp_fused(folded, x[:, :100])
    wide = nerf_mlp.fold_nerf_params(_nerf_mlp(cuda_device, 256, 512, 27))  # 9 panels
    with pytest.raises(NotImplementedError):
        nerf_mlp.nerf_mlp_fused(wide, torch.zeros((64, 539), device=cuda_device,
                                                  dtype=torch.bfloat16))


def test_nerf_render_goes_through_the_kernel(cuda_device):
    """A bf16 NeRF pipeline at MLP width 256 renders a 128^2 view in 4096-ray
    chunks: exactly 4 kernel launches, finite pixels."""
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline, spherical_poses

    cfg = config_from_dict({"model": {"embed_dim": 4, "params": {
        "unetconfig": dict(in_channels=12, model_channels=32, out_channels=12,
                           attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
                           num_head_channels=16),
        "ddconfig": dict(z_channels=16, resolution=16, out_ch=8, ch=32, ch_mult=[1, 2],
                         num_res_blocks=1, hdbf_resolutions=[], inter_attn_resolutions=[16]),
        "mlpconfig": dict(D=6, W=256, skips=[2, 4], N_samples=32),
        "ddpmconfig": dict(timesteps=20, channels=12, sampling_timesteps=2)}},
        "data": {"domain": "nerf"}})
    pipe = NeRFPipeline(cfg, device=cuda_device).cast(torch.bfloat16)
    z = torch.randn((1, 12, 8, 8), device=cuda_device)
    with torch.inference_mode():
        planes = pipe.decode_planes(z)
        before = nerf_mlp.nerf_mlp_fused.launches
        img = pipe.render_image(planes, spherical_poses(1, device=cuda_device)[0], 128, 128)
    torch.cuda.synchronize()
    assert nerf_mlp.nerf_mlp_fused.launches == before + 4
    assert img.shape == (128, 128, 3) and torch.isfinite(img).all()


@pytest.mark.parametrize("B,nh,n,hd", [(5, 16, 1024, 32), (1, 2, 1000, 64), (2, 4, 2048, 16),
                                       (1, 2, 4096 + 37, 128), (1, 2, 1000, 48),
                                       (1, 2, 1000, 96)])
def test_flash_backward_kernel_matches_plain(cuda_device, B, nh, n, hd):
    """The backward kernels vs flash_bwd_plain (fp32, from the same bf16
    operands and the kernel forward's LSE): dq, dk, dv each within
    max|err| <= 0.03 * max|ref| and correlation >= 0.999 (bf16 rounding of
    p and ds before their products, bf16 outputs), at each instance, at
    zero-padded head dims (48, 96) and at ragged n; a repeat is
    bit-identical (no atomics); one count per call."""
    q, k, v, do = _qkv(n + hd, B, nh, n, hd, cuda_device) + _qkv(7, B, nh, n, hd, cuda_device)[:1]
    s = hd**-0.5
    out, lse = flash_attention.flash_attention_fwd(q, k, v, s, with_lse=True)
    before = flash_attention.flash_attention_bwd.launches
    got = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, s)
    ref = flash_attention.flash_bwd_plain(q, k, v, out, lse, do, s)
    again = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, s)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        a, r = a.float(), r.float()
        corr = torch.corrcoef(torch.stack([a.flatten(), r.flatten()]))[0, 1].item()
        assert (a - r).abs().max().item() <= 0.03 * r.abs().max().item() and corr >= 0.999
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert flash_attention.flash_attention_bwd.launches == before + 2


@pytest.mark.parametrize("n,hd", [(1000, 32), (1000, 16), (4096 + 37, 64), (1000, 128),
                                  (1000, 48)])
def test_flash_forward_lse_matches_logsumexp(cuda_device, n, hd):
    """The LSE entry's row statistics (natural log) vs torch.logsumexp of
    the fp32 scaled scores (within 1e-4), a repeat bit-identical, and its
    output equal to the plain entry's."""
    q, k, v = _qkv(3, 2, 4, n, hd, cuda_device)
    s = hd**-0.5
    out, lse = flash_attention.flash_attention_fwd(q, k, v, s, with_lse=True)
    _, lse_again = flash_attention.flash_attention_fwd(q, k, v, s, with_lse=True)
    plain_out, none = flash_attention.flash_attention_fwd(q, k, v, s, with_lse=False)
    ref = torch.logsumexp((q.float() @ k.float().transpose(-1, -2)) * s, dim=-1)
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, plain_out) and torch.equal(lse, lse_again)
    assert (lse - ref).abs().max().item() <= 1e-4


def test_flash_attention_function_on_the_card(cuda_device):
    """flash_attention under autograd launches the LSE forward and the
    backward kernels once each; its gradients are the backward kernels'."""
    q, k, v = (t.requires_grad_() for t in _qkv(11, 2, 4, 512, 32, cuda_device))
    do = _qkv(12, 2, 4, 512, 32, cuda_device)[0]
    f0, b0 = flash_attention.flash_attention.launches, flash_attention.flash_attention_bwd.launches
    out = flash_attention.flash_attention(q, k, v, 32**-0.5)
    out.backward(do)
    assert flash_attention.flash_attention.launches == f0 + 1
    assert flash_attention.flash_attention_bwd.launches == b0 + 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    _, lse = flash_attention.flash_attention_fwd(qd, kd, vd, 32**-0.5, with_lse=True)
    ref = flash_attention.flash_attention_bwd(qd, kd, vd, out.detach(), lse, do, 32**-0.5)
    for t, r in zip((q, k, v), ref):
        assert torch.equal(t.grad, r)


def _plain_grads(plain, args, n_tensors, dout):
    xs = [a.detach().clone().requires_grad_() for a in args[:n_tensors]]
    plain(*xs, *args[n_tensors:]).backward(dout)
    return [x.grad for x in xs]


def test_inference_kernels_backward_through_their_plain_versions(cuda_device):
    """The fused block's and mha_vmem's Functions under autograd: the
    forward is the kernel (one launch each) and the gradients are exactly
    those of their plain versions on the same inputs."""
    x, gs, gb, wq, bq, wp, bp = _attn_args(5, 2, 16, 512, cuda_device)
    args = [x, gs, gb, wq, bq, wp, bp, 16, 32**-0.5, 32, 1e-5]
    leaves = [a.detach().clone().requires_grad_() for a in args[:7]]
    before = attn_block.fused_attention_block.launches
    out = attn_block.fused_attention_block(*leaves, *args[7:])
    dout = torch.randn_like(out)
    out.backward(dout)
    assert attn_block.fused_attention_block.launches == before + 1
    ref = _plain_grads(attn_block.attention_block_plain, args, 7, dout)
    for leaf, r in zip(leaves, ref):
        assert torch.equal(leaf.grad, r)

    q, k, v = _qkv(9, 2, 8, 256, 64, cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = attention.mha_vmem.launches
    out = attention.mha_vmem(*leaves, 0.125)
    dout = torch.randn_like(out)
    out.backward(dout)
    assert attention.mha_vmem.launches == before + 1
    for leaf, r in zip(leaves, _plain_grads(attention.mha_plain, [q, k, v, 0.125], 3, dout)):
        assert torch.equal(leaf.grad, r)


def test_render_kernels_refuse_inputs_that_need_grad(cuda_device):
    """inr_decode and nerf_mlp have no backward (nor have the JAX kernels):
    with autograd recording they raise instead of returning a tensor
    without a gradient."""
    folded = nerf_mlp.fold_nerf_params(_nerf_mlp(cuda_device))
    x = torch.zeros((64, 186), device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        nerf_mlp.nerf_mlp_fused(folded, x)
    m = INRImage(MLPConfig(in_ch=2, out_ch=3, ch=256, latent_dim=64)).to(cuda_device)
    planes = [torch.randn(1, 64, r, r, device=cuda_device).bfloat16() for r in (4, 8, 16)]
    folded = inr_decode.fold_inr_image_params(m, 1.0)
    toks = [t.requires_grad_() for t in inr_decode.render_tokens(planes, 16, 1.0, 2)]
    with pytest.raises(RuntimeError, match="no gradient"):
        inr_decode.inr_decode_fused(folded, *toks, 0)


def test_unet_attention_gradients_on_the_card_match_the_cpu(cuda_device):
    """A tiny UNet (attention at n = 1024 through flash, at n = 256 dense)
    trained one step's worth: the gradients of the attention blocks'
    parameters under the bf16 policy on the card (flash forward and backward
    kernels for the three 32 x 32 blocks) against fp32 on the CPU, within 5% relative
    (L2) per tensor and cosine >= 0.998 (bf16 compute)."""
    from ddmi_tpu_torch.core.amp import amp_denoiser
    from ddmi_tpu_torch.nn.unet import UNet

    cfg = config_from_dict({"model": {"params": {"unetconfig": dict(
        image_size=32, in_channels=4, model_channels=64, out_channels=4,
        attention_resolutions=[1, 2], num_res_blocks=1, channel_mult=[1, 2],
        num_head_channels=32)}}}).model.unetconfig
    torch.manual_seed(0)
    cpu = UNet(cfg)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in cpu.parameters():
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    gpu = UNet(cfg).to(cuda_device).to(memory_format=torch.channels_last)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 4, 32, 32), generator=g)
    w = torch.randn((2, 4, 32, 32), generator=g)
    t = torch.tensor([10, 700])
    (cpu(x, t) * w).mean().backward()
    f0, b0 = flash_attention.flash_attention.launches, flash_attention.flash_attention_bwd.launches
    out = amp_denoiser(gpu, True)(x.to(cuda_device), t.to(cuda_device))
    (out * w.to(cuda_device)).mean().backward()
    torch.cuda.synchronize()
    # the 32 x 32 blocks: one on the way down, two on the way up
    assert flash_attention.flash_attention.launches == f0 + 3
    assert flash_attention.flash_attention_bwd.launches == b0 + 3
    got = dict(gpu.named_parameters())
    checked = 0
    for name, p in cpu.named_parameters():
        if ".qkv." not in name and ".proj_out." not in name and ".norm." not in name:
            continue
        a, r = got[name].grad.float().cpu().flatten(), p.grad.flatten()
        cos = torch.nn.functional.cosine_similarity(a, r, dim=0).item()
        assert (a - r).norm() <= 0.05 * r.norm() and cos >= 0.998, (name, cos)
        checked += 1
    assert checked >= 12


def test_nerf_render_under_autograd_runs_the_module(cuda_device):
    """With a gradient recorded the NeRF pipeline renders through the INRNeRF
    module, not the fused MLP (whose fold drops the weights' gradients): no
    kernel launch, and the gradients reach the MLP."""
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline, get_rays, spherical_poses

    cfg = config_from_dict({"model": {"embed_dim": 4, "params": {
        "unetconfig": dict(in_channels=12, model_channels=32, out_channels=12,
                           attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
                           num_head_channels=16),
        "ddconfig": dict(z_channels=16, resolution=16, out_ch=8, ch=32, ch_mult=[1, 2],
                         num_res_blocks=1, hdbf_resolutions=[], inter_attn_resolutions=[16]),
        "mlpconfig": dict(D=6, W=256, skips=[2, 4], N_samples=16),
        "ddpmconfig": dict(timesteps=20, channels=12, sampling_timesteps=2)}},
        "data": {"domain": "nerf"}})
    pipe = NeRFPipeline(cfg, device=cuda_device).cast(torch.bfloat16)
    with torch.no_grad():
        planes = pipe.decode_planes(torch.randn((1, 12, 8, 8), device=cuda_device))
    ro, rd = (a.reshape(-1, 3) for a in get_rays(8, 8, spherical_poses(1, device=cuda_device)[0]))
    before = nerf_mlp.nerf_mlp_fused.launches
    rgb = pipe.render_rays(planes, ro, rd)
    rgb.square().sum().backward()
    assert nerf_mlp.nerf_mlp_fused.launches == before
    assert rgb.grad_fn is not None
    assert all(p.grad is not None for p in pipe.mlp.parameters())


# ------------------------------------------------------------- occupancy


OCC_CFG = {"model": {"embed_dim": 4,
                     "pointnet": {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 32,
                                  "n_blocks": 3},
                     "params": {
    "unetconfig": dict(in_channels=12, model_channels=64, out_channels=12,
                       attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
                       num_head_channels=32),
    "ddconfig": dict(z_channels=16, resolution=32, in_channels=8, out_ch=16, ch=32,
                     ch_mult=[1, 2, 2], num_res_blocks=1, hdbf_resolutions=[8, 16],
                     inter_attn_resolutions=[32, 16, 8]),
    "mlpconfig": dict(in_ch=3, out_ch=1, ch=64, latent_dim=16),
    "ddpmconfig": dict(timesteps=20, channels=12, sampling_timesteps=3)}},
    "data": {"domain": "occupancy"}}


def _occ_pair(dev):
    """An fp32 occupancy pipeline on the CPU and the same weights on `dev`,
    with INR3D's output bias set so that the decoded field of a random
    latent crosses the threshold."""
    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline

    cpu = OccupancyPipeline(config_from_dict(OCC_CFG), device="cpu", seed=3)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if not p.any() and name != "mixing_logit":
                p.copy_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(7)))
    gpu = OccupancyPipeline(config_from_dict(OCC_CFG), device=dev, seed=3)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def test_geometry_library_builds_under_build_geometry(cuda_device):
    """The port's own C++ geometry library builds with g++ from
    ddmi_tpu_torch/geometry/src into build/geometry/ and extracts a sphere."""
    from ddmi_tpu_torch import geometry

    path = geometry.build()
    assert path.parent.name == "geometry" and path.parent.parent.name == "build"
    assert path.exists() and geometry.SRC.parent.name == "src"
    lin = np.linspace(-1, 1, 24)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    v, f = geometry.marching_cubes(0.7 - np.sqrt(x**2 + y**2 + z**2), 0.0)
    r = np.linalg.norm(v / 23 * 2 - 1, axis=1)
    assert len(f) > 500 and abs(r.mean() - 0.7) < 0.01


def test_inr3d_and_pointnet_on_the_card_match_the_cpu(cuda_device):
    """fp32 on the card against the CPU within 1e-4 * max(1, max|ref|) (TF32
    off); INR3D under bf16 parameters returns fp32 logits."""
    cpu, gpu = _occ_pair(cuda_device)
    rng = np.random.default_rng(1)
    cloud = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 3000, 3)).astype(np.float32))
    with torch.no_grad():
        ref, got = cpu.pointnet(cloud), gpu.pointnet(cloud.to(cuda_device))
        for k in ("xz", "xy", "yz"):
            tol = 1e-4 * max(1.0, ref[k].abs().max().item())
            assert (got[k].cpu() - ref[k]).abs().max().item() <= tol, k
        z = torch.from_numpy(rng.standard_normal((2, 12, 8, 8)).astype(np.float32))
        pyr_c, pyr_g = cpu.decode_pyramids(z), gpu.decode_pyramids(z)
        pts = torch.from_numpy(rng.uniform(-0.55, 0.55, (2, 5000, 3)).astype(np.float32))
        ref = cpu.logits_from_pyramids(pts, pyr_c)
        got = gpu.logits_from_pyramids(pts.to(cuda_device), pyr_g).cpu()
        assert (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
        gpu.cast(torch.bfloat16)
        bf = gpu.logits_from_pyramids(pts.to(cuda_device), gpu.decode_pyramids(z))
    assert bf.dtype == torch.float32
    assert ((bf.cpu() - ref).abs().mean() / ref.abs().mean()).item() < 0.02


def test_refinement_double_backward_on_the_card_matches_the_cpu(cuda_device):
    """The refinement loss's vertex gradient, whose normal term
    differentiates INR3D's gradient (F.grid_sample's double backward), on
    the card against the CPU on the same Dirichlet draws: within 1e-3 *
    max(1, max|ref|) (the backward's atomic sums run in another order)."""
    from ddmi_tpu_torch.geometry.generation import MeshGenerator, refinement_loss

    cpu, gpu = _occ_pair(cuda_device)
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 12, 8, 8)).astype(
        np.float32))
    pyr_c, pyr_g = cpu.decode_pyramids(z), gpu.decode_pyramids(z)
    sphere = lambda p: 20.0 * (0.35 - torch.linalg.norm(p, dim=-1))
    verts, tris = MeshGenerator(sphere, threshold=0.5, resolution0=16,
                                upsampling_steps=0).generate()
    eps = torch._sample_dirichlet(torch.full((len(tris), 3), 0.5),
                                  generator=torch.Generator().manual_seed(0))
    grads = []
    for pipe, pyr, dev in ((cpu, pyr_c, "cpu"), (gpu, pyr_g, cuda_device)):
        v = torch.tensor(verts, dtype=torch.float32, device=dev, requires_grad=True)
        loss = refinement_loss(v, torch.from_numpy(tris).to(dev), eps.to(dev),
                               lambda p: pipe.logits_from_pyramids(p, pyr), 0.2, 0.01)
        grads.append(torch.autograd.grad(loss, v)[0].cpu())
    ref, got = grads
    assert ref.abs().max() > 0
    assert (got - ref).abs().max().item() <= 1e-3 * max(1.0, ref.abs().max().item())


def test_occupancy_service_counts_attn_block_exactly(cuda_device):
    """A small occupancy service on the card (bf16, NFE 3): one batch of 2
    goes through the fused attention block exactly (blocks per forward) x
    NFE times, no other kernel launches, and the meshes are finite, inside
    the box and bit-identical on a repeat of the seed."""
    from ddmi_tpu_torch.nn.unet import AttentionBlock
    from ddmi_tpu_torch.serve.server import SamplerService

    svc = SamplerService(config_from_dict(OCC_CFG), service_batch=2, linger_ms=0,
                         device=cuda_device, allow_init=True,
                         mesh_kwargs=dict(resolution0=16, upsampling_steps=1,
                                          points_batch_size=4096, workers=2))
    blocks = sum(isinstance(m, AttentionBlock) for m in svc.pipe.unet.modules())
    kernels = (attention.mha_vmem, flash_attention.flash_attention, inr_decode.inr_decode_fused,
               nerf_mlp.nerf_mlp_fused, flash_attention.flash_attention_bwd)
    before = [k.launches for k in kernels]
    b0 = attn_block.fused_attention_block.launches
    try:
        first = svc.generate(2, seed=5)
        again = svc.generate(2, seed=5)
    finally:
        svc.close()
    assert blocks == 4 and attn_block.fused_attention_block.launches - b0 == 2 * blocks * 3
    assert [k.launches for k in kernels] == before
    for (v, f), (v2, f2) in zip(first, again):
        assert np.isfinite(v).all() and (np.abs(v) <= 0.55 + 1e-4).all()
        assert np.array_equal(v, v2) and np.array_equal(f, f2)


def _stage1_cfg(amp, mlp_ch=64):
    return config_from_dict({"model": {"amp": amp, "lr": 1e-3, "embed_dim": 4, "params": {
        "lossconfig": dict(gradient_accumulate_every=1, epochs=2, warmup_epochs=1),
        "ddconfig": dict(z_channels=8, resolution=64, out_ch=16, ch=64, ch_mult=[1, 1, 2],
                         num_res_blocks=1, hdbf_resolutions=[16, 32]),
        "mlpconfig": dict(ch=mlp_ch, latent_dim=16),
        "unetconfig": dict(image_size=16, in_channels=4, model_channels=32, out_channels=4,
                           attention_resolutions=[], num_res_blocks=1, channel_mult=[1])}},
        "data": {"domain": "image"}})


def test_stage1_micro_step_on_the_card_matches_the_cpu(cuda_device):
    """One stage-1 loss and its gradients (multiscale, VAE, the INR at the
    crop's coordinates, KL, LPIPS on a random VGG, the SN regulariser) at a
    64^2 anchor: bf16 on the card against fp32 on the CPU, on the same
    weights, SN vectors and draws: the loss within 2%, each term within 5%,
    the gradient cosine >= 0.999, and no kernel launched (stage 1 trains
    through plain layers)."""
    from ddmi_tpu_torch.domains.image import ImagePipeline, Stage1Draws
    from ddmi_tpu_torch.evals.lpips import LPIPS

    torch.manual_seed(0)
    lp = LPIPS()
    pipes = {}
    for dev, amp in (("cpu", False), (cuda_device, True)):
        p = ImagePipeline(_stage1_cfg(amp), device=dev, seed=3,
                          perceptual=LPIPS(torch.bfloat16 if amp else torch.float32))
        p.perceptual.load_state_dict(lp.state_dict())
        p.perceptual.to(dev)
        pipes[dev] = p
    cpu, gpu = pipes["cpu"], pipes[cuda_device]
    gpu.load_state_dicts(vae=cpu.vae.state_dict(), mlp=cpu.mlp.state_dict())
    sc, sg = cpu.init_stage1(10), gpu.init_stage1(10)
    sg.sn = {k: (u.to(cuda_device), v.to(cuda_device)) for k, (u, v) in sc.sn.items()}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 128, 128, 3)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    noise = [torch.from_numpy(rng.standard_normal((2, 64 * 64, 1)).astype(np.float32))
             for _ in range(12)]
    counts = [k.launches for k in (attn_block.fused_attention_block, inr_decode.inr_decode_fused,
                                   flash_attention.flash_attention, attention.mha_vmem)]
    out = {}
    for dev, pipe, st in (("cpu", cpu, sc), ("cuda", gpu, sg)):
        draws = Stage1Draws((0.7, 5, 20, 0, 0), eps.to(pipe.device), iter(noise))
        loss, m, _, _ = pipe.stage1_loss(x.to(pipe.device), 3, draws, st.sn)
        loss.backward()
        g = torch.cat([p.grad.float().cpu().flatten() for p in st.params.values()])
        out[dev] = (loss.item(), {k: float(v) for k, v in m.items()}, g)
    assert counts == [k.launches for k in (attn_block.fused_attention_block,
                                           inr_decode.inr_decode_fused,
                                           flash_attention.flash_attention, attention.mha_vmem)]
    (lc, mc, gc), (lg, mg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 0.02 * abs(lc), (lg, lc)
    for k in ("recon", "kl", "lpips", "sn"):
        assert abs(mg[k] - mc[k]) <= 0.05 * abs(mc[k]), (k, mg[k], mc[k])
    cos = torch.nn.functional.cosine_similarity(gg, gc, dim=0).item()
    assert cos >= 0.999, cos


@pytest.mark.parametrize("res", [64, 96])
def test_reconstruct_runs_the_inr_decode_kernel(cuda_device, res):
    """ImagePipeline.reconstruct on the card (bf16 VAE, the render through
    inr_decode, whose INR is 256 wide: one launch per call) against the same
    pipeline on the CPU in fp32 through the kernel's plain version: mean
    |pixel error| <= 0.02 (the kernels' bf16 bar), pixels in [0, 1]."""
    from ddmi_tpu_torch.domains.image import ImagePipeline

    cpu = ImagePipeline(_stage1_cfg(False, 256), device="cpu", seed=4)
    gpu = ImagePipeline(_stage1_cfg(True, 256), device=cuda_device, seed=4)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).random((3, 128, 128, 3)).astype(np.float32))
    eps = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 4, 16, 16))
                           .astype(np.float32))
    ref = cpu.reconstruct(x, res, eps=eps, render_seed=5)
    before = inr_decode.inr_decode_fused.launches
    got = gpu.reconstruct(x.to(cuda_device), res, eps=eps.to(cuda_device), render_seed=5)
    torch.cuda.synchronize()
    assert inr_decode.inr_decode_fused.launches == before + 1
    assert got.shape == (3, res, res, 3) and torch.isfinite(got).all()
    assert 0.0 <= got.min().item() and got.max().item() <= 1.0
    err = (got.cpu() - ref).abs().mean().item()
    assert err <= 0.02, err
