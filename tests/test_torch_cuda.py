"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from ddmi_tpu_torch.core.config import MLPConfig
from ddmi_tpu_torch.nn.inr import INRImage
from ddmi_tpu_torch.ops import attention, attn_block, flash_attention, inr_decode

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
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    corr = torch.corrcoef(torch.stack([out.float().flatten(), ref.flatten()]))[0, 1].item()
    assert err <= 0.031 and corr >= 0.99999, (err, corr)
    assert attn_block.fused_attention_block.launches == before + 1


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


@pytest.mark.parametrize("n,hd", [(512, 16), (512, 32), (512, 64), (128, 32), (128, 64),
                                  (128, 96), (32, 64), (32, 96), (8, 128), (1024, 128)])
def test_mha_vmem_kernel_matches_plain(cuda_device, n, hd):
    q, k, v = _qkv(n + hd, 2, 16, n, hd, cuda_device)
    before = attention.mha_vmem.launches
    out = attention.mha_vmem(q, k, v, hd**-0.5)
    ref = attention.mha_plain(q, k, v, hd**-0.5)
    torch.cuda.synchronize()
    _check_attention(out, ref)
    assert attention.mha_vmem.launches == before + 1


@pytest.mark.parametrize("B,nh,n,hd", [(2, 16, 2048, 16), (2, 16, 2048, 32),
                                       (2, 8, 5120, 32), (2, 8, 20480, 128)])
def test_flash_attention_kernel_matches_plain(cuda_device, B, nh, n, hd):
    q, k, v = _qkv(n + hd, B, nh, n, hd, cuda_device)
    before = flash_attention.flash_attention.launches
    out = flash_attention.flash_attention(q, k, v, hd**-0.5)
    ref = flash_attention.flash_plain(q, k, v, hd**-0.5)
    torch.cuda.synchronize()
    _check_attention(out, ref)
    assert flash_attention.flash_attention.launches == before + 1


def test_attention_kernels_refuse_head_dims_without_an_instance(cuda_device):
    q = torch.zeros((1, 2, 64, 8), device=cuda_device, dtype=torch.bfloat16)
    for fn in (attention.mha_vmem, flash_attention.flash_attention):
        with pytest.raises(NotImplementedError):
            fn(q, q, q, 0.3)


def test_attention_block_kernel_refuses_unsupported_shape(cuda_device):
    x, gs, gb, wq, bq, wp, bp = _attn_args(2, 1, 6, 512, cuda_device)  # n = 36
    with pytest.raises(NotImplementedError):
        attn_block.fused_attention_block(x, gs, gb, wq, bq, wp, bp, 16, 32**-0.5)


def test_inr_decode_kernel_matches_plain(cuda_device):
    """bf16 kernel vs the plain version (same bf16 operands, fp32 sums):
    mean|err| / mean|ref| < 0.02.  With noise: finite, the same seed gives
    the same output and another seed another."""
    torch.manual_seed(0)
    m = INRImage(MLPConfig(in_ch=2, out_ch=3, ch=256, latent_dim=64)).to(cuda_device)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias") and "modulation" not in name:
                p.copy_(0.1 * torch.randn_like(p))
    planes = [torch.randn(2, 64, r, r, device=cuda_device).bfloat16() for r in (16, 32, 64)]
    folded = inr_decode.fold_inr_image_params(m, 1.0)
    toks = inr_decode.render_tokens(planes, 64, 1.0, 2)
    out = inr_decode.inr_decode_fused(folded, *toks, 0).float()
    ref = inr_decode.inr_decode_plain(folded, *toks, 0).float()
    assert ((out - ref).abs().mean() / ref.abs().mean()).item() < 0.02
    with torch.no_grad():
        folded.noise_w.fill_(0.3)
    folded.has_noise = True
    a = inr_decode.inr_decode_fused(folded, *toks, 5)
    b = inr_decode.inr_decode_fused(folded, *toks, 5)
    c = inr_decode.inr_decode_fused(folded, *toks, 6)
    assert torch.isfinite(a.float()).all() and torch.equal(a, b) and not torch.equal(a, c)
