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
from ddmi_tpu_torch.ops import attn_block, inr_decode

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _attn_args(seed, B, H, C, dev):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    return (f(B, H, H, C).bfloat16(), 1.0 + 0.1 * f(C), 0.1 * f(C),
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
