"""1D attention blocks over cross-plane token sequences (counterpart of
ddmi_tpu/nn/attention1d.py).

Tokens are (b, n, c).  State keys follow the reference's
MemoryEfficientAttnBlock1D[_expand]: `norm` (GroupNorm(32), eps 1e-6) and
the 1x1 Conv1d projections `q`, `k`, `v`, `proj_out`, applied here as linear
maps over the channel axis.  Channels split into heads head-major, as in the
reference and the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.core import graphs
from ddmi_tpu_torch.ops import attention, flash_attention, mea


# ddmi_tpu/nn/attention1d.py's training cap on flash (DDMI_FLASH_TRAIN_MAX
# there): with a gradient recorded, longer sequences take the MEA path
FLASH_TRAIN_MAX_TOKENS = 32768


def tiered_attention(q, k, v) -> torch.Tensor:
    """Attention over (B, nh, n, hd) through the JAX package's tiers, in its
    order: mha_vmem (n % 8 == 0, n <= 1024, hd <= 128) when no gradient is
    recorded (JAX: inference traces only), then flash (n >= 512,
    n % min(n, 1024) == 0, hd in {16, 32, 64, 128}; with a gradient only up
    to FLASH_TRAIN_MAX_TOKENS), then the chunked MEA path.  On a CUDA
    tensor the first two launch the port's kernels, on a CPU tensor they
    run their plain versions (the JAX package on the CPU takes MEA for all
    three, which computes the same exact attention)."""
    n, hd = q.shape[-2], q.shape[-1]
    inference = not torch.is_grad_enabled()
    if inference and attention.supported(n, hd):
        return attention.mha_vmem(q, k, v, hd**-0.5)
    if flash_attention.supported(n, hd) and (inference or n <= FLASH_TRAIN_MAX_TOKENS):
        return flash_attention.flash_attention(q, k, v, hd**-0.5)
    return mea.attention(q, k, v)


def _attention(q, k, v, out=None):
    """`tiered_attention`, copied into `out` where given: through
    `graphs.eager`, the kernel call is a cut of a captured forward's graphs
    (core/graphs.py::Segments; the TriplaneUNet's)."""
    a = tiered_attention(q, k, v)
    return a if out is None else out.copy_(a)


def _linear(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class AttnBlock1D(nn.Module):
    """x + proj_out(MHA(q, k, v of GN(x))) over (b, n, c) tokens.  With
    `expand`, q/k/v project c -> c * num_heads so every head sees the full
    width (head dim = c), and proj_out projects back (the video decoder's
    cross-plane attention)."""

    def __init__(self, channels: int, num_heads: int = 16, expand: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = channels if expand else channels // num_heads
        inner = self.head_dim * num_heads
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.q = nn.Conv1d(channels, inner, 1)
        self.k = nn.Conv1d(channels, inner, 1)
        self.v = nn.Conv1d(channels, inner, 1)
        self.proj_out = nn.Conv1d(inner, channels, 1)

    def forward(self, x):
        B, N, _ = x.shape
        nh, hd = self.num_heads, self.head_dim
        h = self.norm(x.transpose(1, 2)).transpose(1, 2)

        def heads(conv):
            return _linear(conv, h).reshape(B, N, nh, hd).transpose(1, 2).contiguous()

        out = graphs.eager(_attention, heads(self.q), heads(self.k), heads(self.v))
        out = out.transpose(1, 2).reshape(B, N, nh * hd)
        return x + _linear(self.proj_out, out)


class AttnBlock1DExpand(AttnBlock1D):
    """The expand variant, 8 heads (reference MemoryEfficientAttnBlock1D_expand)."""

    def __init__(self, channels: int, num_heads: int = 8):
        super().__init__(channels, num_heads, expand=True)
