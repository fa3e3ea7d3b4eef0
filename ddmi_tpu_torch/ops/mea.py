"""Memory-efficient exact attention (counterpart of ddmi_tpu/ops/mea.py):
one dense softmax up to `_DENSE_MAX` tokens, above it an online softmax over
KV chunks, tiled over query chunks, so the scores held at once stay at
(2048 x 2048) per batch and head.  The JAX package computes this outside any Pallas
kernel, so here it is plain PyTorch (`torch.matmul`).  The video decoder's
cross-plane attentions whose head dim no kernel takes (hd 512 at n = 2048,
hd 256 at n = 6144) run here.
"""

from __future__ import annotations

import torch

_DENSE_MAX = 2048
_CHUNK = 2048  # query and key rows per streamed block, as ddmi_tpu/ops/mea.py


def attention(q, k, v):
    """q, k, v: (..., n, d) -> (..., n, d) in v's dtype, scale d^-0.5.  q is
    scaled in its own dtype first; the dense path takes the scores in q's
    dtype and the softmax in fp32, the streamed path runs its softmax and
    P.V in fp32."""
    n, d = q.shape[-2], q.shape[-1]
    q = q * d**-0.5
    if n <= _DENSE_MAX:
        attn = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return attn @ v
    nk = k.shape[-2]
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    for i in range(0, n, _CHUNK):
        qi = q[..., i : i + _CHUNK, :]
        m = torch.full(qi.shape[:-1], -torch.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qi.shape, dtype=torch.float32, device=q.device)
        for j in range(0, nk, _CHUNK):
            sim = (qi @ k[..., j : j + _CHUNK, :].transpose(-1, -2)).float()
            m_new = torch.maximum(m, sim.amax(-1))
            p = torch.exp(sim - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ v[..., j : j + _CHUNK, :].float()
            m = m_new
        out[..., i : i + _CHUNK, :] = (acc / l.clamp_min(1e-30)[..., None]).to(v.dtype)
    return out
