"""Memory-efficient exact attention (counterpart of ddmi_tpu/ops/mea.py):
one dense softmax up to `dense_max` tokens, above it an online softmax over
`kv_chunk` keys at a time, tiled over `q_chunk` query rows, so the scores
held at once stay at (q_chunk x kv_chunk) per batch and head.  The JAX
package computes this outside any Pallas kernel, so here it is plain
PyTorch (`torch.matmul`).  The video decoder's cross-plane attentions that
no kernel takes (hd 512 at n = 2048, hd 256 at n = 6144, and under autograd
hd 64 at n = 73,728), and the TimeSformer's attentions, run here.

The streamed path is differentiable with memory O(n * d): its autograd
Function keeps q, k, v, the fp32 output and each row's log-sum-exp, and its
backward recomputes the scores one (q_chunk x kv_chunk) tile at a time (JAX
remats both the query-block body and the KV-scan body to the same end).
Recorded whole by autograd, the loop would keep every tile's fp32 scores:
about 350 GB at the decoder's n = 73,728 (batch 2, 8 heads).
"""

from __future__ import annotations

import torch

_DENSE_MAX = 2048


def _tiles(n: int, chunk: int):
    return [slice(i, min(i + chunk, n)) for i in range(0, n, chunk)]


def _scores(qi, kj):
    """q.k^T in the operands' dtype, then fp32 (JAX: einsum, then astype)."""
    return (qi @ kj.transpose(-1, -2)).float()


class _Streamed(torch.autograd.Function):
    """softmax(q.k^T).v with q pre-scaled, streamed: forward -> the output
    in v's dtype; backward from saved (q, k, v, fp32 output, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_chunk: int, q_chunk: int):
        n, nk = q.shape[-2], k.shape[-2]
        out = torch.empty(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32, device=q.device)
        lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
        for rows in _tiles(n, q_chunk):
            qi = q[..., rows, :]
            m = torch.full(qi.shape[:-1], -torch.inf, dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            acc = out[..., rows, :].zero_()
            for cols in _tiles(nk, kv_chunk):
                sim = _scores(qi, k[..., cols, :])
                m_new = torch.maximum(m, sim.amax(-1))
                p = torch.exp(sim - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc.mul_(corr[..., None]).add_(p @ v[..., cols, :].float())
                m = m_new
            l = l.clamp_min(1e-30)
            acc.div_(l[..., None])
            lse[..., rows] = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunks = (kv_chunk, q_chunk)
        return out.to(v.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        kv_chunk, q_chunk = ctx.chunks
        n, nk = q.shape[-2], k.shape[-2]
        do = do.float()
        di = (out * do).sum(-1)
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for rows in _tiles(n, q_chunk):
            qi, doi = q[..., rows, :], do[..., rows, :]
            dqi = dq[..., rows, :].zero_()
            for cols in _tiles(nk, kv_chunk):
                kj = k[..., cols, :]
                p = torch.exp(_scores(qi, kj) - lse[..., rows, None])
                dv[..., cols, :] += p.transpose(-1, -2) @ doi
                ds = p * (doi @ v[..., cols, :].float().transpose(-1, -2) - di[..., rows, None])
                ds = ds.to(q.dtype)
                dqi += (ds @ kj).float()
                dk[..., cols, :] += (ds.transpose(-1, -2) @ qi).float()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def attention(q, k, v, kv_chunk: int = 2048, q_chunk: int = 2048, scale=None, dense_max=None):
    """q, k, v: (..., n, d) with any leading dims -> (..., n, d) in v's
    dtype; exact.  q is multiplied by `scale` (d^-0.5 when None) in its own
    dtype first.  Up to `dense_max` tokens (2048 when None) one dense
    softmax: scores in the operands' dtype, softmax in fp32, cast to v's
    dtype for P.V.  Above it the streamed path: scores in the operands'
    dtype then fp32, softmax and P.V in fp32.  A ragged last chunk is cut
    short, which is JAX's zero padding with its key mask."""
    n, d = q.shape[-2], q.shape[-1]
    q = q * (d**-0.5 if scale is None else scale)
    if n <= (_DENSE_MAX if dense_max is None else dense_max):
        attn = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return attn @ v
    return _Streamed.apply(q, k, v, kv_chunk, q_chunk)
