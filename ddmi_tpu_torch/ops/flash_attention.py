"""Attention over long sequences (counterpart of the library Pallas kernel
jax.experimental.pallas.ops.tpu.flash_attention, forward and backward, as
the JAX package calls it at ddmi_tpu/nn/attention1d.py:66-77 and
ddmi_tpu/nn/unet.py:168-188).

q, k, v and the output are (B, nh, n, hd).  The library kernel takes the
scores in fp32, multiplies them by the scale, and streams K/V in blocks with
an online softmax; the JAX package sends it the cross-plane attentions with
n >= 512, n % min(n, 1024) == 0 and hd in {16, 32, 64, 128} (`supported`),
and the UNet attentions with n >= 512 when it trains.

On a CUDA tensor `flash_attention` launches the hand-written Hopper kernels
of csrc/flash.cu (wgmma products, TMA copies through an mbarrier ring): the
forward (csrc/flash_fwd_sm90.cuh; under autograd the entry that also writes
each row's log-sum-exp) and, from the autograd Function, the backward
(csrc/flash_bwd_sm90.cuh, the counterpart of the library's dkv and dq
kernels).  They have instances for hd 16, 32, 64 and 128; the wrappers
zero-pad any other head dim up to 128 to the next instance and cut the
results back, which is exact: zero columns add nothing to q.k and give zero
output columns.  On a CPU tensor it runs `flash_plain` and
`flash_bwd_plain`: exact fp32 attention and its gradient, chunked over query
rows so that they also run at the video decoder's n = 73,728, where dense
scores would take hundreds of GB.
"""

from __future__ import annotations

import torch

from ddmi_tpu_torch.core.tracing import shape_span
from ddmi_tpu_torch.ops.attention import (
    INSTANCES, check_operands, instance_hd, launch, load_entries, needs_grad, pad_head_dim,
)

MIN_TOKENS = 512   # ddmi_tpu/nn/unet.py FLASH_MIN_TOKENS
BLOCK = 1024       # ddmi_tpu/nn/unet.py FLASH_BLOCK
Q_CHUNK = 1024     # query rows per step of the plain versions


def supported(n: int, hd: int) -> bool:
    """The JAX package's gate for the cross-plane attentions
    (ddmi_tpu/nn/attention1d.py::tiered_attention)."""
    return n >= MIN_TOKENS and n % min(n, BLOCK) == 0 and hd in INSTANCES


def _lib():
    return load_entries("flash", {"ddmi_flash_attention": 4, "ddmi_flash_attention_lse": 5,
                                  "ddmi_flash_attention_bwd": 9})


def flash_plain(q, k, v, sm_scale: float, with_lse: bool = False):
    """The kernel's function in fp32: scores * scale, softmax, P.V, cast to
    q.dtype; Q_CHUNK query rows at a time.  With `with_lse`, also each row's
    fp32 log-sum-exp of the scaled scores, (B, nh, n)."""
    kf, vf = k.float().transpose(-1, -2), v.float()
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    for i in range(0, q.shape[-2], Q_CHUNK):
        s = (q[..., i : i + Q_CHUNK, :].float() @ kf) * sm_scale
        lse[..., i : i + Q_CHUNK] = torch.logsumexp(s, dim=-1)
        out[..., i : i + Q_CHUNK, :] = (torch.softmax(s, dim=-1) @ vf).to(q.dtype)
    return (out, lse) if with_lse else out


def flash_bwd_plain(q, k, v, o, lse, do, sm_scale: float):
    """The backward kernels' function in fp32 -> (dq, dk, dv) in q.dtype:
    di = sum(o * do), p = exp(q.k^T * s - lse), dv = p^T.do,
    ds = p * (do.v^T - di) * s, dk = ds^T.q, dq = ds.k; Q_CHUNK query rows
    at a time."""
    qf, kf, vf = q.float(), k.float(), v.float()
    di = (o.float() * do.float()).sum(-1)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for i in range(0, q.shape[-2], Q_CHUNK):
        rows = slice(i, i + Q_CHUNK)
        qi, doi = qf[..., rows, :], do[..., rows, :].float()
        p = torch.exp((qi @ kf.transpose(-1, -2)) * sm_scale - lse[..., rows, None])
        dv += p.transpose(-1, -2) @ doi
        ds = p * ((doi @ vf.transpose(-1, -2)) - di[..., rows, None]) * sm_scale
        dk += ds.transpose(-1, -2) @ qi
        dq[..., rows, :] = (ds @ kf).to(q.dtype)
    return dq, dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_fwd(q, k, v, sm_scale: float, with_lse: bool):
    """(out, lse or None): the forward kernel, through its entry that also
    writes each row's fp32 log-sum-exp when `with_lse`; `flash_plain` on a
    CPU tensor."""
    if q.device.type == "cpu":
        out, lse = flash_plain(q, k, v, sm_scale, with_lse=True)
        return out, (lse if with_lse else None)
    check_operands(q, k, v)
    shape, hd = q.shape, q.shape[-1]
    hp = instance_hd(hd)
    q, k, v = (pad_head_dim(t, hp) for t in (q, k, v))
    out = torch.empty_like(q)
    with shape_span("kernels.flash", shape):
        if with_lse:
            lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
            launch(_lib(), "ddmi_flash_attention_lse", (q, k, v, out, lse), q.shape, sm_scale)
        else:
            lse = None
            launch(_lib(), "ddmi_flash_attention", (q, k, v, out), q.shape, sm_scale)
    flash_attention.launches += 1
    return (out if hp == hd else out[..., :hd].contiguous()), lse


def flash_attention_bwd(q, k, v, o, lse, do, sm_scale: float):
    """(dq, dk, dv) of softmax(q.k^T * s).v for the output gradient `do`,
    from the forward's output `o` and log-sum-exp `lse`.  di = sum(o * do)
    is taken here in fp32, as the library takes it outside its kernels;
    then the two backward kernels (dk/dv, dq) launch, counted once."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    do = do.contiguous()
    check_operands(q, k, v, o, do)
    if lse.shape != q.shape[:-1] or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {tuple(q.shape[:-1])}")
    di = (o.float() * do.float()).sum(-1)
    hd = q.shape[-1]
    hp = instance_hd(hd)
    q, k, v, do = (pad_head_dim(t, hp) for t in (q, k, v, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch(_lib(), "ddmi_flash_attention_bwd", (q, k, v, do, lse, di, dq, dk, dv), q.shape,
           sm_scale)
    flash_attention_bwd.launches += 1
    if hp == hd:
        return dq, dk, dv
    return tuple(t[..., :hd].contiguous() for t in (dq, dk, dv))


flash_attention_bwd.launches = 0


class _Flash(torch.autograd.Function):
    """Forward with the row log-sum-exp kept; backward through
    `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, do, ctx.sm_scale), None)


def flash_attention(q, k, v, sm_scale: float) -> torch.Tensor:
    """softmax(q . k^T * s) . v over (B, nh, n, hd), differentiable: with
    autograd recording, the forward keeps each row's log-sum-exp and the
    backward runs the backward kernels (their plain version on the CPU)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if needs_grad(q, k, v):
        return _Flash.apply(q, k, v, sm_scale)
    return flash_attention_fwd(q, k, v, sm_scale, with_lse=False)[0]


flash_attention.launches = 0
