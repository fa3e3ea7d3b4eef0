"""Attention over long sequences (counterpart of the forward of the library
Pallas kernel jax.experimental.pallas.ops.tpu.flash_attention, as the JAX
package calls it at ddmi_tpu/nn/attention1d.py:66-77 and
ddmi_tpu/nn/unet.py:168-188).

q, k, v and the output are (B, nh, n, hd).  The library kernel takes the
scores in fp32, multiplies them by the scale, and streams K/V in blocks with
an online softmax; the JAX package sends it the cross-plane attentions with
n >= 512, n % min(n, 1024) == 0 and hd in {16, 32, 64, 128} (`supported`).

On a CUDA tensor `flash_attention` launches the hand-written kernel in
csrc/attention.cu (one source with mha_vmem; K/V streamed through shared
memory in 64-key tiles).  On a CPU tensor it runs `flash_plain`: exact fp32
attention, chunked over query rows so that it also runs at the video
decoder's n = 73,728, where dense scores would take hundreds of GB.
"""

from __future__ import annotations

import torch

from ddmi_tpu_torch.ops.attention import launch

MIN_TOKENS = 512   # ddmi_tpu/nn/unet.py FLASH_MIN_TOKENS
BLOCK = 1024       # ddmi_tpu/nn/unet.py FLASH_BLOCK
Q_CHUNK = 1024     # query rows per step of the plain version


def supported(n: int, hd: int) -> bool:
    """The JAX package's gate for the cross-plane attentions
    (ddmi_tpu/nn/attention1d.py::tiered_attention)."""
    return n >= MIN_TOKENS and n % min(n, BLOCK) == 0 and hd in (16, 32, 64, 128)


def flash_plain(q, k, v, sm_scale: float) -> torch.Tensor:
    """The kernel's function in fp32: scores * scale, softmax, P.V, cast to
    q.dtype; Q_CHUNK query rows at a time."""
    kf, vf = k.float().transpose(-1, -2), v.float()
    out = torch.empty_like(q)
    for i in range(0, q.shape[-2], Q_CHUNK):
        s = (q[..., i : i + Q_CHUNK, :].float() @ kf) * sm_scale
        out[..., i : i + Q_CHUNK, :] = (torch.softmax(s, dim=-1) @ vf).to(q.dtype)
    return out


def flash_attention(q, k, v, sm_scale: float) -> torch.Tensor:
    """softmax(q . k^T * s) . v over (B, nh, n, hd)."""
    if q.device.type == "cpu":
        return flash_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = launch("ddmi_flash_attention", q, k, v, sm_scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
