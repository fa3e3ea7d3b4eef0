"""Multi-head attention for short sequences (counterpart of
ddmi_tpu/ops/pallas/attention.py::mha_vmem).

q, k, v and the output are (B, nh, n, hd).  The TPU kernel multiplies q by
the softmax scale in fp32, rounds the product once to q's dtype, takes the
scores in fp32 and normalises after the value product; the JAX package sends
it every sampling attention with n % 8 == 0, n <= 1024 and hd <= 128
(`supported`).

On a CUDA tensor `mha_vmem` launches the hand-written kernel in
csrc/attention.cu (K/V streamed through shared memory in 64-key tiles; see
csrc/flash_attn.cuh), which reproduces that rounding of q.  On a CPU tensor
it runs `mha_plain`, the same function in dense fp32 PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from ddmi_tpu_torch.ops import build

MAX_TOKENS = 1024


def supported(n: int, hd: int) -> bool:
    """The JAX package's gate for this kernel."""
    return n % 8 == 0 and n <= MAX_TOKENS and hd <= 128


def kernel_takes(hd: int) -> bool:
    """Head dims the CUDA kernel has an instance for (every repo config's)."""
    return hd % 16 == 0 and 16 <= hd <= 128


def mha_plain(q, k, v, sm_scale: float) -> torch.Tensor:
    """The kernel's function in dense fp32: q scaled in fp32 and rounded to
    q.dtype, fp32 scores and softmax, cast to q.dtype."""
    qs = (q.float() * sm_scale).to(q.dtype).float()
    p = torch.softmax(qs @ k.float().transpose(-1, -2), dim=-1)
    return (p @ v.float()).to(q.dtype)


def _lib():
    lib = build.load("attention")
    for fn in (lib.ddmi_mha_vmem, lib.ddmi_flash_attention):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
    return lib


def launch(entry: str, q, k, v, sm_scale: float) -> torch.Tensor:
    """Check the operands and launch `entry` of csrc/attention.cu."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, nh, n, hd) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, nh, n, hd = q.shape
    if not kernel_takes(hd):
        raise NotImplementedError(
            f"the attention kernel has no instance for head dim {hd} "
            f"(B={B}, heads={nh}, n={n}): it takes multiples of 16 up to 128")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("q, k, v must be contiguous bf16 on one CUDA device")
    out = torch.empty_like(q)
    err = getattr(_lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, nh, n, hd,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out


def mha_vmem(q, k, v, sm_scale: float) -> torch.Tensor:
    """softmax(bf16(q * s) . k^T) . v over (B, nh, n, hd)."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_vmem: unsupported device {q.device}")
    out = launch("ddmi_mha_vmem", q, k, v, sm_scale)
    mha_vmem.launches += 1
    return out


mha_vmem.launches = 0
