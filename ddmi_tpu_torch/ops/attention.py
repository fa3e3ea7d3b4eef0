"""Multi-head attention for short sequences (counterpart of
ddmi_tpu/ops/pallas/attention.py::mha_vmem).

q, k, v and the output are (B, nh, n, hd).  The TPU kernel multiplies q by
the softmax scale in fp32, rounds the product once to q's dtype, takes the
scores in fp32 and normalises after the value product; the JAX package sends
it every sampling attention with n % 8 == 0, n <= 1024 and hd <= 128
(`supported`).

On a CUDA tensor `mha_vmem` launches the Hopper flash-attention forward
core (csrc/flash_fwd_sm90.cuh) through its entry `ddmi_mha_vmem` in
csrc/flash.cu, in the core's q pre-scale mode: each consumer warpgroup
multiplies its q rows by the scale in fp32 and rounds them once to bf16 in
shared memory, which reproduces that rounding of q.  It runs on the flash
instances (hd 16, 32, 64, 128): the kernel's TMA maps read the caller's
tensors at their own head dim, and the zero fill past hd pads them to the
next instance without a copy.  Only a head dim that is not a multiple of 8
(a row TMA cannot map) is zero-padded here, to its instance, with the
output cut back; that is exact: zero columns add nothing to bf16(q * s).k
and give zero output columns.  Under autograd its backward recomputes
through the plain version, as the JAX kernel's custom_vjp does.  On a CPU
tensor it runs `mha_plain`, the same function in dense fp32 PyTorch.  The
UNet and the 1D blocks take it only when no gradient is recorded, as the
JAX package takes it only in inference traces.
"""

from __future__ import annotations

import ctypes

import torch

from ddmi_tpu_torch.core.tracing import shape_span
from ddmi_tpu_torch.ops import build

MAX_TOKENS = 1024
MAX_HEAD_DIM = 128  # the largest head dim the attention kernels take
INSTANCES = (16, 32, 64, 128)  # head dims the flash core is built for


def supported(n: int, hd: int) -> bool:
    """The JAX package's gate for this kernel."""
    return n % 8 == 0 and n <= MAX_TOKENS and hd <= 128


def instance_hd(hd: int) -> int:
    """The flash core's instance a head dim of `hd` runs on: the smallest of
    INSTANCES that holds it."""
    for inst in INSTANCES:
        if hd <= inst:
            return inst
    raise NotImplementedError(f"the attention kernels have no instance for head dim {hd}")


def mha_head_dim(hd: int) -> int:
    """The instance `mha_vmem` runs a head dim of `hd` on, and the head dim
    the wrapper pads to where it pads (hd not a multiple of 8)."""
    return instance_hd(hd)


def pad_head_dim(t: torch.Tensor, hd: int) -> torch.Tensor:
    """t with its last (head) dim zero-padded to `hd`; t itself if it
    already has it."""
    return t if t.shape[-1] == hd else torch.nn.functional.pad(t, (0, hd - t.shape[-1]))


def mha_plain(q, k, v, sm_scale: float) -> torch.Tensor:
    """The kernel's function in dense fp32: q scaled in fp32 and rounded to
    q.dtype, fp32 scores and softmax, cast to q.dtype."""
    qs = (q.float() * sm_scale).to(q.dtype).float()
    p = torch.softmax(qs @ k.float().transpose(-1, -2), dim=-1)
    return (p @ v.float()).to(q.dtype)


def load_entries(name: str, entries: dict):
    """The library built from csrc/<name>.cu, with each entry of `entries`
    (entry -> its number of pointers before B, nh, n, hd) typed as
    (pointers..., B, nh, n, hd, scale, stream) -> cudaError_t."""
    lib = build.load(name)
    for entry, pointers in entries.items():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
    return lib


def check_operands(*ts) -> None:
    """Raise unless every tensor shares the first one's (B, nh, n, hd) shape
    with a head dim of at most 128, and is contiguous bf16 on its device."""
    q = ts[0]
    if q.ndim != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"attention operands must share one (B, nh, n, hd) shape: "
                         f"{[tuple(t.shape) for t in ts]}")
    B, nh, n, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the attention kernels have no instance for head dim {hd} "
            f"(B={B}, heads={nh}, n={n}): they take up to {MAX_HEAD_DIM}")
    for t in ts:
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("attention operands must be contiguous bf16 on one CUDA device")


def launch(lib, entry: str, tensors, q_shape, sm_scale: float) -> None:
    """Launch `entry` of `lib` on `tensors` (their data pointers, in the
    entry's order) for q's (B, nh, n, hd); raise on a launch error."""
    dev = tensors[0].device
    err = getattr(lib, entry)(
        *(t.data_ptr() for t in tensors), *q_shape, float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def needs_grad(*ts) -> bool:
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def recompute_vjp(plain, inputs, needs, grad_out, *static):
    """The gradients of `plain(*inputs, *static)` for `grad_out`, by running
    the plain version again under autograd: the dense-recompute backward the
    JAX package gives its inference kernels as a correctness net.  None for
    an input whose flag in `needs` is false."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        out = plain(*xs, *static)
    wanted = [x for x in xs if x.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, grad_out, allow_unused=True))
    return tuple(next(grads) if x.requires_grad else None for x in xs)


def _mha_kernel(q, k, v, sm_scale: float) -> torch.Tensor:
    check_operands(q, k, v)
    shape, hd = q.shape, q.shape[-1]
    hp = hd if hd % 8 == 0 else mha_head_dim(hd)
    if hp != hd:
        q, k, v = (pad_head_dim(t, hp) for t in (q, k, v))
    out = torch.empty_like(q)
    with shape_span("kernels.mha_vmem", shape):
        launch(load_entries("flash", {"ddmi_mha_vmem": 4}), "ddmi_mha_vmem", (q, k, v, out),
               q.shape, sm_scale)
    mha_vmem.launches += 1
    return out if hp == hd else out[..., :hd].contiguous()


class _MhaVmem(torch.autograd.Function):
    """The kernel forward; the backward recomputes through `mha_plain`
    (ddmi_tpu/ops/pallas/attention.py's custom_vjp recomputes densely)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale = sm_scale
        return _mha_kernel(q, k, v, sm_scale)

    @staticmethod
    def backward(ctx, dout):
        grads = recompute_vjp(mha_plain, ctx.saved_tensors, ctx.needs_input_grad, dout,
                              ctx.sm_scale)
        return (*grads, None)


def mha_vmem(q, k, v, sm_scale: float) -> torch.Tensor:
    """softmax(bf16(q * s) . k^T) . v over (B, nh, n, hd).  On the card with
    autograd recording, the gradient comes from the plain version."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_vmem: unsupported device {q.device}")
    if needs_grad(q, k, v):
        return _MhaVmem.apply(q, k, v, sm_scale)
    return _mha_kernel(q, k, v, sm_scale)


mha_vmem.launches = 0
