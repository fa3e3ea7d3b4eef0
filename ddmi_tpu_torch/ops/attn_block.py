"""Fused UNet attention block: x + proj(MHA(qkv(GroupNorm(x)))).

Counterpart of ddmi_tpu/ops/pallas/attn_block.py::fused_attention_block,
with the same signature and NHWC layout: x (B, H, W, C); w_qkv (C, 3C) with
qkv-major output channels [q | k | v], each (head, dim); w_proj (C, C) with
head-major input rows.

On a CUDA tensor the block runs as the hand-written kernel in
csrc/attn_block.cu (qkv GEMM with GroupNorm in its prologue, attention with
K/V streamed through shared memory, proj GEMM with bias + residual in its
epilogue); GroupNorm statistics and their fold into per-(b, c) scale/shift
stay tensor code, as they are (B, C)-sized.  Under autograd its backward
recomputes through the plain version, as the JAX kernel's custom_vjp does;
the UNet takes the block only when no gradient is recorded.  On a CPU
tensor it runs `attention_block_plain`, the same function in plain fp32
PyTorch.

`supported` is the JAX kernel's predicate (n % 8 == 0, n <= 1024, hd <= 128,
C % 128 == 0) restricted to head dims that are multiples of 16, the ones the
CUDA kernel has instances for; every repo config's head dim is one.  A shape
the JAX predicate takes and the kernel does not raises NotImplementedError.
"""

from __future__ import annotations

import ctypes

import torch

from ddmi_tpu_torch.ops import build
from ddmi_tpu_torch.ops.attention import kernel_takes, needs_grad, recompute_vjp

MAX_TOKENS = 1024


def jax_supported(n: int, C: int, num_heads: int) -> bool:
    """ddmi_tpu/ops/pallas/attn_block.py::supported."""
    hd = C // num_heads
    return (n % 8 == 0 and n <= MAX_TOKENS and num_heads * hd == C and hd <= 128
            and C % 128 == 0)


def supported(n: int, C: int, num_heads: int) -> bool:
    """Whether the CUDA kernel takes this shape: the JAX predicate with a
    head dim that is a multiple of 16 (celebahq: hd 32, n 1024/256/64;
    skytimelapse: hd 64, n 256...8)."""
    return jax_supported(n, C, num_heads) and kernel_takes(C // num_heads)


def fold_group_norm(x: torch.Tensor, gn_scale, gn_bias, num_groups: int, eps: float):
    """GroupNorm of x (B, n, C) as per-(b, c) scale/shift in fp32:
    GN(x) = x * es + eb."""
    B, n, C = x.shape
    xg = x.reshape(B, n, num_groups, C // num_groups).float()
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False)  # (B, G)
    per = C // num_groups
    rstd = torch.rsqrt(var + eps).repeat_interleave(per, dim=1)
    es = rstd * gn_scale.float()[None, :]
    eb = gn_bias.float()[None, :] - mean.repeat_interleave(per, dim=1) * es
    return es.contiguous(), eb.contiguous()


def attention_block_plain(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, sm_scale: float, num_groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """The block in plain PyTorch, fp32 throughout, cast to x.dtype."""
    B, H, W, C = x.shape
    n = H * W
    hd = C // num_heads
    xf = x.reshape(B, n, C).float()
    es, eb = fold_group_norm(xf, gn_scale, gn_bias, num_groups, eps)
    h = xf * es[:, None, :] + eb[:, None, :]
    qkv = h @ w_qkv.float() + b_qkv.float()
    qkv = qkv.reshape(B, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * sm_scale, qkv[1], qkv[2]
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    out = (p @ v).transpose(1, 2).reshape(B, n, C)
    out = xf + b_proj.float() + out @ w_proj.float()
    return out.to(x.dtype).reshape(B, H, W, C)


def _lib():
    lib = build.load("attn_block")
    fn = lib.ddmi_attn_block
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _kernel(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads: int,
            sm_scale: float, num_groups: int, eps: float) -> torch.Tensor:
    B, H, W, C = x.shape
    n = H * W
    if not supported(n, C, num_heads):
        raise NotImplementedError(
            f"attention block kernel does not take n={n}, C={C}, heads={num_heads}"
        )
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("fused_attention_block: x must be contiguous bf16 NHWC")
    if w_qkv.shape != (C, 3 * C) or w_proj.shape != (C, C):
        raise ValueError(f"weight shapes {tuple(w_qkv.shape)}, {tuple(w_proj.shape)}")
    if b_qkv.shape != (3 * C,) or b_proj.shape != (C,) or C % num_groups:
        raise ValueError("bias shapes or group count do not match C")
    for t in (gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj):
        if t.device != x.device:
            raise ValueError("all operands must be on x's device")

    es, eb = fold_group_norm(x.reshape(B, n, C), gn_scale, gn_bias, num_groups, eps)
    wq = w_qkv.to(torch.bfloat16).contiguous()
    bq = b_qkv.float().contiguous()
    wp = w_proj.to(torch.bfloat16).contiguous()
    bp = b_proj.float().contiguous()
    qkv = torch.empty((3, B, num_heads, n, C // num_heads), dtype=torch.bfloat16,
                      device=x.device)
    attn = torch.empty((B * n, C), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    err = _lib().ddmi_attn_block(
        x.data_ptr(), es.data_ptr(), eb.data_ptr(), wq.data_ptr(), bq.data_ptr(),
        wp.data_ptr(), bp.data_ptr(), qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
        B, n, C, num_heads, float(sm_scale),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention block kernel launch failed: cudaError {err}")
    fused_attention_block.launches += 1
    return out


class _FusedBlock(torch.autograd.Function):
    """The kernel forward; the backward recomputes through
    `attention_block_plain` (ddmi_tpu/ops/pallas/attn_block.py's custom_vjp
    recomputes densely)."""

    @staticmethod
    def forward(ctx, *args):
        tensors, static = args[:7], args[7:]
        ctx.save_for_backward(*tensors)
        ctx.static = static
        return _kernel(*args)

    @staticmethod
    def backward(ctx, dout):
        grads = recompute_vjp(attention_block_plain, ctx.saved_tensors, ctx.needs_input_grad,
                              dout, *ctx.static)
        return (*grads, *(None,) * len(ctx.static))


def fused_attention_block(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, sm_scale: float, num_groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """Full AttentionBlock forward, NHWC in and out.  On the card with
    autograd recording, the gradient comes from the plain version."""
    args = (x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads, sm_scale,
            num_groups, eps)
    if x.device.type == "cpu":
        return attention_block_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block: unsupported device {x.device}")
    if needs_grad(*args[:7]):
        return _FusedBlock.apply(*args)
    return _kernel(*args)


fused_attention_block.launches = 0
