"""Fused UNet attention block: x + proj(MHA(qkv(GroupNorm(x)))).

Counterpart of ddmi_tpu/ops/pallas/attn_block.py::fused_attention_block,
with the same signature and NHWC layout: x (B, H, W, C); w_qkv (C, 3C) with
qkv-major output channels [q | k | v], each (head, dim); w_proj (C, C) with
head-major input rows.

On a CUDA tensor the block runs as the hand-written kernel in
csrc/attn_block.cu (qkv GEMM with GroupNorm in its prologue, attention with
K/V of one head in shared memory, proj GEMM with bias + residual in its
epilogue); GroupNorm statistics and their fold into per-(b, c) scale/shift
stay tensor code, as they are (B, C)-sized.  On a CPU tensor it runs
`attention_block_plain`, the same function in plain fp32 PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from ddmi_tpu_torch.ops import build

HEAD_DIM = 32    # the kernel's head dim (csrc/attn_block.cu HD)
Q_TILE = 64      # q rows per block, and the granularity of n
MAX_TOKENS = 1024


def supported(n: int, C: int, num_heads: int) -> bool:
    """Whether the CUDA kernel takes this shape (every celebahq block does:
    n = 1024/256/64, C = 512/1024/2048, head dim 32)."""
    return (
        num_heads * HEAD_DIM == C
        and n % Q_TILE == 0
        and 0 < n <= MAX_TOKENS
        and C % 64 == 0
    )


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


def fused_attention_block(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, sm_scale: float, num_groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """Full AttentionBlock forward, NHWC in and out."""
    if x.device.type == "cpu":
        return attention_block_plain(
            x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads,
            sm_scale, num_groups, eps,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block: unsupported device {x.device}")
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
    qkv = torch.empty((3, B, num_heads, n, HEAD_DIM), dtype=torch.bfloat16, device=x.device)
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


fused_attention_block.launches = 0
