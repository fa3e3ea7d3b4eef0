"""Fused UNet attention block: x + proj(MHA(qkv(GroupNorm(x)))).

Two entries, one kernel:
  * `attention_block` takes the UNet AttentionBlock's own parameters as
    they are stored: norm weight and bias (C,), the qkv Conv1d weight
    (3C, C, 1) with head-major output channels (head, {q, k, v}, dim) and
    bias (3C,), the proj_out Conv1d weight (C, C, 1) and bias (C,).  On the
    card it hands the pointers of bf16 weights to the kernel: no copy,
    gather, transpose or cast of a weight per call.
  * `fused_attention_block` is the counterpart of ddmi_tpu/ops/pallas/
    attn_block.py::fused_attention_block, with its signature and layouts:
    x (B, H, W, C) NHWC; w_qkv (C, 3C) with qkv-major output channels
    [q | k | v], each (head, dim); w_proj (C, C) with head-major input rows.
    On the card it converts the weights to the module layout once per call
    and calls `attention_block` (the tests hold it against JAX).

On a CUDA tensor the block runs as the hand-written kernel in
csrc/attn_block.cu: four launches (GroupNorm; the qkv GEMM with bias, q
times the scale and the head dim zero-padded to the next flash instance; the
Hopper flash forward writing token-major rows; the proj GEMM with bias and
residual), and no PyTorch op but the allocation of the output and one
scratch buffer.  Under autograd its backward recomputes through the plain
version, as the JAX kernel's custom_vjp does; the UNet takes the block only
when no gradient is recorded.  On a CPU tensor it runs
`attention_block_plain`, the same function in plain fp32 PyTorch.

`supported` is the JAX kernel's predicate (n % 8 == 0, n <= 1024, hd <= 128,
C % 128 == 0): every head dim it takes has a flash instance once padded.
"""

from __future__ import annotations

import ctypes

import torch

from ddmi_tpu_torch.ops import build, flash_attention
from ddmi_tpu_torch.ops.attention import needs_grad, recompute_vjp

MAX_TOKENS = 1024


def jax_supported(n: int, C: int, num_heads: int) -> bool:
    """ddmi_tpu/ops/pallas/attn_block.py::supported."""
    hd = C // num_heads
    return (n % 8 == 0 and n <= MAX_TOKENS and num_heads * hd == C and hd <= 128
            and C % 128 == 0)


# Whether the CUDA kernel takes a shape: the JAX predicate, since the qkv GEMM
# zero-pads any head dim to the next of 16, 32, 64, 128.
supported = jax_supported


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


def group_norm_apply(x: torch.Tensor, gn_scale, gn_bias, num_groups: int, eps: float):
    """The kernel's GroupNorm step in plain PyTorch: x (B, n, C) -> x * es +
    eb in fp32 with the statistics of `fold_group_norm`, cast to x.dtype
    (the kernel's h is bf16, as JAX's kernel materialises it in x's dtype)."""
    es, eb = fold_group_norm(x, gn_scale, gn_bias, num_groups, eps)
    return (x.float() * es[:, None, :] + eb[:, None, :]).to(x.dtype)


def attention_block_plain(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, sm_scale: float, num_groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """The block in plain PyTorch, fp32 throughout, cast to x.dtype."""
    B, H, W, C = x.shape
    n = H * W
    hd = C // num_heads
    xf = x.reshape(B, n, C).float()
    h = group_norm_apply(xf, gn_scale, gn_bias, num_groups, eps)
    qkv = h @ w_qkv.float() + b_qkv.float()
    qkv = qkv.reshape(B, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * sm_scale, qkv[1], qkv[2]
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    out = (p @ v).transpose(1, 2).reshape(B, n, C)
    out = xf + b_proj.float() + out @ w_proj.float()
    return out.to(x.dtype).reshape(B, H, W, C)


def module_to_jax_layout(w_qkv, b_qkv, w_proj, num_heads: int):
    """The module's weights (qkv (3C, C[, 1]) head-major, proj (C, C[, 1]))
    in the JAX signature's layout: (C, 3C) qkv-major, (3C,), (C, C) with
    input rows.  Differentiable; contiguous copies."""
    C = w_proj.shape[0]
    hd = C // num_heads
    wq = w_qkv.reshape(num_heads, 3, hd, C).transpose(0, 1).reshape(3 * C, C).t()
    bq = b_qkv.reshape(num_heads, 3, hd).transpose(0, 1).reshape(3 * C)
    return wq.contiguous(), bq, w_proj.reshape(C, C).t().contiguous()


def jax_to_module_layout(w_qkv, b_qkv, w_proj, num_heads: int):
    """The inverse of `module_to_jax_layout`: (3C, C) head-major, (3C,),
    (C, C) as the proj Conv1d stores it (output rows)."""
    C = w_qkv.shape[0]
    hd = C // num_heads
    wq = w_qkv.t().reshape(3, num_heads, hd, C).transpose(0, 1).reshape(3 * C, C)
    bq = b_qkv.reshape(3, num_heads, hd).transpose(0, 1).reshape(3 * C)
    return wq, bq, w_proj.t()


def _lib():
    lib = build.load("attn_block")
    fn = lib.ddmi_attn_block
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _kernel_dtypes(norm_w, norm_b, w_qkv, b_qkv, w_proj, b_proj):
    """The operands in the kernel's dtypes: contiguous bf16 weights, and
    norm and biases of one dtype (bf16 where all are, else fp32).  An
    operand already so is returned as it is: the UNet's bf16 parameters
    pass through uncopied."""
    bf, f32 = torch.bfloat16, torch.float32
    ops = (norm_w, norm_b, w_qkv, b_qkv, w_proj, b_proj)
    vecs = (norm_w, norm_b, b_qkv, b_proj)
    dt = norm_w.dtype
    if (w_qkv.dtype == bf and w_proj.dtype == bf and dt in (bf, f32)
            and all(v.dtype == dt for v in vecs) and all(t.is_contiguous() for t in ops)):
        return ops  # checked first: the conversions below cost enqueue time even as no-ops
    w_qkv, w_proj = (w.to(bf).contiguous() for w in (w_qkv, w_proj))
    dt = bf if all(v.dtype == bf for v in vecs) else f32
    return (*(v.to(dt).contiguous() for v in vecs[:2]), w_qkv,
            vecs[2].to(dt).contiguous(), w_proj, vecs[3].to(dt).contiguous())


def _launch(x, norm_w, norm_b, w_qkv, b_qkv, w_proj, b_proj, num_heads: int,
            sm_scale: float, num_groups: int, eps: float, out=None) -> torch.Tensor:
    """The kernel on the module's layout; x (B, H, W, C) bf16.  It writes a
    new tensor, or `out` (contiguous, of x's shape, dtype and device) where
    given."""
    B, H, W, C = x.shape
    n = H * W
    if not supported(n, C, num_heads) or (C // num_groups) % 4 or C % num_groups:
        raise NotImplementedError(
            f"attention block kernel does not take n={n}, C={C}, heads={num_heads}, "
            f"groups={num_groups}"
        )
    if x.dtype != torch.bfloat16:
        raise ValueError("attention block: x must be bf16 NHWC")
    if w_qkv.shape[:2] != (3 * C, C) or w_proj.shape[:2] != (C, C):
        raise ValueError(f"weight shapes {tuple(w_qkv.shape)}, {tuple(w_proj.shape)}")
    norm_w, norm_b, w_qkv, b_qkv, w_proj, b_proj = _kernel_dtypes(
        norm_w, norm_b, w_qkv, b_qkv, w_proj, b_proj)
    vecs = (norm_w, norm_b, b_qkv, b_proj)
    if [v.shape for v in vecs] != [(C,), (C,), (3 * C,), (C,)]:
        raise ValueError("norm or bias shapes do not match C")
    for t in (w_qkv, w_proj, *vecs):
        if t.device != x.device:
            raise ValueError("all operands must be on x's device")
    x = x.contiguous()
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
          or not out.is_contiguous()):
        raise ValueError("out must be contiguous, of x's shape, dtype and device")
    hdp = flash_attention.instance_hd(C // num_heads)
    M = B * n
    scratch = torch.empty(2 * M * C + 3 * M * num_heads * hdp, dtype=torch.bfloat16,
                          device=x.device)
    h = scratch.data_ptr()
    attn = h + 2 * M * C
    qkv = attn + 2 * M * C
    err = _lib().ddmi_attn_block(
        x.data_ptr(), norm_w.data_ptr(), norm_b.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(),
        w_proj.data_ptr(), b_proj.data_ptr(), h, qkv, attn, out.data_ptr(),
        B, n, C, num_heads, num_groups, float(eps), float(sm_scale),
        int(vecs[0].dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention block kernel launch failed: cudaError {err}")
    fused_attention_block.launches += 1
    return out


def _plain_module(x, norm_w, norm_b, w_qkv, b_qkv, w_proj, b_proj, num_heads: int,
                  sm_scale: float, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """`attention_block_plain` on the module's layout (its JAX-layout
    copies); differentiable."""
    wq, bq, wp = module_to_jax_layout(w_qkv, b_qkv, w_proj, num_heads)
    return attention_block_plain(x, norm_w, norm_b, wq, bq, wp, b_proj, num_heads, sm_scale,
                                 num_groups, eps)


class _FusedBlock(torch.autograd.Function):
    """The kernel forward on the module's layout; the backward recomputes
    through the plain version (ddmi_tpu/ops/pallas/attn_block.py's
    custom_vjp recomputes densely)."""

    @staticmethod
    def forward(ctx, *args):
        tensors, static = args[:7], args[7:]
        ctx.save_for_backward(*tensors)
        ctx.static = static
        return _launch(*args)

    @staticmethod
    def backward(ctx, dout):
        grads = recompute_vjp(_plain_module, ctx.saved_tensors, ctx.needs_input_grad, dout,
                              *ctx.static)
        return (*grads, *(None,) * len(ctx.static))


def attention_block(x, norm_w, norm_b, w_qkv, b_qkv, w_proj, b_proj, num_heads: int,
                    sm_scale: float, num_groups: int = 32, eps: float = 1e-5,
                    out=None) -> torch.Tensor:
    """The block on the UNet module's parameters as stored (see the module
    docstring), NHWC in and out.  On the card the kernel, which reads bf16
    parameters in place; with a gradient recorded, its gradient comes from
    the plain version.  On the CPU the plain version.  `out` (NHWC
    contiguous, x's dtype) takes the result where given: the kernel writes
    it in place."""
    args = (x, norm_w, norm_b, w_qkv, b_qkv, w_proj, b_proj, num_heads, sm_scale,
            num_groups, eps)
    if x.device.type == "cpu":
        y = _plain_module(*args)
    elif x.device.type != "cuda":
        raise ValueError(f"attention_block: unsupported device {x.device}")
    elif needs_grad(*args[:7]):
        y = _FusedBlock.apply(*args)
    else:
        return _launch(*args, out=out)
    return y if out is None else out.copy_(y)


def fused_attention_block(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, sm_scale: float, num_groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """Full AttentionBlock forward on the JAX signature's operands, NHWC in
    and out.  On the card `attention_block` on the weights converted to the
    module layout (differentiably); on the CPU the plain version."""
    if x.device.type == "cpu":
        return attention_block_plain(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                                     num_heads, sm_scale, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block: unsupported device {x.device}")
    C = x.shape[-1]
    if w_qkv.shape != (C, 3 * C) or w_proj.shape != (C, C):
        raise ValueError(f"weight shapes {tuple(w_qkv.shape)}, {tuple(w_proj.shape)}")
    wq, bq, wp = jax_to_module_layout(w_qkv, b_qkv, w_proj, num_heads)
    return attention_block(x, gn_scale, gn_bias, wq, bq, wp, b_proj, num_heads, sm_scale,
                           num_groups, eps)


fused_attention_block.launches = 0
