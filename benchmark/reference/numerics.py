"""Where the reference's products run in a given precision.

`Numerics()` is the reference proper: float32 operands, float32
accumulation.  `Numerics("fp8")` is the benchmark's control: every operand
of a product (a convolution, a linear layer, an attention product) is
rounded to float8 e4m3 with one scale per tensor, as an fp8 GEMM reads it,
and the product accumulates in float32.  The control stands in for a served
path one precision below the bf16 the configurations state, and the output
check has to fail it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def fp32_mode() -> None:
    """Float32 products in full float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale per tensor (its absolute
    maximum maps to FP8_MAX), returned in float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t.float() / scale).to(torch.float8_e4m3fn).float() * scale


class Numerics:
    """The products of the reference: `conv2d`, `linear`, `matmul`."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return round_fp8(t) if self.precision == "fp8" else t.float()

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.q(x), self.q(w), None if b is None else b.float(), **kw)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), None if b is None else b.float())

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)


FP32 = Numerics()
