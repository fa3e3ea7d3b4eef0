"""Mixed-precision policy of training (counterpart of ddmi_tpu/core/amp.py):
fp32 master parameters, bf16 compute.

A module runs through `torch.func.functional_call` on bf16 casts of its
fp32 parameters, so every convolution and matmul runs in bf16 while autograd
carries the gradients back through the casts to the fp32 masters (JAX: the
cast's transpose).  Stage 2's denoiser takes a bf16 input and returns fp32,
so the diffusion math and the loss reductions stay fp32; stage 1 calls the
VAE's encode / decode and the INR with `method_call` on such casts, keeping
its coordinates and loss reductions in fp32 (domains/image.py).
torch.autocast casts per op instead, which is not what JAX computes.
"""

from __future__ import annotations

import torch
from torch.func import functional_call


def compute_cast(params: dict, enabled: bool) -> dict:
    """bf16 casts of the fp32 tensors of `params` when enabled."""
    if not enabled:
        return params
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in params.items()}


class _Method(torch.nn.Module):
    """`module.<method>` as a forward, for functional_call."""

    def __init__(self, module: torch.nn.Module, method: str):
        super().__init__()
        self.m = module
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.m, self.method)(*args, **kwargs)


def method_call(module: torch.nn.Module, params: dict, method: str, *args, **kwargs):
    """module.<method>(*args, **kwargs) with `params` (name -> tensor, e.g.
    the bf16 casts of `compute_cast`) in place of its parameters."""
    return functional_call(_Method(module, method), {"m." + k: v for k, v in params.items()},
                           args, kwargs)


def amp_denoiser(module: torch.nn.Module, enabled: bool):
    """model_fn(x, t) -> fp32 output of `module` under the bf16 policy when
    enabled, else the module itself (in its parameters' dtype)."""
    if not enabled:
        return module

    def model_fn(x, t):
        params = compute_cast(dict(module.named_parameters()), True)
        return functional_call(module, params, (x.to(torch.bfloat16), t)).float()

    return model_fn
