"""Mixed-precision policy of stage-2 training (counterpart of
ddmi_tpu/core/amp.py): fp32 master parameters, bf16 compute.

The denoiser runs through `torch.func.functional_call` on bf16 casts of its
fp32 parameters, so every convolution and matmul runs in bf16 while autograd
carries the gradients back through the casts to the fp32 masters (JAX: the
cast's transpose).  The input is cast to bf16 and the output returned in
fp32, so the diffusion math and the loss reductions stay fp32.
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


def amp_denoiser(module: torch.nn.Module, enabled: bool):
    """model_fn(x, t) -> fp32 output of `module` under the bf16 policy when
    enabled, else the module itself (in its parameters' dtype)."""
    if not enabled:
        return module

    def model_fn(x, t):
        params = compute_cast(dict(module.named_parameters()), True)
        return functional_call(module, params, (x.to(torch.bfloat16), t)).float()

    return model_fn
