"""Coordinate and image-space helpers (counterpart of
ddmi_tpu/core/coords.py)."""

from __future__ import annotations

import torch


def symmetrize(x):
    """[0, 1] -> [-1, 1]."""
    return 2.0 * x - 1.0


def unsymmetrize(x):
    """[-1, 1] -> [0, 1]."""
    return (x + 1.0) / 2.0


def get_scale_injection(current_res: int, anchor_res: int = 256) -> float:
    return anchor_res / current_res


def _triangle_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of jax.image.resize's "linear" method with
    antialias (jax/_src/image/scale.py::compute_weight_mat): a triangle
    kernel widened by the downscale factor, each output's weights
    normalised to sum 1."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) / scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None])
    w = torch.clamp(1.0 - x.abs() / kernel_scale, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return (w * inside[None, :]).t()


def resize_antialias(x: torch.Tensor, size: int) -> torch.Tensor:
    """Area-correct antialiased resize of NHWC images to (size, size), the
    function of jax.image.resize(..., "linear", antialias=True); the
    identity at that size."""
    B, H, W, C = x.shape
    if H == size and W == size:
        return x
    wh = _triangle_weights(H, size, x.device).to(x.dtype)
    ww = _triangle_weights(W, size, x.device).to(x.dtype)
    return torch.einsum("oh,bhwc,pw->bopc", wh, x, ww)
