"""Coordinate and image-space helpers (counterpart of
ddmi_tpu/core/coords.py): the [0, 1] <-> [-1, 1] maps, the antialiased
resize, the pixel-centre grid, the KL warm-up coefficient and stage 1's
multiscale target transform."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ddmi_tpu_torch.ops.resample import pixel_center_lin


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
    inv_scale = 1.0 / (n_out / n_in)  # in jax's order: the sample positions by a product
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None])
    w = torch.clamp(1.0 - x.abs() / kernel_scale, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return (w * inside[None, :]).t()


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize channels-last images (..., H, W, C) to size = (h, w), the
    function of jax.image.resize(x, (..., h, w, C), "bilinear"): a triangle
    kernel, widened by the ratio where an axis shrinks (jax's antialias,
    which torch's interpolate does not compute), each axis contracted on
    its own, in H then W order; an axis already at its size is left as it
    is."""
    h, w = size
    *lead, H, W, C = x.shape
    if H != h:
        x = torch.einsum("oh,...hwc->...owc", _triangle_weights(H, h, x.device).to(x.dtype), x)
    if W != w:
        x = torch.einsum("pw,...hwc->...hpc", _triangle_weights(W, w, x.device).to(x.dtype), x)
    return x


def resize_antialias(x: torch.Tensor, size: int) -> torch.Tensor:
    """Area-correct antialiased resize of NHWC images to (size, size), the
    function of jax.image.resize(..., "linear", antialias=True); the
    identity at that size."""
    return resize_bilinear(x, (size, size))


def pixel_center_grid(n: int, device=None) -> torch.Tensor:
    """(1, n, n, 2) fp32 pixel-centre grid over [-(n-1)/n, (n-1)/n], channel
    order (x, y), rows over y."""
    lin = pixel_center_lin(n, device=device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None]


def linear_kl_coeff(step: int, total_step: float, constant_step: float, min_coeff: float,
                    max_coeff: float) -> float:
    """The KL warm-up coefficient min + (max - min) (step - constant_step) /
    total_step, clipped to [min, max], computed in fp32 in the JAX
    package's order of operations (its jitted step has an int32 step and
    fp32 weak-typed constants)."""
    f32 = np.float32
    coeff = f32(min_coeff) + f32(max_coeff - min_coeff) * (f32(step) - f32(constant_step)) \
        / f32(total_step)
    return float(np.clip(f32(coeff), f32(min_coeff), f32(max_coeff)))


def multiscale_scales(size: int):
    """The three target scales of the multiscale transform: (resolution,
    relative scale) for the anchor, 1.5x and 2x the anchor."""
    return ((size, 1.0), (int(size * 1.5), float(np.float32(1 / 1.5))), (size * 2, 0.5))


def draw_multiscale(size: int, generator: Optional[torch.Generator] = None):
    """The transform's draws (p, i, j, i2, j2): the branch uniform p in
    [0, 1) and the crop offsets, i, j in [0, 2 size - size) for the 2x
    branch and i2, j2 in [0, 1.5 size - size) for the 1.5x branch (the JAX
    function's randint bounds, whose upper end is exclusive, so the last
    row and column of a resize are never a crop's first), in that order
    from `generator` (a CPU generator: the crop needs them on the host)."""
    res_m, res_h = int(size * 1.5), size * 2
    p = float(torch.rand((), generator=generator))
    i, j = (int(torch.randint(0, res_h - size, (), generator=generator)) for _ in range(2))
    i2, j2 = (int(torch.randint(0, res_m - size, (), generator=generator)) for _ in range(2))
    return p, i, j, i2, j2


def multiscale_image_transform(x: torch.Tensor, size: int, multiscale: bool = True,
                               draws=(0.0, 0, 0, 0, 0)):
    """Random-scale target and its matching coordinate crop (counterpart of
    ddmi_tpu/core/coords.py::multiscale_image_transform).

    x: (B, H, W, C) in [-1, 1] with H = W >= 2 size when multiscale;
    draws = (p, i, j, i2, j2) from `draw_multiscale` (or another
    framework's draws).  p <= 0.3 takes the anchor resize, p <= 0.6 a
    size x size crop at (i2, j2) of the 1.5 size resize, else a crop at
    (i, j) of the 2 size resize; each resize is clipped to [-1, 1].
    Returns (target (B, size, size, C), coords (1, size, size, 2) fp32 from
    the same crop of the pixel-centre grid, relative scale 1, 1/1.5 or 0.5,
    y_anchor the clipped anchor resize)."""
    y_anchor = resize_antialias(x, size).clamp(-1.0, 1.0)
    if not multiscale:
        return y_anchor, pixel_center_grid(size, x.device), 1.0, y_anchor
    p, i, j, i2, j2 = draws
    branch = 0 if p <= 0.3 else (1 if p <= 0.6 else 2)
    res, scale = multiscale_scales(size)[branch]
    if branch == 0:
        return y_anchor, pixel_center_grid(size, x.device), scale, y_anchor
    ii, jj = (i2, j2) if branch == 1 else (i, j)
    full = resize_antialias(x, res).clamp(-1.0, 1.0)
    target = full[:, ii:ii + size, jj:jj + size]
    coords = pixel_center_grid(res, x.device)[:, ii:ii + size, jj:jj + size]
    return target, coords, scale, y_anchor
