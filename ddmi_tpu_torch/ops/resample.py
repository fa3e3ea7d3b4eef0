"""Regular-grid bilinear sampling as two interpolation products
(counterpart of ddmi_tpu/ops/resample.py)."""

from __future__ import annotations

import torch


def interp_matrix_1d(coords: torch.Tensor, size: int, align_corners: bool = False,
                     padding_mode: str = "border") -> torch.Tensor:
    """(n, size) bilinear interpolation matrix for 1D coords in [-1, 1].

    The coordinate math runs in fp32 whatever the coords' dtype: in bf16,
    `(coords + 1) * size` has a whole-pixel ULP near size 256.  The matrix is
    cast back to the coords' dtype."""
    out_dtype = coords.dtype
    c = coords.float()
    if align_corners:
        px = (c + 1.0) * 0.5 * (size - 1)
    else:
        px = ((c + 1.0) * size - 1.0) * 0.5
    if padding_mode != "border":
        raise NotImplementedError(f"padding_mode {padding_mode!r} is not ported")
    px = px.clamp(0.0, size - 1)
    x0f = torch.floor(px)
    w1 = px - x0f
    x0 = x0f.long()
    x1c = (x0 + 1).clamp(max=size - 1)
    eye = torch.eye(size, device=coords.device, dtype=torch.float32)
    m = eye[x0] * (1.0 - w1)[:, None] + eye[x1c] * w1[:, None]
    return m.to(out_dtype)


def separable_grid_sample(plane: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                          align_corners: bool = False,
                          padding_mode: str = "border") -> torch.Tensor:
    """Sample an NCHW plane at the grid ys x xs -> (b, len(ys), len(xs), c),
    channels last (the token layout of the INR)."""
    B, C, H, W = plane.shape
    ry = interp_matrix_1d(ys, H, align_corners, padding_mode)  # (Ho, H)
    rx = interp_matrix_1d(xs, W, align_corners, padding_mode)  # (Wo, W)
    out = torch.einsum("oh,bchw->bocw", ry, plane)
    return torch.einsum("pw,bocw->bopc", rx, out)


def pixel_center_lin(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """1D pixel-centre coordinates [-(n-1)/n, (n-1)/n]."""
    e = (n - 1) / n
    return torch.linspace(-e, e, n, dtype=dtype, device=device)
