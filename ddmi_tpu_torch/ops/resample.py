"""Regular-grid bilinear sampling as two interpolation products
(counterpart of ddmi_tpu/ops/resample.py), with border or zeros padding."""

from __future__ import annotations

import torch


def interp_matrix_1d(coords: torch.Tensor, size: int, align_corners: bool = False,
                     padding_mode: str = "border") -> torch.Tensor:
    """(n, size) bilinear interpolation matrix for 1D coords in [-1, 1].

    The coordinate math runs in fp32 whatever the coords' dtype: in bf16,
    `(coords + 1) * size` has a whole-pixel ULP near size 256.  'border'
    clamps the pixel coordinate into the row; 'zeros' keeps it and drops
    the taps that fall outside, so a coordinate past the edge blends toward
    zero.  The matrix is cast back to the coords' dtype."""
    if padding_mode not in ("border", "zeros"):
        raise NotImplementedError(f"padding_mode {padding_mode!r}")
    out_dtype = coords.dtype
    c = coords.float()
    if align_corners:
        px = (c + 1.0) * 0.5 * (size - 1)
    else:
        px = ((c + 1.0) * size - 1.0) * 0.5
    if padding_mode == "border":
        px = px.clamp(0.0, size - 1)
    x0f = torch.floor(px)
    w1 = px - x0f
    x0 = x0f.long()
    x1 = x0 + 1
    eye = torch.eye(size, device=coords.device, dtype=torch.float32)
    w0 = 1.0 - w1
    if padding_mode == "zeros":
        w0 = w0 * ((x0 >= 0) & (x0 <= size - 1)).float()
        w1 = w1 * ((x1 >= 0) & (x1 <= size - 1)).float()
    m = eye[x0.clamp(0, size - 1)] * w0[:, None] + eye[x1.clamp(0, size - 1)] * w1[:, None]
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
