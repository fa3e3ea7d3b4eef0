"""FIR upsample, filter and downsample, StyleGAN2's `upfirdn2d`
(counterpart of ddmi_tpu/ops/upfirdn.py).

Zero-stuff by `up`, pad by (pad0, pad1) on both spatial axes (a negative
pad crops), convolve with the FIR kernel (flipped: a true convolution) and
keep every `down`-th sample.  The JAX function is one
`lax.conv_general_dilated` outside any Pallas kernel; here it is one
depthwise `F.conv2d` on the stuffed and padded planes.  NHWC in and out, as
in JAX.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def make_fir_kernel(k: Sequence[float], device=None) -> torch.Tensor:
    """1D taps -> the normalised separable 2D kernel (fp32)."""
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x (B, H, W, C), kernel (kh, kw) -> (B, Ho, Wo, C), Ho = (H * up +
    pad0 + pad1 - kh) // down + 1, each channel on its own."""
    B, H, W, C = x.shape
    kh, kw = kernel.shape
    pad0, pad1 = pad
    h = x.permute(0, 3, 1, 2)
    if up > 1:
        stuffed = h.new_zeros((B, C, H, up, W, up))
        stuffed[:, :, :, 0, :, 0] = h
        h = stuffed.reshape(B, C, H * up, W * up)
    h = F.pad(h, (pad0, pad1, pad0, pad1))
    w = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    out = F.conv2d(h, w.expand(C, 1, kh, kw), stride=down, groups=C)
    return out.permute(0, 2, 3, 1)


def blur(x: torch.Tensor, kernel: torch.Tensor, pad: Tuple[int, int],
         upsample_factor: int = 1) -> torch.Tensor:
    """The FIR blur, the kernel scaled by upsample_factor^2 when it follows
    an upsampling."""
    k = kernel * (upsample_factor ** 2) if upsample_factor > 1 else kernel
    return upfirdn2d(x, k, pad=pad)


def upsample_2d(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """FIR upsampling by `factor`, the kernel scaled by factor^2."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel * (factor ** 2), up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """FIR downsampling by `factor`."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=((p + 1) // 2, p // 2))
