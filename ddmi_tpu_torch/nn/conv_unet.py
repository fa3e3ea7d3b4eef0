"""Feature-plane and feature-volume UNets of the ConvONet encoders
(counterpart of ddmi_tpu/nn/conv_unet.py): `UNet2D` (depth levels of
start_filts * 2^level channels, merge by concat or add) and `UNet3D`
(f_maps * 2^level channels over num_levels levels, concat merge).

NCHW / NCDHW, plain `nn.Conv2d` / `nn.Conv3d` (JAX runs them as XLA convs,
outside any Pallas kernel), each in the promotion of its input's and its
weight's dtypes, as flax's Conv computes.  Each level is two 3^k convs with ReLU, then a
2^k max pool; on the way up, a nearest resize to twice the size and a
3^k conv (the JAX package's form of the reference's transposed conv),
the merge with the skip, two 3^k convs with ReLU; a 1^k conv at the end.
State keys follow the JAX module names: `down{i}_conv1`, `up{i}_upconv`,
`conv_final`, ...
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _UNet(nn.Module):
    def __init__(self, dims: int, in_ch: int, out_ch: int, width: int, levels: int,
                 merge_mode: str):
        super().__init__()
        if merge_mode not in ("concat", "add"):
            raise ValueError(f"unknown merge_mode {merge_mode!r}")
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        self.dims, self.levels, self.merge_mode = dims, levels, merge_mode
        ch_in = in_ch
        for i in range(levels):
            ch = width * 2 ** i
            self.add_module(f"down{i}_conv1", conv(ch_in, ch, 3, padding=1))
            self.add_module(f"down{i}_conv2", conv(ch, ch, 3, padding=1))
            ch_in = ch
        for i in reversed(range(levels - 1)):
            ch = width * 2 ** i
            self.add_module(f"up{i}_upconv", conv(ch_in, ch, 3, padding=1))
            merged = 2 * ch if merge_mode == "concat" else ch
            self.add_module(f"up{i}_conv1", conv(merged, ch, 3, padding=1))
            self.add_module(f"up{i}_conv2", conv(ch, ch, 3, padding=1))
            ch_in = ch
        self.conv_final = conv(ch_in, out_ch, 1)

    def conv(self, name: str, h: torch.Tensor) -> torch.Tensor:
        """Conv `name` in the promotion of h's and its weight's dtypes, as
        flax's Conv promotes (bf16 weights on fp32 planes compute in fp32)."""
        layer = getattr(self, name)
        dt = torch.promote_types(h.dtype, layer.weight.dtype)
        fn = F.conv2d if self.dims == 2 else F.conv3d
        return fn(h.to(dt), layer.weight.to(dt), layer.bias.to(dt), padding=layer.padding)

    def forward(self, x):
        pool = F.max_pool2d if self.dims == 2 else F.max_pool3d
        skips = []
        h = x
        for i in range(self.levels):
            h = F.relu(self.conv(f"down{i}_conv1", h))
            h = F.relu(self.conv(f"down{i}_conv2", h))
            if i < self.levels - 1:
                skips.append(h)
                h = pool(h, 2)
        for i in reversed(range(self.levels - 1)):
            h = self.conv(f"up{i}_upconv", F.interpolate(h, scale_factor=2, mode="nearest"))
            skip = skips.pop()
            h = torch.cat([h, skip], 1) if self.merge_mode == "concat" else h + skip
            h = F.relu(self.conv(f"up{i}_conv1", h))
            h = F.relu(self.conv(f"up{i}_conv2", h))
        return self.conv("conv_final", h)


class UNet2D(_UNet):
    """forward(x (b, in_channels, H, W)) -> (b, num_classes, H, W); H and W
    divisible by 2^(depth - 1)."""

    def __init__(self, num_classes: int, in_channels: int, depth: int = 5, start_filts: int = 64,
                 merge_mode: str = "concat"):
        super().__init__(2, in_channels, num_classes, start_filts, depth, merge_mode)


class UNet3D(_UNet):
    """forward(x (b, in_channels, D, H, W)) -> (b, out_channels, D, H, W)."""

    def __init__(self, out_channels: int, in_channels: int, f_maps: int = 32,
                 num_levels: int = 3):
        super().__init__(3, in_channels, out_channels, f_maps, num_levels, "concat")
