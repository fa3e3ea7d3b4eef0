"""Convolutional Occupancy Network, the standalone ConvONet (counterpart of
ddmi_tpu/nn/onet.py).

`LocalDecoder` conditions a point-wise FC-ResNet on the encoder's features
sampled at the query points: the sum of bilinear samples of the 'xz',
'xy' and 'yz' planes (border padding, align_corners=True, the coordinates
of `sample_plane_coords`) and, where the encoder gives one, the trilinear
sample of the 'grid' volume at the points normalised with the decoder's
padding.  Each block adds `fc_c[i]` of those features before it runs;
`fc_out` maps the last block's activation to one occupancy logit.
`ConvONet` is an encoder (nn/pointnet.py's LocalPoolPointnet or
LocalVoxelEncoder) and the decoder.  fp32, plain PyTorch, as JAX runs it
outside any Pallas kernel.  The encoders' planes are NCHW and the grid
NCDHW; state keys follow the reference LocalDecoder: `fc_p`, `fc_c.{i}`,
`blocks.{i}`, `fc_out`.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.nn.inr import sample_plane_coords
from ddmi_tpu_torch.nn.stylegan import ResnetBlockFC
from ddmi_tpu_torch.ops.grid_sample import grid_sample_2d, grid_sample_3d


def normalize_3d_coordinate(p: torch.Tensor, padding: float = 0.1) -> torch.Tensor:
    """(b, n, 3) points of the padded unit cube -> [0, 1 - 1e-5]."""
    return (p / (1 + padding + 1e-5) + 0.5).clamp(0.0, 1 - 1e-5)


class LocalDecoder(nn.Module):
    """forward(p (b, n, 3), c_planes {'xz' | 'xy' | 'yz': (b, c, r, r),
    'grid': (b, c, d, h, w)}) -> occupancy logits (b, n)."""

    def __init__(self, c_dim: int = 32, hidden_size: int = 256, n_blocks: int = 5,
                 leaky: bool = False, padding: float = 0.1):
        super().__init__()
        self.c_dim, self.leaky, self.padding = c_dim, leaky, padding
        self.fc_p = nn.Linear(3, hidden_size)
        self.fc_c = nn.ModuleList([nn.Linear(c_dim, hidden_size) for _ in range(n_blocks)]
                                  if c_dim != 0 else [])
        self.blocks = nn.ModuleList([ResnetBlockFC(hidden_size) for _ in range(n_blocks)])
        self.fc_out = nn.Linear(hidden_size, 1)

    def features(self, p: torch.Tensor, c_planes: Dict[str, torch.Tensor]):
        if not isinstance(c_planes, dict):
            raise TypeError("LocalDecoder takes the plane and grid features of an encoder "
                            f"(a dict), not {type(c_planes).__name__}")
        c = 0.0
        if "grid" in c_planes:
            pn = 2.0 * normalize_3d_coordinate(p.float(), self.padding) - 1.0
            c = c + grid_sample_3d(c_planes["grid"].permute(0, 2, 3, 4, 1), pn)
        for k in ("xz", "xy", "yz"):
            if k in c_planes:
                c = c + grid_sample_2d(c_planes[k].permute(0, 2, 3, 1),
                                       sample_plane_coords(p, k), align_corners=True,
                                       padding_mode="border")
        return c

    def forward(self, p: torch.Tensor, c_planes: Dict[str, torch.Tensor]) -> torch.Tensor:
        c = self.features(p, c_planes)
        net = self.fc_p(p)
        for i, block in enumerate(self.blocks):
            if self.c_dim != 0:
                net = net + self.fc_c[i](c)
            net = block(net)
        act = F.leaky_relu(net, 0.2) if self.leaky else F.relu(net)
        return self.fc_out(act).squeeze(-1)


class ConvONet(nn.Module):
    """encoder + LocalDecoder: forward(p (b, n, 3), inputs) -> logits (b, n)."""

    def __init__(self, encoder: nn.Module, decoder: LocalDecoder):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def encode_inputs(self, inputs):
        return self.encoder(inputs)

    def decode(self, p, c_planes):
        return self.decoder(p, c_planes)

    def forward(self, p, inputs):
        return self.decode(p, self.encode_inputs(inputs))
