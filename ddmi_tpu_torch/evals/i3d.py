"""I3D (Inflated 3D Inception-v1), the FVD feature network (counterpart of
ddmi_tpu/evals/i3d.py): inference only, plain PyTorch on the card.

Modules and parameters carry the names of the original pytorch_i3d
(`Conv3d_1a_7x7.conv3d.weight`, `Mixed_3b.b1a.bn.running_mean`,
`logits.conv3d.bias`, ...), so that a converted Kinetics-400 checkpoint
loads as it is and ddmi_tpu/evals/i3d.py::load_torch_i3d maps a state_dict
of this module onto the JAX tree; interop.py::i3d_from_jax maps back.

Every convolution and max pool pads as TensorFlow's SAME does (flax's
'SAME'): out = ceil(n / stride) and the padding (out - 1) * stride + k - n,
its smaller half first.  torch's conv3d and max_pool3d take only
symmetric padding, so the input is padded explicitly: zeros before a
convolution, -inf before a max pool (flax's reduce_window pads with the
max's identity).  BatchNorm is frozen, eps 1e-5.

I/O: (b, t, 224, 224, 3) clips in [-1, 1] -> (b, 400) logits, fp32.  The
final (2, 7, 7) average pool needs frames of at least 193^2 (FVD feeds
224^2) and at least 9 frames.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.evals.inception import he_init


def _same_pad(x: torch.Tensor, kernel: Tuple[int, ...], stride: Tuple[int, ...],
              value: float) -> torch.Tensor:
    """Pad the trailing len(kernel) axes of x as SAME pads them."""
    pads = []
    for n, k, s in zip(reversed(x.shape[-len(kernel):]), reversed(kernel), reversed(stride)):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


def max_pool_same(x: torch.Tensor, window, stride) -> torch.Tensor:
    return F.max_pool3d(_same_pad(x, tuple(window), tuple(stride), float("-inf")),
                        tuple(window), tuple(stride))


class Unit3D(nn.Module):
    """SAME conv3d, then the frozen BatchNorm and ReLU where asked."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, activation: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = nn.Conv3d(cin, cout, self.kernel, stride=self.stride, bias=use_bias)
        self.bn = nn.BatchNorm3d(cout, eps=1e-5) if use_bn else None

    def forward(self, x):
        x = self.conv3d(_same_pad(x, self.kernel, self.stride, 0.0))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    def __init__(self, cin: int, c: Sequence[int]):
        super().__init__()
        self.b0 = Unit3D(cin, c[0])
        self.b1a = Unit3D(cin, c[1])
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = Unit3D(cin, c[3])
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = Unit3D(cin, c[5])

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], 1)


_MIXED = (("Mixed_3b", 192, [64, 96, 128, 16, 32, 32]),
          ("Mixed_3c", 256, [128, 128, 192, 32, 96, 64]),
          ("Mixed_4b", 480, [192, 96, 208, 16, 48, 64]),
          ("Mixed_4c", 512, [160, 112, 224, 24, 64, 64]),
          ("Mixed_4d", 512, [128, 128, 256, 24, 64, 64]),
          ("Mixed_4e", 512, [112, 144, 288, 32, 64, 64]),
          ("Mixed_4f", 528, [256, 160, 320, 32, 128, 128]),
          ("Mixed_5b", 832, [256, 160, 320, 32, 128, 128]),
          ("Mixed_5c", 832, [384, 192, 384, 48, 128, 128]))


class I3D(nn.Module):
    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        for name, cin, c in _MIXED:
            setattr(self, name, InceptionModule(cin, c))
        self.logits = Unit3D(1024, num_classes, use_bn=False, activation=False, use_bias=True)
        he_init(self)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (b, t, 224, 224, 3) in [-1, 1] -> (b, num_classes)."""
        x = x.float().permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        return self.logits(x).mean(dim=(2, 3, 4))
