"""LPIPS perceptual distance (counterpart of ddmi_tpu/evals/lpips.py;
reference losses/lpips.py): a VGG16 trunk, channel-unit-normalised tap
differences, learned per-channel `lin` weights, a spatial mean and a sum
over the five taps.

The state keys are the reference checkpoint's: torchvision's VGG16
`features.{i}.weight/bias` and LPIPS's `lin{i}.model.1.weight` (1, C, 1,
1), so a converted weight file loads as it is.  No weights are bundled and
nothing is fetched: `build_perceptual` loads a local file named by
`data.extra.lpips_pth`, and without one the VGG keeps its random init (and
the lin weights their init of ones) with a warning, as the JAX package
does.  Inputs are NHWC in [-1, 1].  Under model.amp the trunk runs in
bf16 (its weights cast once; they are frozen); the input scaling, the
normalisation, the squared differences, the lin weights and the means stay
fp32.
"""

from __future__ import annotations

import os
import warnings
from typing import List

import numpy as np
import torch
from torch import nn

# VGG16 `features`: conv widths and "M" max pools; taps after the ReLUs of
# convs 2, 4, 7, 10 and 13 (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512]
SLICE_ENDS = (2, 4, 7, 10, 13)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The VGG16 conv trunk as torchvision lays it out (`features.{i}`),
    emitting the five tap activations in the trunk's dtype."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x) -> List[torch.Tensor]:
        taps, convs = [], 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                convs += 1
                if convs in SLICE_ENDS:
                    taps.append(x)
        return taps


class NetLin(nn.Module):
    """LPIPS's NetLinLayer: dropout, then a bias-free 1x1 conv to one
    channel (`lin{i}.model.1.weight`), initialised to ones as the JAX
    package's random-init LPIPS is."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))
        nn.init.ones_(self.model[1].weight)


class LPIPS(nn.Module):
    """forward(x, y) NHWC in [-1, 1] -> the distance per sample (b,), fp32.
    `dtype` is the VGG trunk's compute dtype."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = VGG16Features()
        self.dtype = dtype
        for i, c in enumerate((64, 128, 256, 512, 512)):
            setattr(self, f"lin{i}", NetLin(c))
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1), persistent=False)
        self.net.to(dtype)
        self.requires_grad_(False)
        self.eval()

    def load_state_dict(self, state_dict, strict: bool = True):
        """Torchvision `features.*` and LPIPS `lin*` keys (the reference's
        layout) or the module's own `net.features.*`; trunk weights are
        rounded to `dtype` as they are copied in."""
        sd = {("net." + k if k.startswith("features.") else k): v for k, v in state_dict.items()}
        return super().load_state_dict(sd, strict=strict)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        def trunk(a):
            a = (a.float().permute(0, 3, 1, 2) - self.shift) / self.scale
            if a.is_cuda:
                a = a.contiguous(memory_format=torch.channels_last)
            return self.net(a.to(self.dtype))

        total = None
        for i, (a, b) in enumerate(zip(trunk(x), trunk(y))):
            a, b = a.float(), b.float()
            a = a / torch.sqrt((a**2).sum(dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b**2).sum(dim=1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}").model[1].weight.float().reshape(1, -1, 1, 1)
            val = ((a - b) ** 2 * w).sum(dim=1).mean(dim=(1, 2))
            total = val if total is None else total + val
        return total


def load_torch_weights(path: str):
    """A reference LPIPS weight file -> state dict: a torch checkpoint, or a
    .npy holding a dict of arrays (the JAX package's two formats)."""
    if path.endswith(".npy"):
        state = dict(np.load(path, allow_pickle=True).item())
        return {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}
    return torch.load(path, map_location="cpu")


def build_perceptual(cfg, device="cuda") -> LPIPS:
    """The LPIPS of stage-1 training on `device`: the trunk in bf16 under
    model.amp, weights from
    data.extra.lpips_pth when that file exists, else a random init from
    seed 0 (the same in every process, so that a resumed run continues on
    it) with a warning."""
    amp = bool(cfg.model.amp)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # a random VGG is the same one in every run (resume)
        model = LPIPS(dtype=torch.bfloat16 if amp else torch.float32)
    pth = cfg.data.extra.get("lpips_pth")
    if pth and os.path.exists(pth):
        state = load_torch_weights(pth)
        model.load_state_dict({k: v for k, v in state.items()
                               if k.startswith(("features.", "lin"))}, strict=False)
    else:
        warnings.warn(
            "LPIPS weights not found (data.extra.lpips_pth); using random-init VGG features: "
            "training still regularises on perceptual structure, but the values are not "
            "comparable to the reference's LPIPS")
    model.to(device)
    if model.shift.is_cuda:
        model.net.to(memory_format=torch.channels_last)
    return model
