"""Scale-aware image INR head (counterpart of ddmi_tpu/nn/inr.py::INRImage,
regular-grid path only).

The state keys are the reference MLP's (models/d2c_vae/mlp.py):
`time_mlp.{1,3}` for the style MLP, `net_res{1..4}` and `torgb`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ddmi_tpu_torch.nn.stylegan import SinusoidalPosEmb, StyledResBlock, ToRGB, gelu_tanh
from ddmi_tpu_torch.ops.resample import separable_grid_sample


class GELUTanh(nn.Module):
    def forward(self, x):
        return gelu_tanh(x)


class INRImage(nn.Module):
    """forward(hdbf [3 x (b, latent, h, w)], si, grid_1d=(xs, ys)) ->
    (b, len(ys) * len(xs), out_ch), tokens y-major (row-major over ys, xs).
    The scale si conditions every conv through a sinusoidal style MLP and
    enters every token as `in_ch` extra channels."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        ch, in0 = cfg.ch, cfg.latent_dim + cfg.in_ch
        dim = ch // 4
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(dim), nn.Linear(dim, ch), GELUTanh(), nn.Linear(ch, ch)
        )
        self.net_res1 = StyledResBlock(in0, ch, ch)
        self.net_res2 = StyledResBlock(ch + in0, ch, ch)
        self.net_res3 = StyledResBlock(ch + in0, ch, ch)
        self.net_res4 = StyledResBlock(ch, ch, ch)
        self.torgb = ToRGB(ch, cfg.out_ch, ch)

    def style(self, si, b: int, device) -> torch.Tensor:
        """The style vector (b, ch) in fp32 for scale injection si."""
        scale_inj = torch.full((b,), float(si), dtype=torch.float32, device=device)
        l1, l2 = self.time_mlp[1], self.time_mlp[3]
        h = self.time_mlp[0](scale_inj)
        h = gelu_tanh(h @ l1.weight.float().t() + l1.bias.float())
        return h @ l2.weight.float().t() + l2.bias.float()

    def forward(self, hdbf: Sequence[torch.Tensor], si,
                grid_1d: Tuple[torch.Tensor, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        assert len(hdbf) == 3, "expects a 3-level HDBF pyramid"
        c = self.cfg
        b = hdbf[0].shape[0]
        dtype = hdbf[0].dtype
        xs, ys = grid_1d
        n = xs.shape[0] * ys.shape[0]

        def pe(plane):
            out = separable_grid_sample(plane, xs, ys, align_corners=False,
                                        padding_mode="border")
            return out.reshape(b, n, plane.shape[1])

        style = self.style(si, b, hdbf[0].device).to(dtype)
        scale_pix = torch.full((b, n, c.in_ch), float(si), dtype=dtype, device=hdbf[0].device)
        x = torch.cat([pe(hdbf[0]), scale_pix], -1)
        x_m = torch.cat([pe(hdbf[1]), scale_pix], -1)
        x_h = torch.cat([pe(hdbf[2]), scale_pix], -1)

        x = self.net_res1(x, style, generator)
        x = self.net_res2(torch.cat([x, x_m], -1), style, generator)
        x = self.net_res3(torch.cat([x, x_h], -1), style, generator)
        x = self.net_res4(x, style, generator)
        return self.torgb(x, style)
