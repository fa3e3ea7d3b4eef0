"""PatchGAN losses of adversarial stage-1 training (counterpart of
ddmi_tpu/losses/gan.py; reference losses/perceptual.py).

`NLayerDiscriminator` is pix2pix's PatchGAN: 4x4 convolutions with
padding 2 (stride 2 for the first n_layers, then 1), LeakyReLU 0.2, and a
train-mode batch norm after every conv but the first and the last.  That
norm (`SyncBatchNorm`, the reference's nn.SyncBatchNorm on one card) takes
the batch's statistics over (batch, H, W) with the biased variance and eps
1e-5 and keeps no running statistics; its `scale` parameter is stored as an
offset from 1, as the JAX package stores it, so the weights carry across
bit for bit.  Convolution weights start from N(0, 0.02), biases from 0.
`GANLoss2D` appends the relative scale as one more input channel.  Images
enter NHWC, as the stage-1 loss holds them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


class SyncBatchNorm(nn.Module):
    """Train-mode batch norm: (x - mean) / sqrt(var + 1e-5) * (scale + 1) +
    bias over NCHW, statistics over (N, H, W)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.randn(channels) * 0.02)
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        scale = (self.scale + 1.0).reshape(1, -1, 1, 1)
        return (x - mean) * torch.rsqrt(var + 1e-5) * scale + self.bias.reshape(1, -1, 1, 1)


class NLayerDiscriminator(nn.Module):
    """PatchGAN over NCHW images -> (logits, taps): the activations after
    each LeakyReLU, then the logits."""

    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        widths, nf = [ndf], ndf
        for _ in range(1, n_layers):
            nf = min(nf * 2, 512)
            widths.append(nf)
        widths.append(min(nf * 2, 512))
        strides = [2] * n_layers + [1]
        chans = [in_channels] + widths
        self.convs = nn.ModuleList(
            [nn.Conv2d(chans[i], chans[i + 1], 4, stride=strides[i], padding=2)
             for i in range(len(widths))] + [nn.Conv2d(widths[-1], 1, 4, stride=1, padding=2)])
        self.norms = nn.ModuleList([SyncBatchNorm(w) for w in widths[1:]])
        with torch.no_grad():
            for conv in self.convs:
                conv.weight.normal_(0.0, 0.02)
                conv.bias.zero_()

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        feats = []
        h = x
        for i, conv in enumerate(self.convs[:-1]):
            h = conv(h)
            if i > 0:
                h = self.norms[i - 1](h)
            h = F.leaky_relu(h, 0.2)
            feats.append(h)
        logits = self.convs[-1](h)
        feats.append(logits)
        return logits, feats


class GANLoss2D(nn.Module):
    """The stage-1 adversarial loss on NHWC images with the relative scale
    as a constant extra channel (the discriminator takes in_channels + 1)."""

    def __init__(self, in_channels: int = 3, disc_weight: float = 1.0,
                 disc_loss: str = "hinge", ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.disc_weight = disc_weight
        self.disc_loss = disc_loss
        self.discriminator = NLayerDiscriminator(in_channels + 1, ndf, n_layers)

    @staticmethod
    def _with_cond(x, cond):
        x = x.permute(0, 3, 1, 2)
        if cond is None:
            return x
        b, _, h, w = x.shape
        return torch.cat([x, torch.full((b, 1, h, w), float(cond), dtype=x.dtype,
                                        device=x.device)], dim=1)

    def generator_loss(self, inputs, reconstructions, cond: Optional[float] = None):
        """-w mean(fake logits) + w * sum over taps but the logits of
        mean|fake - real| against the real taps without gradient."""
        _, feats_real = self.discriminator(self._with_cond(inputs, cond))
        logits_fake, feats_fake = self.discriminator(self._with_cond(reconstructions, cond))
        g_loss = -self.disc_weight * logits_fake.mean()
        feat = 0.0
        for fr, ff in zip(feats_real[:-1], feats_fake[:-1]):
            feat = feat + (ff - fr.detach()).abs().mean()
        return g_loss + self.disc_weight * feat

    def discriminator_loss(self, inputs, reconstructions, cond: Optional[float] = None):
        """0.5 x the hinge (or vanilla) loss on detached inputs."""
        loss_fn = hinge_d_loss if self.disc_loss == "hinge" else vanilla_d_loss
        logits_real, _ = self.discriminator(self._with_cond(inputs.detach(), cond))
        logits_fake, _ = self.discriminator(self._with_cond(reconstructions.detach(), cond))
        return 0.5 * loss_fn(logits_real, logits_fake)
