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
enter NHWC, as the stage-1 loss holds them.  `GANLoss3D` is the video
pair: the same PatchGAN on one frame per clip and its 3D form (4^3
kernels, the norm's statistics over (N, T, H, W)) on the whole clip, which
enters NTHWC.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.parallel import distributed


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


class SyncBatchNorm(nn.Module):
    """Train-mode batch norm: (x - mean) / sqrt(var + 1e-5) * (scale + 1) +
    bias over N C spatial..., statistics over every axis but the channel, and
    under a process group over every rank's rows (the global batch's, as
    the JAX package's norm takes over its sharded batch)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.randn(channels) * 0.02)
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        axes = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if distributed.world_size() > 1:
            # a rank holds its rows of the global batch: the sums are reduced
            # over the ranks (differentiably), so the statistics are global
            from torch.distributed.nn.functional import all_reduce

            n = x.numel() // x.shape[1] * distributed.world_size()
            mean = all_reduce(x.sum(dim=axes, keepdim=True)) / n
            var = all_reduce((x - mean).square().sum(dim=axes, keepdim=True)) / n
        else:
            mean = x.mean(dim=axes, keepdim=True)
            var = (x - mean).square().mean(dim=axes, keepdim=True)
        scale = (self.scale + 1.0).reshape(shape)
        return (x - mean) * torch.rsqrt(var + 1e-5) * scale + self.bias.reshape(shape)


class NLayerDiscriminator(nn.Module):
    """PatchGAN over NCHW images (`dims` 2) or NCTHW clips (`dims` 3, 4^3
    kernels) -> (logits, taps): the activations after each LeakyReLU, then
    the logits."""

    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 3, dims: int = 2):
        super().__init__()
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        widths, nf = [ndf], ndf
        for _ in range(1, n_layers):
            nf = min(nf * 2, 512)
            widths.append(nf)
        widths.append(min(nf * 2, 512))
        strides = [2] * n_layers + [1]
        chans = [in_channels] + widths
        self.convs = nn.ModuleList(
            [conv(chans[i], chans[i + 1], 4, stride=strides[i], padding=2)
             for i in range(len(widths))] + [conv(widths[-1], 1, 4, stride=1, padding=2)])
        self.norms = nn.ModuleList([SyncBatchNorm(w) for w in widths[1:]])
        with torch.no_grad():
            for c in self.convs:
                c.weight.normal_(0.0, 0.02)
                c.bias.zero_()

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


class GANLoss3D(nn.Module):
    """The video stage-1 adversarial loss (JAX GANLoss3D): a 2D PatchGAN on
    one frame per clip, picked by `frame_idx` (b,), and a 3D PatchGAN on
    the whole clip.  Clips enter (b, t, h, w, c)."""

    def __init__(self, in_channels: int = 3, disc_weight: float = 1.0, disc_loss: str = "hinge"):
        super().__init__()
        self.disc_weight = disc_weight
        self.disc_loss = disc_loss
        self.disc2d = NLayerDiscriminator(in_channels)
        self.disc3d = NLayerDiscriminator(in_channels, dims=3)

    @staticmethod
    def _views(x, frame_idx):
        """(the picked frames NCHW, the clips NCTHW)."""
        frames = x[torch.arange(x.shape[0], device=x.device), frame_idx]
        return frames.permute(0, 3, 1, 2), x.permute(0, 4, 1, 2, 3)

    def generator_loss(self, inputs, reconstructions, frame_idx):
        """-w (mean 2D + mean 3D fake logits) + w * sum over both
        discriminators' taps but the logits of mean|fake - real| against
        the real taps without gradient."""
        x2, x3 = self._views(inputs, frame_idx)
        r2, r3 = self._views(reconstructions, frame_idx)
        lf2, f2f = self.disc2d(r2)
        _, f2r = self.disc2d(x2)
        lf3, f3f = self.disc3d(r3)
        _, f3r = self.disc3d(x3)
        g = -self.disc_weight * (lf2.mean() + lf3.mean())
        feat = 0.0
        for fr, ff in zip(f2r[:-1] + f3r[:-1], f2f[:-1] + f3f[:-1]):
            feat = feat + (ff - fr.detach()).abs().mean()
        return g + self.disc_weight * feat

    def discriminator_loss(self, inputs, reconstructions, frame_idx):
        """0.5 x (the 2D + the 3D hinge, or vanilla, loss) on detached
        inputs."""
        loss_fn = hinge_d_loss if self.disc_loss == "hinge" else vanilla_d_loss
        x2, x3 = self._views(inputs.detach(), frame_idx)
        r2, r3 = self._views(reconstructions.detach(), frame_idx)
        l2 = loss_fn(self.disc2d(x2)[0], self.disc2d(r2)[0])
        l3 = loss_fn(self.disc3d(x3)[0], self.disc3d(r3)[0])
        return 0.5 * (l2 + l3)
