"""Latent posterior (counterpart of ddmi_tpu/nn/distributions.py).

Moments arrive channel-concatenated [mean | logvar] on the channel axis
(NCHW, as in the reference's DiagonalGaussianDistribution); the logvar is
clamped to [-30, 20].
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(moments, 2, dim=1)
        return cls(mean, logvar.clamp(-30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        """Reparameterized sample for standard-normal `eps` (fp32, the
        moments' shape): formed in fp32 whatever the moments' dtype, then
        cast back to it, as the JAX package does (under bf16 a sample is a
        rounding of the fp32 one, not another draw)."""
        s = self.mean.float() + self.std.float() * eps.float()
        return s.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean
