"""The image INR's NoiseInjection draws: one N(0, 1) per token and styled
conv from Philox4x32-10 (Salmon et al., SC'11, "Parallel random numbers:
as easy as 1, 2, 3") on the counter (token, conv, 0, 0) under the key
(seed mod 2^32, 0x85EBCA6B), then Box-Muller on the first two output words:
u1 = ((w0 >> 8) + 1) / 2^24, u2 = (w1 >> 8) / 2^24,
N = sqrt(-2 ln u1) cos(2 pi u2).  Tokens count over the whole service
batch, row-major (sample, y, x)."""

from __future__ import annotations

import math

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
NOISE_KEY = 0x85EBCA6B
MASK = 0xFFFFFFFF


def _mul32(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of a * m for int64 tensors of 32-bit words,
    with every partial product below 2^63."""
    p = a * (m >> 16)           # < 2^48
    q = a * (m & 0xFFFF)        # < 2^48
    r = ((p & 0xFFFF) << 16) + q
    return (p >> 16) + (r >> 32), r & MASK


def philox(c, k0: int, k1: int):
    c0, c1, c2, c3 = c
    for _ in range(10):
        h0, l0 = _mul32(c0, M0)
        h1, l1 = _mul32(c2, M1)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1


def noise(seed: int, first_token: int, n_tokens: int, n_conv: int, device=None):
    """(n_tokens, n_conv) float32 draws for tokens first_token ...
    first_token + n_tokens - 1."""
    tok = torch.arange(first_token, first_token + n_tokens, dtype=torch.int64,
                       device=device)[:, None].expand(n_tokens, n_conv)
    cv = torch.arange(n_conv, dtype=torch.int64, device=device)[None, :].expand(n_tokens, n_conv)
    z = torch.zeros_like(tok)
    w0, w1 = philox((tok, cv, z, z), int(seed) & MASK, NOISE_KEY)
    u1 = ((w0 >> 8) + 1).float() / 16777216.0
    u2 = (w1 >> 8).float() / 16777216.0
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
