"""Synthetic images for tests and the chip run (the port's own copy of
ddmi_tpu/data/synthetic.py::SyntheticImages: the same numpy draws, so the
same seed gives bit-identical batches)."""

from __future__ import annotations

import numpy as np


class SyntheticImages:
    """Deterministic smooth random images in [0, 1], NHWC float32: sums of
    four low-frequency sinusoids per channel, normalised per image."""

    def __init__(self, batch_size: int, resolution: int = 256, channels: int = 3,
                 length: int = 64, seed: int = 0):
        self.batch_size = batch_size
        self.resolution = resolution
        self.channels = channels
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def _make_batch(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        b, r, c = self.batch_size, self.resolution, self.channels
        yy, xx = np.mgrid[0:r, 0:r] / r
        img = np.zeros((b, r, r, c), np.float32)
        for _ in range(4):
            fx = rng.uniform(0.5, 4, (b, 1, 1, c))
            fy = rng.uniform(0.5, 4, (b, 1, 1, c))
            ph = rng.uniform(0, 2 * np.pi, (b, 1, 1, c))
            amp = rng.uniform(0.1, 0.5, (b, 1, 1, c))
            img += amp * np.sin(
                2 * np.pi * (fx * xx[None, :, :, None] + fy * yy[None, :, :, None]) + ph
            )
        img = img - img.min(axis=(1, 2, 3), keepdims=True)
        img /= img.max(axis=(1, 2, 3), keepdims=True) + 1e-8
        return img.astype(np.float32)

    def __iter__(self):
        for i in range(self.length):
            yield self._make_batch(i)
