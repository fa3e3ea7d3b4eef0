"""FVD (Fréchet Video Distance) and the video eval drivers (counterpart of
ddmi_tpu/evals/fvd.py): clips resized to 224^2 as jax.image.resize resizes
them, scaled to [-1, 1], embedded by the I3D's 400 logits on the scorer's
device, and the Fréchet distance of the logits' statistics."""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ddmi_tpu_torch.core.coords import resize_bilinear
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.evals.fid import activation_statistics, frechet_distance


def preprocess_video(videos: torch.Tensor) -> torch.Tensor:
    """(b, t, h, w, 3) in [0, 1] -> (b, t, 224, 224, 3) in [-1, 1]."""
    return 2.0 * resize_bilinear(videos.float(), (224, 224)) - 1.0


class FVDScorer:
    """I3D logits of clip streams, and FVD between two.  `model` is an
    evals/i3d.py I3D (its weights the caller's); it runs on `device` in
    fp32, `batch_size` clips a call."""

    def __init__(self, model, batch_size: int = 8, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).float().eval()
        self.batch_size = batch_size

    @torch.inference_mode()
    def embeddings(self, videos: Iterable) -> np.ndarray:
        """An iterable of (b, t, h, w, 3) [0, 1] batches -> (N, 400)."""
        out = []
        for batch in videos:
            x = batch if torch.is_tensor(batch) else torch.as_tensor(np.asarray(batch))
            for i in range(0, x.shape[0], self.batch_size):
                v = preprocess_video(x[i : i + self.batch_size].to(self.device))
                out.append(self.model(v).cpu().numpy())
        return np.concatenate(out, 0)

    def fvd(self, real: Iterable, fake: Iterable) -> float:
        mu_r, s_r = activation_statistics(self.embeddings(real))
        mu_f, s_f = activation_statistics(self.embeddings(fake))
        return frechet_distance(mu_r, s_r, mu_f, s_f)


def test_rfvd(scorer: FVDScorer, reconstruct_fn: Callable, test_data: Iterable,
              max_batches: int = 512) -> float:
    """Reconstruction FVD over at most max_batches test batches."""
    reals, fakes = [], []
    for i, batch in enumerate(test_data):
        if i >= max_batches:
            break
        reals.append(batch)
        fakes.append(reconstruct_fn(batch))
    return scorer.fvd(reals, fakes)


def test_fvd_sample(scorer: FVDScorer, sample_fn: Callable[[torch.Generator], object],
                    test_data: Iterable, n_samples: int = 2048,
                    generator: Optional[torch.Generator] = None) -> float:
    """Generation FVD: `sample_fn(generator)` returns a batch of clips, its
    draws from `generator` (a CPU generator seeded 0 when None), until
    n_samples are made."""
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    fakes = []
    n = 0
    while n < n_samples:
        v = sample_fn(generator)
        fakes.append(v)
        n += int(v.shape[0])
    return scorer.fvd(test_data, fakes)


def psnr(reconstruct_fn: Callable, test_data: Iterable, max_batches: int = 100) -> float:
    """The mean over the test batches (at most max_batches) of -10
    log10(MSE) of the reconstruction, each batch's MSE floored at 1e-12."""
    vals = []
    for i, batch in enumerate(test_data):
        if i >= max_batches:
            break
        recon = np.asarray(reconstruct_fn(batch))
        mse = np.mean((recon - np.asarray(batch)) ** 2)
        vals.append(-10.0 * np.log10(max(mse, 1e-12)))
    return float(np.mean(vals))
