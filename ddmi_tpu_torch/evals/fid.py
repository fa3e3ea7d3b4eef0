"""FID: activation statistics, the Fréchet distance and the eval drivers
(counterpart of ddmi_tpu/evals/fid.py).

Features come from the InceptionV3 of evals/inception.py on the scorer's
device (the card unless the caller asks for the CPU), batch by batch as
the images arrive; the statistics and the 2048 x 2048 matrix square root
run on the host in float64 (numpy and scipy), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ddmi_tpu_torch.core.device import resolve_device


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of (n, d) activations."""
    mu = np.mean(feats, axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)).  Where the square root
    of the product is not finite, eps is added to both diagonals first; a
    complex root whose diagonal's imaginary part exceeds 1e-3 raises, a
    smaller one is dropped.  With fewer samples than dimensions both
    covariances are singular and the root is ill-conditioned."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


class FIDScorer:
    """InceptionV3 pool features of image streams, and FID between two.
    `model` is an evals/inception.py InceptionV3 (its weights the
    caller's); it runs on `device` in fp32, `batch_size` images a call."""

    def __init__(self, model, batch_size: int = 64, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).float().eval()
        self.batch_size = batch_size

    @torch.inference_mode()
    def features(self, images: Iterable) -> np.ndarray:
        """images: an iterable of NHWC [0, 1] batches (numpy or torch) ->
        (N, 2048) float32.  Each batch is featurised as it arrives, so a
        generator of many samples never holds more than one batch of
        pixels."""
        out = []
        for batch in images:
            x = batch if torch.is_tensor(batch) else torch.as_tensor(np.asarray(batch))
            for i in range(0, x.shape[0], self.batch_size):
                chunk = x[i : i + self.batch_size].to(self.device, torch.float32)
                out.append(self.model(chunk)[0].cpu().numpy())
        return np.concatenate(out, axis=0)

    def fid(self, real: Iterable, fake: Iterable) -> float:
        mu_r, s_r = activation_statistics(self.features(real))
        mu_f, s_f = activation_statistics(self.features(fake))
        return frechet_distance(mu_r, s_r, mu_f, s_f)

    def fid_against_stats(self, fake: Iterable, stats_path: str) -> float:
        """FID against precomputed (mu, sigma) statistics, an .npz with
        `mu` and `sigma` (cli/precompute_fid.py writes them)."""
        stats = np.load(stats_path)
        mu_f, s_f = activation_statistics(self.features(fake))
        return frechet_distance(stats["mu"], stats["sigma"], mu_f, s_f)


def test_rfid(scorer: FIDScorer, reconstruct_fn: Callable, test_data: Iterable,
              max_batches: int = 512) -> float:
    """Reconstruction FID: reconstructions against the test batches, at
    most max_batches of them (the reference's cap is 512).  Features
    stream batch by batch; a truncation is printed."""
    real_feats, fake_feats = [], []
    n_seen = truncated = 0
    for i, batch in enumerate(test_data):
        if i >= max_batches:
            truncated = 1
            break
        real_feats.append(scorer.features([np.asarray(batch)]))
        fake_feats.append(scorer.features([reconstruct_fn(batch)]))
        n_seen += np.asarray(batch).shape[0]
    if truncated:
        print(f"rFID: ran {max_batches} batches ({n_seen} images) — loader "
              f"truncated at max_batches={max_batches} (reference cap: 512, "
              f"evals/eval.py:98)")
    else:
        print(f"rFID: full test loader, {n_seen} images")
    mu_r, s_r = activation_statistics(np.concatenate(real_feats))
    mu_f, s_f = activation_statistics(np.concatenate(fake_feats))
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def test_fid_n(scorer: FIDScorer, sample_fn: Callable[[torch.Generator], object],
               test_data: Iterable, n_samples: int = 10000, batch: int = 50,
               generator: Optional[torch.Generator] = None,
               protocol_n: int = 10000) -> float:
    """Generation FID over n_samples: `sample_fn(generator)` returns one
    batch of images (NHWC, [0, 1]), its draws taken from `generator` (a CPU
    generator seeded 0 when None), which every call advances.  Generated
    batches are featurised as they are made; progress and any departure
    from the protocol's count are printed."""
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    fake_feats = []
    n = 0
    while n < n_samples:
        imgs = sample_fn(generator)
        fake_feats.append(scorer.features([imgs]))
        k = int(imgs.shape[0])
        n += k
        if n % max(batch * 10, 500) < k:
            print(f"FID sampling: {n}/{n_samples}")
    if n_samples != protocol_n:
        print(f"FID: ran {n} generated samples — PROTOCOL IS {protocol_n} "
              f"(evals/eval.py:187-248); raise data.extra.eval_samples for "
              f"reference-comparable numbers")
    else:
        print(f"FID: {n} generated samples (protocol {protocol_n})")
    real_feats = scorer.features(test_data)
    print(f"FID: {real_feats.shape[0]} real samples")
    mu_r, s_r = activation_statistics(real_feats)
    mu_f, s_f = activation_statistics(np.concatenate(fake_feats))
    return frechet_distance(mu_r, s_r, mu_f, s_f)
