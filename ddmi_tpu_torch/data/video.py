"""Video datasets (the port's own copy of ddmi_tpu/data/video.py): clips as
(b, frames, res, res, 3) float32 batches in [0, 1], made on the host with
numpy and PIL.

`SyntheticVideos` makes the same numpy draws as the JAX package's, so a seed
gives bit-identical clips.  `VideoFrameFolderDataset` reads the
SkyTimelapse layout (root/<split-or-class>/<clip_dir>/<frame>.jpg): per
clip its sorted frames, a random temporal window (loop-padded when short),
a centre crop and a Lanczos resize, on a host thread that prefetches.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List

import numpy as np

_EXTS = {".png", ".jpg", ".jpeg", ".webp"}


def _clip_dirs(root: str) -> List[str]:
    """Directories that directly hold at least one image frame, sorted."""
    clips = []
    for dirpath, _, files in os.walk(root):
        if any(os.path.splitext(f)[1].lower() in _EXTS for f in files):
            clips.append(dirpath)
    clips.sort()
    return clips


class VideoFrameFolderDataset:
    """Yields (b, frames, res, res, 3) float32 batches in [0, 1] from frame
    folders; the order and the windows come from numpy's default_rng seeded
    seed + epoch, drawn serially so any worker count gives the same
    stream."""

    def __init__(self, root: str, batch_size: int, frames: int = 16, resolution: int = 256,
                 shuffle: bool = True, seed: int = 0, num_processes: int = 1,
                 process_index: int = 0, prefetch: int = 2, workers: int = 1):
        self.clips = _clip_dirs(root)[process_index::num_processes]
        if not self.clips:
            raise FileNotFoundError(f"no frame folders under {root}")
        self.batch_size = batch_size
        self.frames = frames
        self.resolution = resolution
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.workers = max(1, workers)
        self._epoch = 0

    def __len__(self):
        return max(1, len(self.clips) // self.batch_size)

    def _load_clip(self, clip_dir: str, u: float) -> np.ndarray:
        """u in [0, 1) picks the clip's start frame."""
        from PIL import Image

        files = sorted(f for f in os.listdir(clip_dir)
                       if os.path.splitext(f)[1].lower() in _EXTS)
        if len(files) >= self.frames:
            start = int(u * (len(files) - self.frames + 1))
            files = files[start : start + self.frames]
        else:
            reps = -(-self.frames // len(files))
            files = (files * reps)[: self.frames]
        r = self.resolution
        out = np.empty((self.frames, r, r, 3), np.float32)
        for i, f in enumerate(files):
            img = Image.open(os.path.join(clip_dir, f)).convert("RGB")
            w, h = img.size
            s = min(w, h)
            img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
            if img.size != (r, r):
                img = img.resize((r, r), Image.LANCZOS)
            out[i] = np.asarray(img, np.float32) / 255.0
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            from concurrent.futures import ThreadPoolExecutor

            rng = np.random.default_rng(self.seed + self._epoch)
            order = np.arange(len(self.clips))
            if self.shuffle:
                rng.shuffle(order)
            pool = ThreadPoolExecutor(self.workers) if self.workers > 1 else None
            try:
                bs = self.batch_size
                for i in range(0, len(order) - bs + 1, bs):
                    dirs = [self.clips[k] for k in order[i : i + bs]]
                    us = rng.random(bs)
                    if pool is not None:
                        clips = list(pool.map(self._load_clip, dirs, us))
                    else:
                        clips = [self._load_clip(d, u) for d, u in zip(dirs, us)]
                    q.put(np.stack(clips))
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        self._epoch += 1
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


class SyntheticVideos:
    """Deterministic moving sinusoid clips in [0, 1], (b, frames, res, res,
    3) float32, for tests and the chip run."""

    def __init__(self, batch_size: int, frames: int = 16, resolution: int = 64,
                 length: int = 8, seed: int = 0):
        self.batch_size = batch_size
        self.frames = frames
        self.resolution = resolution
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __iter__(self):
        r = self.resolution
        yy, xx = np.mgrid[0:r, 0:r] / r
        for i in range(self.length):
            rng = np.random.default_rng(self.seed * 7919 + i)
            fx = rng.uniform(1, 3, (self.batch_size, 1, 1, 1, 3))
            vt = rng.uniform(0.1, 0.5, (self.batch_size, 1, 1, 1, 3))
            tgrid = np.arange(self.frames).reshape(1, -1, 1, 1, 1) / self.frames
            img = 0.5 + 0.5 * np.sin(
                2 * np.pi * (fx * xx[None, None, :, :, None]
                             + fx * yy[None, None, :, :, None] + vt * tgrid))
            yield img.astype(np.float32)


def make_video_dataset(name: str, root: str, batch_size: int, frames: int = 16,
                       resolution: int = 256, **kw):
    """'sky' / 'skytimelapse' / 'folder' -> frame folders.  UCF101's video
    decoding (PyAV in the JAX package) is not ported."""
    name = name.lower()
    if name in ("sky", "skytimelapse", "folder"):
        return VideoFrameFolderDataset(root, batch_size, frames=frames, resolution=resolution,
                                       **kw)
    raise NotImplementedError(f"video dataset '{name}' is not ported")
