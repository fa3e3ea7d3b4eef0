"""Video datasets (the port's own copy of ddmi_tpu/data/video.py): clips as
(b, frames, res, res, 3) float32 batches in [0, 1], made on the host with
numpy and PIL.

`SyntheticVideos` makes the same numpy draws as the JAX package's, so a seed
gives bit-identical clips.  `VideoFrameFolderDataset` reads the
SkyTimelapse layout (root/<split-or-class>/<clip_dir>/<frame>.jpg): per
clip its sorted frames, a random temporal window (loop-padded when short),
a centre crop and a Lanczos resize, on a host thread that prefetches.
`UCF101VideoDataset` decodes UCF101's video files with PyAV, which it
imports when it is built.
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
        self.num_processes = num_processes  # the trainer reads its batches as one rank's
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


class UCF101VideoDataset:
    """UCF101's .avi / .mp4 / .mkv clips decoded with PyAV: per batch the
    files in an order drawn by numpy's default_rng(seed), then per clip a
    random window of `frames` consecutive frames (the last frame repeated
    when the clip is short) from the same generator, a centre crop and a
    bilinear resize to resolution^2; (b, frames, res, res, 3) float32 in
    [0, 1].  PyAV is imported when the dataset is built, and its absence
    raises ImportError; frame folders (VideoFrameFolderDataset) need no
    decoder.  `workers` is taken and not used: the decode stays serial."""

    def __init__(self, root: str, batch_size: int, frames: int = 16, resolution: int = 256,
                 shuffle: bool = True, seed: int = 0, workers: int = 1):
        del workers
        try:
            import av  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "UCF101VideoDataset needs PyAV (`av`), which is not available in this "
                "environment; decode the videos to frame folders and use "
                "VideoFrameFolderDataset instead") from e
        self.root = root
        self.batch_size = batch_size
        self.frames = frames
        self.resolution = resolution
        self.shuffle = shuffle
        self.seed = seed
        self.files = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root) for f in fs
                            if os.path.splitext(f)[1].lower() in (".avi", ".mp4", ".mkv"))
        if not self.files:
            raise FileNotFoundError(f"no video files under {root}")

    def __len__(self):
        return max(1, len(self.files) // self.batch_size)

    def _decode(self, path: str, rng: np.random.Generator) -> np.ndarray:
        import av
        from PIL import Image

        with av.open(path) as container:
            stream = container.streams.video[0]
            imgs = [f.to_image() for f in container.decode(stream)]
        if len(imgs) < self.frames:
            imgs = imgs + [imgs[-1]] * (self.frames - len(imgs))
        start = int(rng.integers(0, len(imgs) - self.frames + 1))
        r, out = self.resolution, []
        for im in imgs[start : start + self.frames]:
            w, h = im.size
            s = min(w, h)
            im = im.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
            out.append(np.asarray(im.resize((r, r), Image.BILINEAR), np.float32) / 255.0)
        return np.stack(out)

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        order = np.arange(len(self.files))
        if self.shuffle:
            rng.shuffle(order)
        for i in range(len(self)):
            idx = order[i * self.batch_size : (i + 1) * self.batch_size]
            yield np.stack([self._decode(self.files[j], rng) for j in idx])


def make_video_dataset(name: str, root: str, batch_size: int, frames: int = 16,
                       resolution: int = 256, **kw):
    """'sky' / 'skytimelapse' / 'folder' -> frame folders, 'ucf101' -> PyAV
    decoding (UCF101VideoDataset)."""
    name = name.lower()
    if name in ("sky", "skytimelapse", "folder"):
        return VideoFrameFolderDataset(root, batch_size, frames=frames, resolution=resolution,
                                       **kw)
    if name == "ucf101":
        return UCF101VideoDataset(root, batch_size, frames=frames, resolution=resolution, **kw)
    raise NotImplementedError(f"video dataset '{name}'")
