"""Image-folder dataset with background prefetch (the port's own copy of
ddmi_tpu/data/image_folder.py: the same file order, shuffle and flip
draws, so a seed gives bit-identical batches).

PIL decodes on host threads (imported on first load, so that a run that
reads no image folder never needs it); the files are split over
`num_processes` by `process_index`, and a prefetch queue overlaps the
decode with the card's work."""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List

import numpy as np

_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}


def _list_images(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in _EXTS:
                out.append(os.path.join(dirpath, f))
    out.sort()
    return out


class ImageFolderDataset:
    """Yields NHWC float32 batches in [0, 1]: each image LANCZOS-resized to
    resolution^2 when it is not that size, and flipped left-right where a
    coin says so (`random_flip`).  Each epoch shuffles the files with
    numpy's default_rng(seed + epoch), which then draws the batch's flip
    coins, serially, so any worker count gives the same stream."""

    def __init__(self, root: str, batch_size: int, resolution: int = 512,
                 random_flip: bool = True, shuffle: bool = True, seed: int = 0,
                 num_processes: int = 1, process_index: int = 0, prefetch: int = 2,
                 drop_last: bool = True, workers: int = 1):
        self.files = _list_images(root)
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")
        self.files = self.files[process_index::num_processes]
        self.num_processes = num_processes  # the trainer reads its batches as one rank's
        self.batch_size = batch_size
        self.resolution = resolution
        self.random_flip = random_flip
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.workers = max(1, workers)
        self._epoch = 0

    def __len__(self):
        n = len(self.files) // self.batch_size
        if not self.drop_last and len(self.files) % self.batch_size:
            n += 1
        return n

    def _load(self, path: str, flip: bool) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB")
        r = self.resolution
        if img.size != (r, r):
            img = img.resize((r, r), Image.LANCZOS)
        arr = np.asarray(img, np.float32) / 255.0
        if flip:
            arr = arr[:, ::-1]
        return arr

    def _batches(self) -> Iterator[np.ndarray]:
        from concurrent.futures import ThreadPoolExecutor

        rng = np.random.default_rng(self.seed + self._epoch)
        order = np.arange(len(self.files))
        if self.shuffle:
            rng.shuffle(order)
        bs = self.batch_size
        # PIL's decode releases the GIL, so threads spread it over the cores
        pool = ThreadPoolExecutor(self.workers) if self.workers > 1 else None
        try:
            for i in range(0, len(order) - (bs - 1 if self.drop_last else 0), bs):
                idx = order[i : i + bs]
                paths = [self.files[k] for k in idx]
                flips = (rng.random(len(idx)) < 0.5 if self.random_flip
                         else np.zeros(len(idx), bool))
                if pool is not None:
                    imgs = list(pool.map(self._load, paths, flips))
                else:
                    imgs = [self._load(p, f) for p, f in zip(paths, flips)]
                yield np.stack(imgs)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
        self._epoch += 1

    def __iter__(self) -> Iterator[np.ndarray]:
        """One epoch, built ahead by a background thread (depth `prefetch`);
        a loader error is raised again here."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel, failure = object(), []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:  # raised again in the consumer
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]
