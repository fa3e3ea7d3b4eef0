"""srn-cars NeRF data (the port's own copy of ddmi_tpu/data/nerf.py: the
same numpy draws, so the same seed gives bit-identical batches).

One `.npz` per object holds `images` (views, H, W, C), `cam_poses` (views,
4, 4) and `data` (N, 6), a point cloud of xyz and rgb.  The first 80% of
the objects in sorted order train and the rest test (a deterministic
prefix, where the reference samples 80% with pandas).  A batch is a dict:
`points` (b, pointcloud_n, 6), the cloud resampled with replacement and
its xyz jittered by pointcloud_noise; `image` (b, H, W, 3) in [0, 1], one
view drawn per object; `pose` (b, 4, 4), that view's camera-to-world.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator

import numpy as np


class NeRFShapeNetDataset:
    """Dict batches of srn-cars objects from `root`, loaded by a prefetch
    thread (depth `prefetch`); each epoch shuffles the objects with a
    generator seeded seed + epoch, whose draws the items then take."""

    def __init__(self, root: str, batch_size: int = 1, train: bool = True,
                 pointcloud_n: int = 3000, pointcloud_noise: float = 0.005,
                 shuffle: bool = True, seed: int = 0, num_processes: int = 1,
                 process_index: int = 0, prefetch: int = 2):
        files = sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".npz"))
        if not files:
            raise FileNotFoundError(f"no .npz objects under {root}")
        cut = int(0.8 * len(files))
        files = files[:cut] if train else files[cut:]
        self.files = files[process_index::num_processes]
        self.num_processes = num_processes  # the trainer reads its batches as one rank's
        self.batch_size = batch_size
        self.pointcloud_n = pointcloud_n
        self.pointcloud_noise = pointcloud_noise
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        return max(1, len(self.files) // self.batch_size)

    def _load(self, path: str, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        d = np.load(path)
        images, poses = d["images"], d["cam_poses"]
        pts = d["data"].astype(np.float32)
        cloud = pts[rng.integers(0, pts.shape[0], self.pointcloud_n)]
        cloud[:, :3] += self.pointcloud_noise * rng.standard_normal(
            (self.pointcloud_n, 3)).astype(np.float32)
        v = rng.integers(0, images.shape[0])
        img = images[v].astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        return {"points": cloud, "image": img[..., :3], "pose": poses[v].astype(np.float32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            rng = np.random.default_rng(self.seed + self._epoch)
            order = np.arange(len(self.files))
            if self.shuffle:
                rng.shuffle(order)
            try:
                bs = self.batch_size
                for i in range(0, len(order) - bs + 1, bs):
                    items = [self._load(self.files[k], rng) for k in order[i : i + bs]]
                    q.put({k: np.stack([it[k] for it in items]) for k in items[0]})
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        self._epoch += 1
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


class SyntheticNeRF:
    """Random coloured spheres for tests and the chip run: per scene
    `n_points` points on a sphere of radius 0.8 coloured by their normal,
    one uniform-noise image of `resolution`^2 and a camera at z = 4."""

    def __init__(self, batch_size: int = 1, n_points: int = 500, resolution: int = 32,
                 length: int = 4, seed: int = 0):
        self.batch_size = batch_size
        self.n_points = n_points
        self.resolution = resolution
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __iter__(self):
        for i in range(self.length):
            rng = np.random.default_rng(self.seed * 3571 + i)
            r = self.resolution
            pts_list, img_list, pose_list = [], [], []
            for _ in range(self.batch_size):
                d = rng.standard_normal((self.n_points, 3))
                d /= np.linalg.norm(d, axis=1, keepdims=True)
                xyz = (0.8 * d).astype(np.float32)
                rgb = ((d + 1) / 2).astype(np.float32)
                pts_list.append(np.concatenate([xyz, rgb], -1))
                img_list.append(rng.uniform(0, 1, (r, r, 3)).astype(np.float32))
                pose = np.eye(4, dtype=np.float32)
                pose[2, 3] = 4.0
                pose_list.append(pose)
            yield {"points": np.stack(pts_list), "image": np.stack(img_list),
                   "pose": np.stack(pose_list)}
