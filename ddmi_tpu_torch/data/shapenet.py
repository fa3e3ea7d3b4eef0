"""ShapeNet occupancy data in the ONet layout (the port's own copy of
ddmi_tpu/data/shapenet.py: the same numpy draws, so the same seed gives
bit-identical batches).

`root/<category>/<split>.lst` names the models of a split (without it,
every model directory of the category).  A model directory holds
`points.npz` (`points`, float16 or float32, and `occupancies`, bit-packed)
and `pointcloud.npz` (`points`), and with `voxels_file` a .binvox grid.  A
batch is a dict: `points` (b, points_subsample, 3) query points drawn with
replacement and `occ` (b, points_subsample) their occupancies in {0, 1};
`inputs` (b, pointcloud_n, 3), the surface cloud resampled with
replacement and jittered by pointcloud_noise; with `voxels_file`,
`voxels` (b, dx, dy, dz) in {0, 1}.

The JAX loader tests the points' dtype for float16 after casting them to
float32, so the 1e-4 jitter the reference's PointsField gives float16
points never runs there; the port keeps JAX's draws, jitter-free.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from ddmi_tpu_torch.data.binvox import read_voxels


class ShapeNetOccupancyDataset:
    """Dict batches of ShapeNet models under `root`, loaded by a prefetch
    thread (depth `prefetch`); each epoch shuffles the models with a
    generator seeded seed + epoch, whose draws the items then take."""

    def __init__(self, root: str, batch_size: int, split: str = "train",
                 categories: Optional[List[str]] = None, points_subsample: int = 2048,
                 pointcloud_n: int = 3000, pointcloud_noise: float = 0.005,
                 shuffle: bool = True, seed: int = 0, num_processes: int = 1,
                 process_index: int = 0, prefetch: int = 2, voxels_file: Optional[str] = None):
        self.root = root
        if categories is None:
            categories = sorted(d for d in os.listdir(root)
                                if os.path.isdir(os.path.join(root, d)))
        self.models: List[str] = []
        for c in categories:
            lst = os.path.join(root, c, f"{split}.lst")
            if os.path.exists(lst):
                with open(lst) as f:
                    names = [line.strip() for line in f if line.strip()]
            else:
                names = sorted(d for d in os.listdir(os.path.join(root, c))
                               if os.path.isdir(os.path.join(root, c, d)))
            self.models += [os.path.join(root, c, m) for m in names]
        self.models = self.models[process_index::num_processes]
        self.num_processes = num_processes  # the trainer reads its batches as one rank's
        if not self.models:
            raise FileNotFoundError(f"no models under {root}")
        self.batch_size = batch_size
        self.points_subsample = points_subsample
        self.pointcloud_n = pointcloud_n
        self.pointcloud_noise = pointcloud_noise
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.voxels_file = voxels_file
        self._epoch = 0

    def __len__(self):
        return max(1, len(self.models) // self.batch_size)

    def _load_model(self, path: str, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        pts_file = np.load(os.path.join(path, "points.npz"))
        points = pts_file["points"].astype(np.float32)
        occ = np.unpackbits(pts_file["occupancies"])[: points.shape[0]]
        idx = rng.integers(0, points.shape[0], self.points_subsample)
        points, occ = points[idx], occ[idx].astype(np.float32)
        cloud = np.load(os.path.join(path, "pointcloud.npz"))["points"].astype(np.float32)
        cloud = cloud[rng.integers(0, cloud.shape[0], self.pointcloud_n)]
        cloud += self.pointcloud_noise * rng.standard_normal(cloud.shape).astype(np.float32)
        item = {"points": points, "occ": occ, "inputs": cloud}
        if self.voxels_file is not None:
            item["voxels"] = read_voxels(
                os.path.join(path, self.voxels_file)).data.astype(np.float32)
        return item

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            rng = np.random.default_rng(self.seed + self._epoch)
            order = np.arange(len(self.models))
            if self.shuffle:
                rng.shuffle(order)
            try:
                bs = self.batch_size
                for i in range(0, len(order) - bs + 1, bs):
                    items = [self._load_model(self.models[k], rng) for k in order[i : i + bs]]
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


class SyntheticOccupancy:
    """Random ellipsoids for tests and the chip run: `inputs` noisy surface
    samples, `points` uniform in [-0.5, 0.5]^3, `occ` their inside test."""

    def __init__(self, batch_size: int, n_points: int = 2048, n_cloud: int = 3000,
                 length: int = 8, seed: int = 0):
        self.batch_size = batch_size
        self.n_points = n_points
        self.n_cloud = n_cloud
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __iter__(self):
        for i in range(self.length):
            rng = np.random.default_rng(self.seed * 6007 + i)
            b = self.batch_size
            radii = rng.uniform(0.15, 0.4, (b, 1, 3)).astype(np.float32)
            d = rng.standard_normal((b, self.n_cloud, 3)).astype(np.float32)
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            cloud = d * radii + 0.005 * rng.standard_normal((b, self.n_cloud, 3)).astype(
                np.float32)
            pts = rng.uniform(-0.5, 0.5, (b, self.n_points, 3)).astype(np.float32)
            occ = (np.sum((pts / radii) ** 2, -1) <= 1.0).astype(np.float32)
            yield {"points": pts, "occ": occ, "inputs": cloud}
