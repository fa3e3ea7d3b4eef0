"""Per-model data fields of the ONet directory layout: the port's own copy
of ddmi_tpu/data/fields.py (numpy only), the field API of the standalone
ConvONet.

A Field loads one aspect of a model directory (query points and their
occupancies, surface point clouds, voxel grids, ...) as numpy arrays;
transforms compose on the loaded dict.  The "patch" fields crop the points
to a query or input volume and attach their coordinates normalised to the
input volume (`normalize_coord`) or their flat plane and grid cell indices
(`coord2index`).  The training loaders (data/shapenet.py) do their own
sampling and do not use these fields.

Every draw comes from an explicit `rng` (np.random.Generator), in the JAX
package's order, so a seed gives the same arrays as there, bit for bit.
Voxel grids are read by the port's data/binvox.py.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ddmi_tpu_torch.data.binvox import read_voxels

Array = np.ndarray
DataDict = Dict[Optional[str], Array]


# ---------------------------------------------------------------------------
# Volume coordinate helpers (convocc/src/common.py:278-342)

_PLANE_AXES = {"xz": (0, 2), "xy": (0, 1), "yz": (1, 2)}


def normalize_coord(p: Array, vol_range, plane: str = "xz") -> Array:
    """Normalize points to [0, 1] within `vol_range` = (lo (3,), hi (3,)),
    then project to a canonical plane ('xz'/'xy'/'yz') or keep 3D ('grid')
    (common.py:278-298).  Does not mutate its input (the reference writes
    in place; callers there defensively `.copy()` — we just don't)."""
    p = np.asarray(p, np.float32)
    lo = np.asarray(vol_range[0], np.float32)
    hi = np.asarray(vol_range[1], np.float32)
    x = (p - lo) / (hi - lo)
    if plane in _PLANE_AXES:
        return x[..., list(_PLANE_AXES[plane])]
    return x


def coord2index(p: Array, vol_range, reso: int, plane: str = "xz") -> Array:
    """Flat cell index of each point in a reso² plane raster (or reso³ grid)
    of the input volume, shape (1, n) like the reference (common.py:317-342,
    including its clamp of indices > reso**k to reso**k — the scatter
    overflow bucket)."""
    x = normalize_coord(p, vol_range, plane=plane)
    x = np.floor(x * reso).astype(np.int64)
    if x.shape[-1] == 2:
        index = x[..., 0] + reso * x[..., 1]
        index = np.minimum(index, reso**2)
    else:
        index = x[..., 0] + reso * (x[..., 1] + reso * x[..., 2])
        index = np.minimum(index, reso**3)
    return index[None]


# ---------------------------------------------------------------------------
# Transforms (convocc/src/data/transforms.py)


class PointcloudNoise:
    """Additive Gaussian noise on the pointcloud (transforms.py:5-28)."""

    def __init__(self, stddev: float):
        self.stddev = stddev

    def __call__(self, data: DataDict,
                 rng: Optional[np.random.Generator] = None) -> DataDict:
        rng = rng or np.random.default_rng()
        out = dict(data)
        pts = data[None]
        out[None] = pts + self.stddev * rng.standard_normal(
            pts.shape).astype(np.float32)
        return out


class SubsamplePointcloud:
    """Random-with-replacement subsample of points+normals
    (transforms.py:30-55)."""

    def __init__(self, n: int):
        self.n = n

    def __call__(self, data: DataDict,
                 rng: Optional[np.random.Generator] = None) -> DataDict:
        rng = rng or np.random.default_rng()
        out = dict(data)
        idx = rng.integers(data[None].shape[0], size=self.n)
        out[None] = data[None][idx]
        out["normals"] = data["normals"][idx]
        return out


class SubsamplePoints:
    """Subsample query points + occupancies.  int N = uniform; (N_out, N_in)
    = stratified by occupancy with a 'volume' fraction extra
    (transforms.py:58-110)."""

    def __init__(self, n: Union[int, Sequence[int]]):
        self.n = n

    def __call__(self, data: DataDict,
                 rng: Optional[np.random.Generator] = None) -> DataDict:
        rng = rng or np.random.default_rng()
        points, occ = data[None], data["occ"]
        out = dict(data)
        if isinstance(self.n, int):
            idx = rng.integers(points.shape[0], size=self.n)
            out[None] = points[idx]
            out["occ"] = occ[idx]
        else:
            n_out, n_in = self.n
            inside = occ >= 0.5
            p0, p1 = points[~inside], points[inside]
            i0 = rng.integers(max(p0.shape[0], 1), size=n_out) % max(
                p0.shape[0], 1)
            i1 = rng.integers(max(p1.shape[0], 1), size=n_in) % max(
                p1.shape[0], 1)
            out[None] = np.concatenate([p0[i0], p1[i1]], 0)
            out["occ"] = np.concatenate(
                [np.zeros(n_out, np.float32), np.ones(n_in, np.float32)], 0)
            out["volume"] = np.float32(inside.sum() / len(inside))
        return out


def compose(*transforms: Callable) -> Callable:
    """Left-to-right transform composition (torchvision.Compose stand-in)."""

    def apply(data, rng=None):
        for t in transforms:
            data = t(data, rng=rng)
        return data

    return apply


# ---------------------------------------------------------------------------
# Fields


class Field:
    """Field interface (convocc/src/data/core.py Field): `load` one model's
    aspect; `check_complete` validates a model dir listing."""

    def load(self, model_path: str, idx: int, category,
             rng: Optional[np.random.Generator] = None):
        raise NotImplementedError

    def check_complete(self, files) -> bool:
        return True


class IndexField(Field):
    """Returns the dataset index itself (fields.py:12-30)."""

    def load(self, model_path, idx, category, rng=None):
        return idx


def _resolve(model_path: str, file_name: str, multi_files: Optional[int],
             rng: Optional[np.random.Generator]) -> str:
    """Single file vs the `multi_files` sharded layout
    `<name>/<name>_NN.npz` (fields.py:59-63)."""
    if multi_files is None:
        return os.path.join(model_path, file_name)
    rng = rng or np.random.default_rng()
    num = int(rng.integers(multi_files))
    return os.path.join(model_path, file_name,
                        f"{file_name}_{num:02d}.npz")


def _load_points_npz(path: str, unpackbits: bool,
                     rng: Optional[np.random.Generator]
                     ) -> Tuple[Array, Array]:
    d = np.load(path)
    points = d["points"]
    if points.dtype == np.float16:  # break grid ties (fields.py:67-70)
        rng = rng or np.random.default_rng()
        points = points.astype(np.float32)
        points += 1e-4 * rng.standard_normal(points.shape).astype(np.float32)
    occ = d["occupancies"]
    if unpackbits:
        occ = np.unpackbits(occ)[: points.shape[0]]
    return points.astype(np.float32), occ.astype(np.float32)


class PointsField(Field):
    """Query points + occupancies from points.npz (fields.py:99-151)."""

    def __init__(self, file_name: str, transform=None,
                 unpackbits: bool = False, multi_files: Optional[int] = None):
        self.file_name = file_name
        self.transform = transform
        self.unpackbits = unpackbits
        self.multi_files = multi_files

    def load(self, model_path, idx, category, rng=None):
        path = _resolve(model_path, self.file_name, self.multi_files, rng)
        points, occ = _load_points_npz(path, self.unpackbits, rng)
        data: DataDict = {None: points, "occ": occ}
        if self.transform is not None:
            data = self.transform(data, rng=rng)
        return data


class PatchPointsField(Field):
    """PointsField cropped to a precomputed query volume, with per-plane
    [0,1] coordinates normalized to the input volume (fields.py:33-97).
    `category` is the `vol` dict: {'query_vol': (lo, hi), 'input_vol':
    (lo, hi), 'plane_type': [...]}."""

    def __init__(self, file_name: str, transform=None,
                 unpackbits: bool = False, multi_files: Optional[int] = None):
        self.file_name = file_name
        self.transform = transform
        self.unpackbits = unpackbits
        self.multi_files = multi_files

    def load(self, model_path, idx, vol, rng=None):
        path = _resolve(model_path, self.file_name, self.multi_files, rng)
        points, occ = _load_points_npz(path, self.unpackbits, rng)
        lo, hi = (np.asarray(v, np.float32) for v in vol["query_vol"])
        keep = np.all((points >= lo) & (points <= hi), axis=-1)
        data: DataDict = {None: points[keep], "occ": occ[keep]}
        if self.transform is not None:
            data = self.transform(data, rng=rng)
        data["normalized"] = {
            key: normalize_coord(data[None], vol["input_vol"], plane=key)
            for key in vol["plane_type"]
        }
        return data


class VoxelsField(Field):
    """Dense voxel grid from a .binvox file (fields.py:153-192)."""

    def __init__(self, file_name: str, transform=None):
        self.file_name = file_name
        self.transform = transform

    def load(self, model_path, idx, category, rng=None):
        voxels = read_voxels(
            os.path.join(model_path, self.file_name)).data.astype(np.float32)
        if self.transform is not None:
            voxels = self.transform(voxels)
        return voxels

    def check_complete(self, files):
        return self.file_name in files


class PointCloudField(Field):
    """Surface pointcloud + normals from pointcloud.npz
    (fields.py:269-321)."""

    def __init__(self, file_name: str, transform=None,
                 multi_files: Optional[int] = None):
        self.file_name = file_name
        self.transform = transform
        self.multi_files = multi_files

    def load(self, model_path, idx, category, rng=None):
        path = _resolve(model_path, self.file_name, self.multi_files, rng)
        d = np.load(path)
        data: DataDict = {
            None: d["points"].astype(np.float32),
            "normals": d["normals"].astype(np.float32),
        }
        if self.transform is not None:
            data = self.transform(data, rng=rng)
        return data

    def check_complete(self, files):
        return self.file_name in files


class PatchPointCloudField(Field):
    """Pointcloud masked to the input volume, with per-plane flat scatter
    indices for sliding-window encoders (fields.py:195-267).  Out-of-volume
    points zero out and index into the reso²/reso³ overflow bucket."""

    def __init__(self, file_name: str, transform=None,
                 transform_add_noise=None, multi_files: Optional[int] = None):
        self.file_name = file_name
        self.transform = transform
        self.multi_files = multi_files

    def load(self, model_path, idx, vol, rng=None):
        path = _resolve(model_path, self.file_name, self.multi_files, rng)
        d = np.load(path)
        points = d["points"].astype(np.float32)
        normals = d["normals"].astype(np.float32)
        data: DataDict = {None: points, "normals": normals}
        if self.transform is not None:
            data = self.transform(data, rng=rng)
            points = data[None]
        lo, hi = (np.asarray(v, np.float32) for v in vol["input_vol"])
        outside = ~np.all((points >= lo) & (points <= hi), axis=-1)
        data["mask"] = outside
        points = points.copy()
        points[outside] = 0.0
        data[None] = points
        index = {}
        reso = vol["reso"]
        for key in vol["plane_type"]:
            ind = coord2index(points, vol["input_vol"], reso=reso, plane=key)
            ind[:, outside] = reso**3 if key == "grid" else reso**2
            index[key] = ind
        data["ind"] = index
        return data

    def check_complete(self, files):
        return self.file_name in files


class PartialPointCloudField(Field):
    """Pointcloud cut by a random axis-aligned slab covering a random
    [part_ratio, 1] fraction of one side's extent (fields.py:324-383)."""

    def __init__(self, file_name: str, transform=None,
                 multi_files: Optional[int] = None, part_ratio: float = 0.7):
        self.file_name = file_name
        self.transform = transform
        self.multi_files = multi_files
        self.part_ratio = part_ratio

    def load(self, model_path, idx, category, rng=None):
        rng = rng or np.random.default_rng()
        path = _resolve(model_path, self.file_name, self.multi_files, rng)
        d = np.load(path)
        points = d["points"].astype(np.float32)
        normals = d["normals"].astype(np.float32)
        side = int(rng.integers(3))
        lo, hi = points[:, side].min(), points[:, side].max()
        length = rng.uniform(self.part_ratio * (hi - lo), hi - lo)
        keep = (points[:, side] - lo) <= length
        data: DataDict = {None: points[keep], "normals": normals[keep]}
        if self.transform is not None:
            data = self.transform(data, rng=rng)
        return data

    def check_complete(self, files):
        return self.file_name in files
