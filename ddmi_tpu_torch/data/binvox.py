"""Binvox voxel-file reader/writer (vectorized RLE): the port's own copy of
ddmi_tpu/data/binvox.py (numpy only), in place of the reference's
convocc/src/utils/binvox_rw.py.  Format: ASCII header

    #binvox 1
    dim <dx> <dy> <dz>
    translate <tx> <ty> <tz>
    scale <s>
    data

followed by byte pairs (value, run_length) run-length encoding the voxel
grid in x-z-y scan order.  ``read_voxels`` returns the grid transposed to
x-y-z indexing (``grid[x, y, z]``), matching the reference's
``read_as_3d_array(fix_coords=True)`` (binvox_rw.py:118-153) that
``VoxelsField`` consumes (convocc/src/data/fields.py:153-183).

Voxel (i, j, k) maps to world coordinates
``scale * ((i + 0.5) / dims) + translate`` per the format docs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Tuple, Union

import numpy as np


@dataclass
class BinvoxModel:
    """Dense boolean voxel grid + the binvox world-transform metadata."""

    data: np.ndarray  # (dx, dy, dz) bool, x-y-z indexing
    translate: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale: float = 1.0

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.data.shape)


def _read_header(fp: BinaryIO):
    magic = fp.readline().strip()
    if not magic.startswith(b"#binvox"):
        raise IOError(f"not a binvox file (magic line {magic!r})")
    dims = translate = scale = None
    while True:
        line = fp.readline()
        if not line:
            raise IOError("binvox header ended before 'data' line")
        parts = line.strip().split()
        if not parts:
            continue
        key = parts[0]
        if key == b"dim":
            dims = [int(v) for v in parts[1:4]]
        elif key == b"translate":
            translate = [float(v) for v in parts[1:4]]
        elif key == b"scale":
            scale = float(parts[1])
        elif key == b"data":
            break
    if dims is None:
        raise IOError("binvox header missing 'dim' line")
    return dims, translate or [0.0, 0.0, 0.0], 1.0 if scale is None else scale


def read_voxels(f: Union[str, BinaryIO]) -> BinvoxModel:
    """Read a .binvox file into a dense (dx, dy, dz) bool grid (x-y-z)."""
    if isinstance(f, str):
        with open(f, "rb") as fp:
            return read_voxels(fp)
    dims, translate, scale = _read_header(f)
    raw = np.frombuffer(f.read(), dtype=np.uint8)
    if raw.size % 2 != 0:
        raise IOError("binvox RLE payload has odd length")
    values, runs = raw[0::2], raw[1::2]
    flat = np.repeat(values, runs).astype(bool)
    n = int(np.prod(dims))
    if flat.size != n:
        raise IOError(
            f"binvox RLE decodes to {flat.size} voxels, header says {n}"
        )
    # file scan order is x-z-y; expose x-y-z indexing
    grid = flat.reshape(dims[0], dims[2], dims[1]).transpose(0, 2, 1)
    return BinvoxModel(grid, tuple(translate), scale)


def write_voxels(f: Union[str, BinaryIO], model: BinvoxModel) -> None:
    """Write a dense bool grid as .binvox (RLE, runs capped at 255)."""
    if isinstance(f, str):
        with open(f, "wb") as fp:
            write_voxels(fp, model)
        return
    data = np.asarray(model.data, dtype=bool)
    dx, dy, dz = data.shape
    tx, ty, tz = model.translate
    header = (
        f"#binvox 1\ndim {dx} {dy} {dz}\n"
        f"translate {tx} {ty} {tz}\nscale {model.scale}\ndata\n"
    )
    f.write(header.encode("ascii"))
    flat = data.transpose(0, 2, 1).ravel()  # x-y-z -> x-z-y scan order
    if flat.size == 0:
        return
    # vectorized run-length encoding
    boundaries = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate(([0], boundaries))
    lengths = np.diff(np.concatenate((starts, [flat.size])))
    values = flat[starts].astype(np.uint8)
    # split runs longer than the format's 255 cap
    n_chunks = (lengths + 254) // 255
    values = np.repeat(values, n_chunks)
    chunked = []
    for length, chunks in zip(lengths, n_chunks):
        chunked.extend([255] * (chunks - 1))
        chunked.append(length - 255 * (chunks - 1))
    pairs = np.empty(2 * values.size, dtype=np.uint8)
    pairs[0::2] = values
    pairs[1::2] = np.asarray(chunked, dtype=np.uint8)
    f.write(pairs.tobytes())


def voxel_center_points(dims: Tuple[int, int, int]) -> np.ndarray:
    """Cell-center query points of a voxel grid over [-0.5, 0.5]^3 in the
    object-coordinate convention the reference evaluates voxel IoU at
    (make_3d_grid((-0.5 + 1/2D,)*3, (0.5 - 1/2D,)*3, dims),
    convocc/src/conv_onet/training.py:96-103).  Returns (prod(dims), 3)
    float32 in the grid's x-y-z raster order."""
    axes = [
        np.linspace(-0.5 + 0.5 / d, 0.5 - 0.5 / d, d, dtype=np.float32)
        for d in dims
    ]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
