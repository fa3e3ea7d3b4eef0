"""Host geometry for the occupancy path (the port's own copy of
ddmi_tpu/geometry: MISE octree refinement, marching cubes, quadric mesh
simplification, and for the 3D metrics a kd-tree, point-in-mesh tests and
voxelisation, bound through ctypes).

`src/geometry.cpp` is the JAX package's C++ core, copied unchanged.  On first
use it is compiled with `g++ -O3` into a shared library under
`build/geometry/` at the root of the checkout (listed in `.gitignore`),
whose file name carries a hash of the source and the flags, and loaded with
`ctypes`; nothing is built at import time.  ctypes releases the GIL during a
call, so octrees advance in parallel threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "geometry.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "geometry"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.Lock()


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libddmi_geometry_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile src/geometry.cpp unless this source is built already; ->
    the library's path.  A failed compile raises with g++'s output."""
    path = lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The geometry library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        L = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        f64p = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(i64)
        L.marching_cubes_run.restype = i64  # opaque result handle
        L.marching_cubes_run.argtypes = [f64p, i64, i64, i64, ctypes.c_double, i64p, i64p]
        L.marching_cubes_get.restype = i64
        L.marching_cubes_get.argtypes = [i64, f64p, i64p]
        L.mise_create.restype = i64
        L.mise_create.argtypes = [i64, i64, ctypes.c_double]
        L.mise_destroy.argtypes = [i64]
        L.mise_query.restype = i64
        L.mise_query.argtypes = [i64, i64p, i64]
        L.mise_update.argtypes = [i64, i64p, f64p, i64]
        L.mise_to_dense.argtypes = [i64, f64p]
        L.mesh_simplify_run.restype = i64  # opaque result handle
        L.mesh_simplify_run.argtypes = [f64p, i64, i64p, i64, i64, ctypes.c_double,
                                        i64p, i64p]
        L.mesh_simplify_get.restype = i64
        L.mesh_simplify_get.argtypes = [i64, f64p, i64p]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        L.kdtree_build.restype = i64
        L.kdtree_build.argtypes = [f64p, i64]
        L.kdtree_query.argtypes = [i64, f64p, i64, f64p, i64p]
        L.kdtree_destroy.argtypes = [i64]
        L.points_in_mesh.restype = i64
        L.points_in_mesh.argtypes = [f64p, i64, i64p, i64, f64p, i64, u8p]
        L.voxelize_mesh.restype = i64
        L.voxelize_mesh.argtypes = [f64p, i64, i64p, i64, i64, u8p]
        _lib = L
        return L


def _f64(a):
    return np.ascontiguousarray(a, np.float64)


def _i64(a):
    return np.ascontiguousarray(a, np.int64)


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def marching_cubes(values: np.ndarray, iso: float) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a dense (nx, ny, nz) grid -> (vertices (v, 3) float64
    in grid coordinates, triangles (t, 3) int64), by marching tetrahedra."""
    L = lib()
    v = _f64(values)
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    handle = L.marching_cubes_run(_fp(v), v.shape[0], v.shape[1], v.shape[2], float(iso),
                                  ctypes.byref(nv), ctypes.byref(nt))
    verts = np.empty((max(nv.value, 1), 3), np.float64)
    tris = np.empty((max(nt.value, 1), 3), np.int64)
    L.marching_cubes_get(handle, _fp(verts), _ip(tris))
    return verts[: nv.value], tris[: nt.value]


class MISE:
    """Multiresolution iso-surface extraction: `query()` -> (n, 3) int64
    grid points still to evaluate, `update(points, values)` with their
    logits, `to_dense()` -> the (res + 1)^3 value grid."""

    def __init__(self, resolution0: int, upsampling_steps: int, threshold: float):
        self._L = lib()
        self._h = self._L.mise_create(resolution0, upsampling_steps, threshold)
        self.res_final = resolution0 * 2**upsampling_steps
        self._max = (self.res_final + 1) ** 3

    def query(self) -> np.ndarray:
        buf = np.empty((self._max, 3), np.int64)
        n = self._L.mise_query(self._h, _ip(buf), self._max)
        return buf[:n].copy()

    def update(self, points: np.ndarray, values: np.ndarray) -> None:
        p, v = _i64(points), _f64(values)
        self._L.mise_update(self._h, _ip(p), _fp(v), p.shape[0])

    def to_dense(self) -> np.ndarray:
        n = self.res_final + 1
        out = np.empty((n, n, n), np.float64)
        self._L.mise_to_dense(self._h, _fp(out))
        return out

    def close(self) -> None:
        if getattr(self, "_h", 0):
            self._L.mise_destroy(self._h)
            self._h = 0

    def __del__(self):
        self.close()


def simplify_mesh(vertices: np.ndarray, faces: np.ndarray, f_target: int,
                  aggressiveness: float = 7.0) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric edge-collapse decimation to about `f_target` faces."""
    L = lib()
    v, t = _f64(vertices), _i64(faces)
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    handle = L.mesh_simplify_run(_fp(v), v.shape[0], _ip(t), t.shape[0], int(f_target),
                                 float(aggressiveness), ctypes.byref(nv), ctypes.byref(nt))
    verts = np.empty((max(nv.value, 1), 3), np.float64)
    tris = np.empty((max(nt.value, 1), 3), np.int64)
    L.mesh_simplify_get(handle, _fp(verts), _ip(tris))
    return verts[: nv.value], tris[: nt.value]


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class KDTree:
    """3D nearest neighbours: `query(q)` -> (Euclidean distances, indices
    into the tree's points) of each query point's nearest point."""

    def __init__(self, points: np.ndarray):
        self._L = lib()
        self._pts = _f64(points)
        self._h = self._L.kdtree_build(_fp(self._pts), self._pts.shape[0])

    def query(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        q = _f64(q)
        dist = np.empty(q.shape[0], np.float64)
        idx = np.empty(q.shape[0], np.int64)
        self._L.kdtree_query(self._h, _fp(q), q.shape[0], _fp(dist), _ip(idx))
        return dist, idx

    def close(self) -> None:
        if getattr(self, "_h", None) is not None:
            self._L.kdtree_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def check_mesh_contains(vertices: np.ndarray, faces: np.ndarray,
                        points: np.ndarray) -> np.ndarray:
    """Whether each point lies inside the triangle mesh (the parity of a z
    ray's crossings) -> (n,) bool."""
    L = lib()
    v, t, q = _f64(vertices), _i64(faces), _f64(points)
    out = np.empty(q.shape[0], np.uint8)
    L.points_in_mesh(_fp(v), v.shape[0], _ip(t), t.shape[0], _fp(q), q.shape[0], _u8p(out))
    return out.astype(bool)


def voxelize_mesh(vertices: np.ndarray, faces: np.ndarray, resolution: int) -> np.ndarray:
    """A mesh with vertices in [0, 1]^3 -> its (res, res, res) bool
    occupancy at the cell centres, x-major."""
    L = lib()
    v, t = _f64(vertices), _i64(faces)
    out = np.empty(resolution**3, np.uint8)
    L.voxelize_mesh(_fp(v), v.shape[0], _ip(t), t.shape[0], resolution, _u8p(out))
    return out.reshape(resolution, resolution, resolution).astype(bool)
