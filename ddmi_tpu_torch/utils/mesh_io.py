"""Pointcloud / mesh file IO (counterpart of ddmi_tpu/utils/mesh_io.py, the
convocc/src/utils/io.py equivalent; numpy only).

The reference uses the `plyfile` package for PLY export/import and a
hand-rolled OFF reader (convocc/src/utils/io.py:6-24, 27-112).  The port
does not depend on `plyfile`: the PLY subset the reference actually
exercises — a single `vertex` element with float32 x/y/z, ascii or
binary_little_endian — is implemented directly.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def export_pointcloud(vertices: np.ndarray, out_file: str,
                      as_text: bool = True) -> None:
    """Write an (n, 3) pointcloud as a PLY vertex element
    (io.py:export_pointcloud).  `as_text=False` writes binary LE float32."""
    vertices = np.ascontiguousarray(np.asarray(vertices, np.float32))
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError(f"expected (n, 3) vertices, got {vertices.shape}")
    fmt = "ascii" if as_text else "binary_little_endian"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "end_header\n"
    )
    with open(out_file, "wb") as f:
        f.write(header.encode("ascii"))
        if as_text:
            for x, y, z in vertices:
                f.write(f"{x:g} {y:g} {z:g}\n".encode("ascii"))
        else:
            f.write(vertices.astype("<f4").tobytes())


def load_pointcloud(in_file: str) -> np.ndarray:
    """Read the x/y/z properties of a PLY `vertex` element back as (n, 3)
    float32 (io.py:load_pointcloud).  Handles ascii and binary LE files with
    arbitrary extra float32 vertex properties (e.g. normals)."""
    with open(in_file, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{in_file}: not a PLY file")
        fmt = None
        n_vertex = None
        props: List[str] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{in_file}: truncated PLY header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                in_vertex = tok[1] == b"vertex"
                if in_vertex:
                    n_vertex = int(tok[2])
            elif tok[0] == b"property" and in_vertex:
                if tok[1] not in (b"float", b"float32"):
                    raise ValueError(
                        f"{in_file}: unsupported vertex property type "
                        f"{tok[1].decode()}"
                    )
                props.append(tok[2].decode())
            elif tok[0] == b"end_header":
                break
        if n_vertex is None:
            raise ValueError(f"{in_file}: no vertex element")
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append([float(v) for v in f.readline().split()])
            data = np.asarray(rows, np.float32)
        elif fmt == "binary_little_endian":
            raw = f.read(4 * len(props) * n_vertex)
            data = np.frombuffer(raw, "<f4").reshape(n_vertex, len(props))
        else:
            raise ValueError(f"{in_file}: unsupported PLY format {fmt}")
    cols = [props.index(c) for c in ("x", "y", "z")]
    return np.ascontiguousarray(data[:, cols].astype(np.float32))


def read_off(path: str) -> Tuple[List[List[float]], List[List[int]]]:
    """Read an OFF triangle mesh as (vertices, faces) lists, faces carrying
    the leading vertex count exactly like the reference
    (io.py:read_off:27-112) — including the ModelNet quirk where 'OFF' and
    the counts share the first line."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "r") as fp:
        lines = [ln.strip() for ln in fp if ln.strip()]
    if lines[0][:3].upper() != "OFF":
        raise ValueError(f"{path}: invalid OFF file")
    if len(lines[0]) > 3:  # ModelNet bug: counts on the OFF line
        counts = lines[0][3:].split()
        start = 1
    else:
        counts = lines[1].split()
        start = 2
    n_vert, n_face = int(counts[0]), int(counts[1])
    vertices = []
    for i in range(n_vert):
        v = [float(t) for t in lines[start + i].split()]
        if len(v) != 3:
            raise ValueError(f"{path}: vertex {i} has {len(v)} coords")
        vertices.append(v)
    faces = []
    for i in range(n_face):
        face = [int(t) for t in lines[start + n_vert + i].split()]
        if face[0] != len(face) - 1 or face[0] != 3:
            raise ValueError(f"{path}: face {i} is not a triangle: {face}")
        if any(ix < 0 or ix >= n_vert for ix in face[1:]):
            raise ValueError(f"{path}: face {i} indexes a missing vertex")
        faces.append(face)
    return vertices, faces


def write_off(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """Write an OFF triangle mesh (counterpart of read_off)."""
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    with open(path, "w") as f:
        f.write(f"OFF\n{len(verts)} {len(tris)} 0\n")
        for v in verts:
            f.write(f"{v[0]:g} {v[1]:g} {v[2]:g}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
