"""Iterative closest point (counterpart of ddmi_tpu/utils/icp.py, the
convocc/src/utils/icp.py equivalent; numpy and scipy).

Same algorithm and interface as the reference (Kabsch/SVD best-fit rigid
transform + nearest-neighbor correspondence loop, icp.py:5-121); the
sklearn NearestNeighbors dependency is replaced by scipy's cKDTree (scipy
is already a dependency of the port).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def best_fit_transform(A: np.ndarray, B: np.ndarray):
    """Least-squares rigid transform mapping corresponding points A -> B in
    m dimensions.  Returns (T homogeneous (m+1, m+1), R (m, m), t (m,))."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch: {A.shape} vs {B.shape}")
    m = A.shape[1]
    centroid_A = A.mean(axis=0)
    centroid_B = B.mean(axis=0)
    H = (A - centroid_A).T @ (B - centroid_B)
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:  # reflection -> proper rotation
        Vt[m - 1, :] *= -1
        R = Vt.T @ U.T
    t = centroid_B - R @ centroid_A
    T = np.identity(m + 1)
    T[:m, :m] = R
    T[:m, m] = t
    return T, R, t


def nearest_neighbor(src: np.ndarray, dst: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Euclidean nearest neighbor in dst for each src point:
    (distances (n,), indices (n,))."""
    dist, idx = cKDTree(np.asarray(dst)).query(np.asarray(src), k=1)
    return np.ravel(dist), np.ravel(idx)


def icp(A: np.ndarray, B: np.ndarray,
        init_pose: Optional[np.ndarray] = None,
        max_iterations: int = 20, tolerance: float = 0.001):
    """Best-fit rigid transform mapping pointcloud A onto B.  Returns
    (T homogeneous, nearest-neighbor distances at exit, iterations run)."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"dim mismatch: {A.shape} vs {B.shape}")
    m = A.shape[1]
    src = np.ones((m + 1, A.shape[0]))
    dst = np.ones((m + 1, B.shape[0]))
    src[:m, :] = A.T
    dst[:m, :] = B.T
    if init_pose is not None:
        src = init_pose @ src

    prev_error = 0.0
    distances = np.zeros(A.shape[0])
    i = 0
    for i in range(max_iterations):
        distances, indices = nearest_neighbor(src[:m, :].T, dst[:m, :].T)
        T, _, _ = best_fit_transform(src[:m, :].T, dst[:m, indices].T)
        src = T @ src
        mean_error = float(np.mean(distances))
        if abs(prev_error - mean_error) < tolerance:
            break
        prev_error = mean_error

    T, _, _ = best_fit_transform(A, src[:m, :].T)
    return T, distances, i
