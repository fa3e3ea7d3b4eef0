"""3D evaluation metrics (counterpart of ddmi_tpu/evals/metrics_3d.py):
MMD, COV and 1-NNA of generated shapes over Chamfer distances between
unit-sphere-normalised point clouds, and mesh reconstruction quality
(Chamfer-L1 / L2, F-score, volumetric IoU), and the voxel IoU against
binvox ground truth.

The pairwise Chamfer matrix is plain torch on the given device (the card
unless the caller asks for the CPU; JAX computes it outside any Pallas
kernel), one reference cloud against a chunk of generated clouds at a
time, so that a pair tile of (chunk, p, p) squared distances stays near
`TILE_BYTES`; nearest-neighbour and inside tests run on the host
(geometry/)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ddmi_tpu_torch.core.device import resolve_device

TILE_BYTES = 1 << 28


def normalize_unit_sphere(pc: np.ndarray) -> np.ndarray:
    """Centre each cloud on its mean and scale it into the unit sphere."""
    c = pc.mean(axis=-2, keepdims=True)
    pc = pc - c
    r = np.sqrt((pc**2).sum(-1)).max(axis=-1, keepdims=True)[..., None]
    return pc / np.maximum(r, 1e-12)


def _pair_chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (p, 3) against b (nb, p, 3) -> (nb,) symmetric Chamfer-L2 means:
    the mean over a's points of the squared distance to b's nearest, plus
    the mean over b's points of that to a's nearest."""
    d2 = ((a[None, :, None, 0] - b[:, None, :, 0]) ** 2
          + (a[None, :, None, 1] - b[:, None, :, 1]) ** 2
          + (a[None, :, None, 2] - b[:, None, :, 2]) ** 2)
    return d2.min(2).values.mean(1) + d2.min(1).values.mean(1)


@torch.inference_mode()
def chamfer_matrix(ref: np.ndarray, gen: np.ndarray, tile: int = 32,
                   device="cuda") -> np.ndarray:
    """The (n_ref, n_gen) Chamfer-L2 matrix in fp32, `tile` reference rows
    copied to `device` at a time."""
    dev = resolve_device(device)
    out = np.empty((ref.shape[0], gen.shape[0]), np.float32)
    g = torch.as_tensor(np.asarray(gen, np.float32), device=dev)
    p = max(ref.shape[1], g.shape[1])
    chunk = max(1, TILE_BYTES // (4 * p * p))
    for i in range(0, ref.shape[0], tile):
        rows = torch.as_tensor(np.asarray(ref[i : i + tile], np.float32), device=dev)
        block = torch.stack([torch.cat([_pair_chamfer(a, g[j : j + chunk])
                                        for j in range(0, g.shape[0], chunk)])
                             for a in rows])
        out[i : i + tile] = block.cpu().numpy()
    return out


def mmd_cov_1nna(ref: np.ndarray, gen: np.ndarray, device="cuda") -> Dict[str, float]:
    """MMD (the mean over reference clouds of the Chamfer distance to the
    nearest generated one), COV (the share of reference clouds that are
    some generated cloud's nearest) and 1-NNA (the leave-one-out
    nearest-neighbour accuracy over the union of both sets)."""
    r, g = normalize_unit_sphere(ref), normalize_unit_sphere(gen)
    d = chamfer_matrix(r, g, device=device)
    mmd = float(d.min(axis=1).mean())
    cov = float(len(np.unique(d.argmin(axis=0))) / d.shape[0])
    drr = chamfer_matrix(r, r, device=device)
    dgg = chamfer_matrix(g, g, device=device)
    np.fill_diagonal(drr, np.inf)
    np.fill_diagonal(dgg, np.inf)
    ref_nn_is_ref = drr.min(1) < d.min(1)
    gen_nn_is_gen = dgg.min(1) < d.min(0)
    acc = (ref_nn_is_ref.sum() + gen_nn_is_gen.sum()) / (len(ref_nn_is_ref) + len(gen_nn_is_gen))
    return {"mmd": mmd, "cov": cov, "1nna": float(acc)}


def _nn_dists(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    from ddmi_tpu_torch.geometry import KDTree

    return KDTree(dst).query(src)[0]


def eval_mesh(verts: np.ndarray, tris: np.ndarray, pointcloud_gt: np.ndarray,
              points_iou: np.ndarray, occ_gt: np.ndarray, n_surface: int = 100_000,
              f_threshold: float = 0.01) -> Dict[str, float]:
    """A mesh against its ground truth (convocc's MeshEvaluator): Chamfer-L1
    and -L2 between n_surface surface samples and the ground-truth cloud,
    the F-score at f_threshold, and the IoU of the inside test at
    points_iou against occ_gt > 0.5.  An empty mesh scores inf / 0."""
    from ddmi_tpu_torch.geometry import check_mesh_contains
    from ddmi_tpu_torch.geometry.generation import sample_surface_points

    if len(verts) == 0:
        return {"chamfer_l1": np.inf, "chamfer_l2": np.inf, "fscore": 0.0, "iou": 0.0}
    pc = sample_surface_points(verts, tris, n_surface)
    d_gen2gt = _nn_dists(pc, pointcloud_gt)
    d_gt2gen = _nn_dists(pointcloud_gt, pc)
    chamfer_l1 = 0.5 * (d_gen2gt.mean() + d_gt2gen.mean())
    chamfer_l2 = 0.5 * ((d_gen2gt**2).mean() + (d_gt2gen**2).mean())
    precision = (d_gen2gt < f_threshold).mean()
    recall = (d_gt2gen < f_threshold).mean()
    fscore = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    occ_pred = check_mesh_contains(verts, tris, points_iou)
    occ_gt_b = occ_gt > 0.5
    union = np.logical_or(occ_pred, occ_gt_b).sum()
    inter = np.logical_and(occ_pred, occ_gt_b).sum()
    return {"chamfer_l1": float(chamfer_l1), "chamfer_l2": float(chamfer_l2),
            "fscore": float(fscore), "iou": float(inter / union) if union > 0 else 0.0}


def voxel_iou(occ_logits_fn, voxels_gt: np.ndarray, threshold: float = 0.5,
              chunk: int = 32768) -> float:
    """The voxel IoU against binvox ground truth (convocc's eval_step): the
    model's logits at the cell centres of a [-0.5, 0.5]^3 grid
    (data/binvox.py::voxel_center_points), thresholded at
    logit(threshold), against voxels_gt >= 0.5.  occ_logits_fn maps (chunk,
    3) float32 points (the last chunk zero-padded to the same size) to
    their (chunk,) logits, numpy or torch."""
    from ddmi_tpu_torch.data.binvox import voxel_center_points

    pts = voxel_center_points(voxels_gt.shape)
    logit_thresh = float(np.log(threshold / (1.0 - threshold)))
    pred = np.empty(pts.shape[0], dtype=bool)
    for i in range(0, pts.shape[0], chunk):
        block = pts[i : i + chunk]
        n = block.shape[0]
        if n < chunk:
            block = np.concatenate([block, np.zeros((chunk - n, 3), block.dtype)])
        out = occ_logits_fn(block)
        out = out.float().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        pred[i : i + n] = out[:n] >= logit_thresh
    gt = np.asarray(voxels_gt).reshape(-1) >= 0.5
    union = np.logical_or(pred, gt).sum()
    return float(np.logical_and(pred, gt).sum() / union) if union else 0.0
