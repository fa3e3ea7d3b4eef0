"""Mesh generation from occupancy logits (counterpart of
ddmi_tpu/geometry/generation.py: `MeshGenerator`, `generate_meshes_batched`,
`refine_mesh`, `sample_surface_points`).

An occupancy-logit field is evaluated on a dense grid or refined by MISE
octrees, its iso-surface at the logit threshold log(t) - log(1 - t) is
extracted by marching cubes on the grid padded with one ring of -1e6 (so
the mesh is watertight), the vertices are shifted back and scaled to the
box 1 + padding, and the mesh is optionally simplified and then refined by
gradient descent on its vertices.

`generate_meshes_batched` evaluates through a function of numpy arrays
(float32 points in, logits out), one call per round for all its meshes;
`MeshGenerator` and `refine_mesh` take a differentiable torch function.
The octrees and marching cubes stay on the host, in the C++ library of this
package.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddmi_tpu_torch import geometry

Mesh = Tuple[np.ndarray, np.ndarray]


def logit_threshold(threshold: float) -> float:
    return float(np.log(threshold) - np.log(1 - threshold))


def _dense_grid(resolution0: int, box_size: float) -> np.ndarray:
    """The corner-aligned grid over [-0.5, 0.5]^3 times box_size, (n^3, 3)
    ij-ordered."""
    lin = np.linspace(-0.5, 0.5, resolution0)
    return np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3) * box_size


def _extract(grid: Optional[np.ndarray], logit_thr: float, denom: int, box_size: float,
             simplify_nfaces: Optional[int]) -> Mesh:
    """Marching cubes on the grid padded with a -1e6 ring, vertices mapped
    to world coordinates, then the optional quadric simplification.  A
    missing grid (an inactive slot) gives an empty mesh."""
    if grid is None:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    padded = np.pad(grid, 1, constant_values=-1e6)
    verts, tris = geometry.marching_cubes(padded, logit_thr)
    if len(verts) == 0:
        return verts, tris
    verts = box_size * ((verts - 1.0) / denom - 0.5)
    if simplify_nfaces is not None and len(tris) > simplify_nfaces:
        verts, tris = geometry.simplify_mesh(verts, tris, simplify_nfaces, 5.0)
    return verts, tris


def dirichlet_weights(n: int, generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """(n, 3) barycentric weights from Dirichlet(0.5, 0.5, 0.5)."""
    alpha = torch.full((n, 3), 0.5, dtype=torch.float32, device=device)
    return torch._sample_dirichlet(alpha, generator=generator)


def refinement_loss(v: torch.Tensor, faces: torch.Tensor, eps: torch.Tensor, logits_fn,
                    threshold: float, normal_weight: float) -> torch.Tensor:
    """The refinement objective at vertices v (V, 3), faces (F, 3) and
    barycentric weights eps (F, 3): the mean squared gap between the
    occupancy probability at each face's sample point and `threshold`, plus
    `normal_weight` times the mean squared gap between each face's unit
    normal and the unit negative gradient of the probability there.  The
    gradient enters the graph (create_graph), so the loss's gradient takes
    the field's second derivatives.  logits_fn: (1, n, 3) -> (1, n)."""
    fv = v[faces]                                     # (F, 3, 3)
    fp = (fv * eps[:, :, None]).sum(dim=1)            # (F, 3)
    fn = torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 1], dim=1)
    # the 1e-20 sits inside the sqrt: a zero normal has no NaN gradient
    fn = fn / torch.sqrt((fn**2).sum(dim=1, keepdim=True) + 1e-20)
    face_value = torch.sigmoid(logits_fn(fp[None])[0])
    grad_p, = torch.autograd.grad(face_value.sum(), fp, create_graph=True)
    nt = -grad_p
    nt = nt / torch.sqrt((nt**2).sum(dim=1, keepdim=True) + 1e-20)
    loss_t = ((face_value - threshold) ** 2).mean()
    loss_n = ((fn - nt) ** 2).sum(dim=1).mean()
    return loss_t + normal_weight * loss_n


def rmsprop_step(v: torch.Tensor, g: torch.Tensor, nu: torch.Tensor, lr: float,
                 decay: float = 0.99, eps: float = 1e-8) -> None:
    """One in-place step of optax's rmsprop (the rule the JAX package runs,
    not torch.optim.RMSprop's): nu = decay * nu + (1 - decay) * g^2, then
    v -= lr * g / sqrt(nu + eps), the eps inside the square root and nu
    starting at 0."""
    nu.mul_(decay).add_((1 - decay) * g * g)
    v.sub_(lr * g * torch.rsqrt(nu + eps))


def refine_mesh(verts: np.ndarray, tris: np.ndarray, logits_fn, *, threshold: float = 0.2,
                steps: int = 30, lr: float = 1e-4, normal_weight: float = 0.01,
                generator: Optional[torch.Generator] = None, device="cpu") -> np.ndarray:
    """Gradient refinement of a mesh's vertices (convocc's refine_mesh):
    per step one Dirichlet(0.5, 0.5, 0.5) point per face, drawn from
    `generator`, and one optax-rule RMSprop step on `refinement_loss`.
    logits_fn: a differentiable (1, n, 3) -> (1, n) on `device`.  Returns
    the refined vertices in `verts`' dtype; the faces are unchanged."""
    nv, nf = len(verts), len(tris)
    if nv == 0 or nf == 0 or steps <= 0:
        return verts
    v = torch.tensor(np.asarray(verts, np.float32), device=device)
    faces = torch.tensor(np.asarray(tris, np.int64), device=device)
    nu = torch.zeros_like(v)
    for _ in range(int(steps)):
        eps = dirichlet_weights(nf, generator, device)
        with torch.enable_grad():
            vg = v.detach().requires_grad_(True)
            loss = refinement_loss(vg, faces, eps, logits_fn, threshold, normal_weight)
            g, = torch.autograd.grad(loss, vg)
        rmsprop_step(v, g, nu, lr)
    return v.cpu().numpy().astype(verts.dtype, copy=False)


@dataclasses.dataclass
class MeshGenerator:
    """One mesh from `eval_points_fn`: a differentiable torch function
    (1, n, 3) float32 -> (1, n) logits on `device`, called on
    `points_batch_size` points at a time (the last call zero-padded).  With
    `refinement_step > 0` the extracted (and optionally simplified) mesh is
    refined on the same function (`refine_mesh`), its Dirichlet draws from
    `generator`."""

    eval_points_fn: Callable[[torch.Tensor], torch.Tensor]
    threshold: float = 0.2
    resolution0: int = 64
    upsampling_steps: int = 2
    padding: float = 0.1
    points_batch_size: int = 100_000
    simplify_nfaces: Optional[int] = None
    refinement_step: int = 0
    refinement_lr: float = 1e-4
    device: str = "cpu"
    generator: Optional[torch.Generator] = None

    def _eval(self, pts: np.ndarray) -> np.ndarray:
        n, bs = pts.shape[0], self.points_batch_size
        out = np.empty(n, np.float64)
        chunk = np.zeros((1, bs, 3), np.float32)
        for i in range(0, n, bs):
            m = min(bs, n - i)
            chunk.fill(0.0)
            chunk[0, :m] = pts[i : i + m]
            with torch.no_grad():
                logits = self.eval_points_fn(torch.from_numpy(chunk).to(self.device))
            out[i : i + m] = logits[0, :m].double().cpu().numpy()
        return out

    def generate(self) -> Mesh:
        """-> (vertices (v, 3) in world coordinates, triangles (t, 3))."""
        logit_thr = logit_threshold(self.threshold)
        box_size = 1 + self.padding
        if self.upsampling_steps == 0:
            nx = self.resolution0
            grid = self._eval(_dense_grid(nx, box_size).astype(np.float32)).reshape(nx, nx, nx)
            denom = nx - 1
        else:
            mise = geometry.MISE(self.resolution0, self.upsampling_steps, logit_thr)
            while True:
                pts = mise.query()
                if len(pts) == 0:
                    break
                pf = box_size * (pts.astype(np.float64) / mise.res_final - 0.5)
                mise.update(pts, self._eval(pf.astype(np.float32)))
            grid, denom = mise.to_dense(), mise.res_final
            mise.close()
        verts, tris = _extract(grid, logit_thr, denom, box_size, self.simplify_nfaces)
        if self.refinement_step > 0 and len(tris):
            # simplify, then refine, toward the probability threshold
            verts = refine_mesh(verts, tris, self.eval_points_fn, threshold=self.threshold,
                                steps=self.refinement_step, lr=self.refinement_lr,
                                generator=self.generator, device=self.device)
        return verts, tris


def generate_meshes_batched(eval_group_fn: Callable[[np.ndarray], np.ndarray], group: int, *,
                            threshold: float = 0.2, resolution0: int = 64,
                            upsampling_steps: int = 2, padding: float = 0.1,
                            points_batch_size: int = 100_000,
                            simplify_nfaces: Optional[int] = None, workers: int = 8,
                            active: Optional[Sequence[bool]] = None,
                            stats: Optional[dict] = None) -> List[Mesh]:
    """`group` meshes at once: every active MISE octree advances in
    lockstep, and each round evaluates all their pending points in ONE call
    eval_group_fn((group, points_batch_size, 3) float32) -> (group,
    points_batch_size) logits, slot i holding mesh i's next chunk in query
    order, zero-padded.  Slots with active[i] False are padding: they get no
    octree and an empty mesh.  Octree updates and queries of the meshes a
    round drained, and the final marching cubes, run in a thread pool (the
    C++ calls release the GIL).

    `stats`, when given, receives the round count, the points evaluated
    (real ones, not padding), the number of octrees each round advanced,
    and the seconds spent in the evaluation calls, in the octrees and in
    marching cubes."""
    logit_thr = logit_threshold(threshold)
    box_size = 1 + padding
    bs, g = points_batch_size, group
    active = [True] * g if active is None else list(active)
    grids: List[Optional[np.ndarray]] = [None] * g
    rounds = evaluated = 0
    t_octree = t_eval = 0.0
    advanced: List[int] = []
    if upsampling_steps == 0:
        nx = resolution0
        base = _dense_grid(nx, box_size).astype(np.float32)
        n = base.shape[0]
        vals = np.empty((g, n), np.float64)
        for o in range(0, n, bs):
            k = min(bs, n - o)
            chunk = np.zeros((bs, 3), np.float32)
            chunk[:k] = base[o : o + k]
            t0 = time.perf_counter()
            vals[:, o : o + k] = np.asarray(eval_group_fn(
                np.ascontiguousarray(np.broadcast_to(chunk, (g, bs, 3)))))[:, :k]
            t_eval += time.perf_counter() - t0
            rounds += 1
            evaluated += k * sum(active)
        for i in range(g):
            if active[i]:
                grids[i] = vals[i].reshape(nx, nx, nx)
        denom = nx - 1
    else:
        t0 = time.perf_counter()
        mises = [geometry.MISE(resolution0, upsampling_steps, logit_thr) if a else None
                 for a in active]
        denom = resolution0 * 2**upsampling_steps
        # per mesh: [int points, float64 values, offset]; None once drained
        pend = [[m.query(), None, 0] if m is not None else None for m in mises]
        for st in pend:
            if st is not None:
                st[1] = np.empty(len(st[0]), np.float64)
        t_octree += time.perf_counter() - t0

        def advance(i):
            m = mises[i]
            pts, vals, _ = pend[i]
            m.update(pts, vals)
            nxt = m.query()
            if len(nxt) == 0:
                grids[i] = m.to_dense()
                pend[i] = None
            else:
                pend[i] = [nxt, np.empty(len(nxt), np.float64), 0]

        batch = np.zeros((g, bs, 3), np.float32)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            while any(p is not None for p in pend):
                batch.fill(0.0)
                took = []
                for i, st in enumerate(pend):
                    if st is None:
                        continue
                    pts, _, off = st
                    chunk = pts[off : off + bs]
                    batch[i, : len(chunk)] = box_size * (chunk.astype(np.float64) / denom - 0.5)
                    took.append((i, len(chunk)))
                t0 = time.perf_counter()
                out = np.asarray(eval_group_fn(batch))
                t_eval += time.perf_counter() - t0
                rounds += 1
                finished = []
                for i, m_taken in took:
                    pts, vals, off = pend[i]
                    vals[off : off + m_taken] = out[i, :m_taken]
                    pend[i][2] = off + m_taken
                    evaluated += m_taken
                    if pend[i][2] >= len(pts):
                        finished.append(i)
                t0 = time.perf_counter()
                list(pool.map(advance, finished))
                t_octree += time.perf_counter() - t0
                advanced.append(len(finished))
        for m in mises:
            if m is not None:
                m.close()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        meshes = list(pool.map(
            lambda grid: _extract(grid, logit_thr, denom, box_size, simplify_nfaces), grids))
    if stats is not None:
        stats.update(rounds=rounds, points=evaluated, advanced=advanced, eval_s=t_eval,
                     octree_s=t_octree, marching_cubes_s=time.perf_counter() - t0)
    return meshes


def sample_surface_points(verts: np.ndarray, tris: np.ndarray, n: int,
                          seed: int = 0) -> np.ndarray:
    """n points drawn uniformly on the mesh's surface (area-weighted faces,
    uniform barycentric points), from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    idx = rng.choice(len(tris), n, p=areas / areas.sum())
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return a[idx] + u * (b[idx] - a[idx]) + v * (c[idx] - a[idx])
