"""In-process batching sampling service (counterpart of
ddmi_tpu/serve/server.py::SamplerService, all four domains: image, video,
NeRF and occupancy; no HTTP front end).

Concurrent `generate` calls are coalesced into one device batch of
`service_batch` samples (a linger window collects them): a DDIM run costs
the same for 1 or `service_batch` samples.  Each request's initial latent is
drawn on the host from its own seed (numpy, the same draw as the JAX
service), so a seed reproduces its sample however requests were batched.
The image INR's NoiseInjection draws are keyed by the first seed in the
batch; the video and NeRF renders draw none.  An occupancy batch samples its
latents on the card, decodes their pyramids once and extracts every mesh
of the batch in lockstep (geometry/generation.py::generate_meshes_batched):
one INR3D evaluation on the card per round for all meshes, the octrees and
marching cubes on the host.
"""

from __future__ import annotations

import collections
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ddmi_tpu_torch.domains.image import ImagePipeline
from ddmi_tpu_torch.domains.nerf import NeRFPipeline
from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline
from ddmi_tpu_torch.domains.video import VideoPipeline


class _Request:
    __slots__ = ("n", "seed", "event", "result", "error", "cancelled")

    def __init__(self, n: int, seed: int):
        self.n = n
        self.seed = seed
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.cancelled = False


class SamplerService:
    """Serves uint8 samples of an image config, (n, res, res, 3), of a
    video config, (n, frames, res, res, 3) at the VAE's resolution, or of a
    NeRF config, (n, n_views, res, res, 3): a spherical camera path of
    `n_views` views at `resolution` (default 128) per scene; or meshes of an
    occupancy config, a list of n (verts, faces), extracted with the
    config's generation settings (data.conv_config) updated by
    `mesh_kwargs` (threshold, resolution0, upsampling_steps,
    points_batch_size, simplify_nfaces, refinement_step, workers); `res`
    is then the final MISE grid, resolution0 * 2^upsampling_steps.

    `state_dicts` holds the port state_dicts for the pipeline's
    `load_state_dicts` (unet / vae / mlp / mixing_logit, and pointnet for
    occupancy).  Without them the service refuses to start unless
    `allow_init`, in which case it serves the seeded, untrained
    initialisation (for latency measurement and smoke runs; it warns, and
    `initialized` is True).  It runs on the card unless
    `device="cpu"`.  Parameters are bf16 on a CUDA device (the DDIM carry
    and the mixing logit stay fp32) and fp32 on the CPU."""

    def __init__(self, cfg, service_batch: int = 8, resolution: Optional[int] = None,
                 linger_ms: float = 20.0, device="cuda",
                 state_dicts: Optional[dict] = None, allow_init: bool = False,
                 n_views: int = 8, mesh_kwargs: Optional[dict] = None):
        self.domain = cfg.data.domain
        if self.domain not in ("image", "video", "nerf", "occupancy"):
            raise ValueError(f"unknown domain {self.domain!r}")
        self.cfg = cfg
        self.batch = int(service_batch)
        self._linger = max(0.0, linger_ms) / 1000.0
        u = cfg.model.ddpmconfig
        if self.domain == "video":
            pipe = VideoPipeline(cfg, device=device)
            self.res = pipe.res
            self._noise_shape = (pipe.n_latent_tokens, u.channels)
        elif self.domain == "nerf":
            pipe = NeRFPipeline(cfg, device=device)
            self.res = int(resolution or 128)
            self.n_views = int(n_views)
            r = pipe.latent_res
            self._noise_shape = (r, r, u.channels)  # NHWC, as JAX draws it
        elif self.domain == "occupancy":
            pipe = OccupancyPipeline(cfg, device=device)
            self.mesh_kwargs = {**pipe.generation_kwargs, **(mesh_kwargs or {})}
            self.res = int(self.mesh_kwargs["resolution0"]
                           * 2 ** self.mesh_kwargs["upsampling_steps"])
            r = pipe.latent_res
            self._noise_shape = (r, r, u.channels)  # NHWC, as JAX draws it
        else:
            pipe = ImagePipeline(cfg, device=device)
            self.res = int(resolution or cfg.data.test_resolution)
            self._noise_shape = (u.image_size, u.image_size, u.channels)  # NHWC, as JAX draws it
        self.initialized = state_dicts is None
        if state_dicts is None:
            if not allow_init:
                raise ValueError("no state_dicts given; pass allow_init=True to serve "
                                 "the untrained initialisation")
            warnings.warn(
                "serving freshly-initialized (UNTRAINED) params because "
                "allow_init=True; outputs are noise, for latency benchmarking / "
                "smoke deployment only", stacklevel=2,
            )
        else:
            pipe.load_state_dicts(**state_dicts)
        pipe.cast(torch.bfloat16 if pipe.device.type == "cuda" else torch.float32)
        self.pipe = pipe

        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._stop = False
        self._worker_thread = threading.Thread(target=self._worker, daemon=True)
        self._worker_thread.start()

    # ------------------------------------------------------------- public

    def warmup(self) -> None:
        """Run one batch so the first real request does not pay start-up."""
        noise = torch.zeros((self.batch,) + self._noise_shape, device=self.pipe.device)
        self._sample(noise, 0)
        if self.pipe.device.type == "cuda":
            torch.cuda.synchronize(self.pipe.device)

    def _sample(self, noise: torch.Tensor, seed: int) -> torch.Tensor:
        """One service batch from its initial latent: pixels in [0, 1], or
        for occupancy the latents (batch, C, r, r)."""
        if self.domain == "occupancy":
            return self.pipe.sample_latents(self.batch,
                                            noise=noise.permute(0, 3, 1, 2).contiguous())
        if self.domain == "video":
            return self.pipe.sample_videos(self.batch, noise=noise)
        if self.domain == "nerf":
            return self.pipe.sample_nerfs(self.batch, self.n_views, self.res, self.res,
                                          noise=noise.permute(0, 3, 1, 2).contiguous())
        return self.pipe.sample_images(
            self.batch, self.res, noise=noise.permute(0, 3, 1, 2).contiguous(),
            render_seed=seed,
        )

    def generate(self, n: int = 1, seed: Optional[int] = None,
                 timeout: Optional[float] = None):
        """Blocking; thread-safe.  Returns (n, res, res, 3) uint8 images,
        (n, frames, res, res, 3) uint8 videos, (n, n_views, res, res, 3)
        uint8 NeRF views, or a list of n occupancy meshes (verts (v, 3),
        faces (t, 3)) in world coordinates."""
        if not (1 <= n <= self.batch):
            raise ValueError(f"n must be in [1, {self.batch}], got {n}")
        req = _Request(n, int(seed) if seed is not None else time.time_ns() % (1 << 31))
        with self._cond:
            if self._stop:
                raise RuntimeError("service closed")
            self._queue.append(req)
            self._cond.notify_all()
        if not req.event.wait(timeout):
            with self._cond:
                if not req.event.is_set():
                    req.cancelled = True
                    try:
                        self._queue.remove(req)
                    except ValueError:
                        pass  # already taken by the worker
                    raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker_thread.join(timeout=30)

    # ------------------------------------------------------------- worker

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(0.25)
                if self._stop:
                    for r in self._queue:
                        r.error = RuntimeError("service closed")
                        r.event.set()
                    self._queue.clear()
                    return
                deadline = time.monotonic() + self._linger
                while sum(r.n for r in self._queue) < self.batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop:
                        break
                    self._cond.wait(remaining)
                take, count = [], 0
                while self._queue and count + self._queue[0].n <= self.batch:
                    r = self._queue.popleft()
                    if r.cancelled:
                        continue
                    take.append(r)
                    count += r.n
            if not take:
                continue
            try:
                self._run_batch(take, count)
            except Exception as e:  # report to the callers, keep the worker
                for r in take:
                    r.error = e
                    r.event.set()

    def _run_batch(self, take, count: int) -> None:
        rows = [
            np.random.default_rng(r.seed).standard_normal(
                (r.n,) + self._noise_shape, dtype=np.float32
            )
            for r in take
        ]
        if count < self.batch:  # pad to the service batch
            rows.append(
                np.random.default_rng(0xDD31).standard_normal(
                    (self.batch - count,) + self._noise_shape, dtype=np.float32
                )
            )
        noise = torch.from_numpy(np.concatenate(rows, axis=0)).to(self.pipe.device)
        out = self._sample(noise, take[0].seed)
        if not bool(torch.isfinite(out).all()):
            raise FloatingPointError("the sampler produced non-finite values")
        if self.domain == "occupancy":
            out = self._extract_meshes(out, count)
        else:
            out = (out.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
        ofs = 0
        for r in take:
            r.result = out[ofs : ofs + r.n]
            ofs += r.n
            r.event.set()

    def _extract_meshes(self, z: torch.Tensor, count: int) -> list:
        """Latents (batch, C, r, r) -> [(verts, faces)] for the first `count`
        slots (OccupancyPipeline.extract_meshes: every mesh in lockstep, one
        INR3D call per round on the card for the whole batch; the padding
        slots get no octree)."""
        return self.pipe.extract_meshes(z, count, **self.mesh_kwargs)
