"""Batching sampling service and its HTTP front end (counterpart of
ddmi_tpu/serve/server.py), all four domains: image, video, NeRF and
occupancy.

The service restores the stage-1 and stage-2 weights of the newest
checkpoints under `data.save_pth` (written by the port's trainer or by
cli/convert_reference_ckpt.py), serving the EMA copy of the UNet unless
`use_ema=False`.  A checkpoint is read on the CPU and only the serving
weights reach the card, after the bf16 cast: celebahq's stage-2 file holds
an 18 GB train state (the optimizer's moments with the EMA), of which
serving needs about 2 GB.

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
marching cubes on the host.  `encoder_reuse` in ddpmconfig.extra (the
command line's `--turbo K`) samples with encoder propagation.

Usage:
    service = SamplerService(cfg)          # restores save_pth checkpoints
    imgs = service.generate(n=2, seed=7)   # (2, res, res, 3) uint8
    serve_http(service, port=8500)         # blocking HTTP front end

HTTP API:
    GET  /healthz            -> {"ok": true, "domain": ..., "step": ...,
                                 "resolution": ..., "service_batch": ...,
                                 "initialized": ...}
    POST /generate {"n": 1, "seed": 0, "format": "npy"|"png"|"gif"|"obj"|"npz"}
         npy -> np.load-able bytes: (n, res, res, 3) uint8 for images,
                (n, t, res, res, 3) for video, (n, views, res, res, 3) NeRF
         png -> one PNG (a row-major grid when n > 1; image domain)
         gif -> animated GIF: videos tiled side by side (video domain) or
                the spherical camera path, scenes tiled (NeRF domain)
         obj -> Wavefront OBJ text, one `o mesh_i` object per sample
                (occupancy domain)
         npz -> np.load-able archive with verts_i / faces_i per sample
                (occupancy domain)
    A bad request answers 400, an unknown path 404, a failed batch 500,
    each with {"error": ...}.  PNG and GIF need PIL, imported when asked.
"""

from __future__ import annotations

import collections
import io
import json
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ddmi_tpu_torch.core import tracing
from ddmi_tpu_torch.core.checkpoint import stage1_weights, stage2_weights
from ddmi_tpu_torch.domains.image import ImagePipeline
from ddmi_tpu_torch.domains.nerf import NeRFPipeline
from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline
from ddmi_tpu_torch.domains.video import VideoPipeline


class _Request:
    __slots__ = ("n", "seed", "event", "result", "error", "cancelled", "enqueued")

    def __init__(self, n: int, seed: int):
        self.n = n
        self.seed = seed
        self.enqueued = 0.0  # perf_counter seconds, set as `generate` enqueues it
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

    The weights come from the newest checkpoints under cfg.data.save_pth,
    the UNet's and mixing logit's EMA copy unless `use_ema` is off; `step`
    is the stage-2 checkpoint's.  Without checkpoints the service raises
    FileNotFoundError, or with `allow_init` serves the seeded, untrained
    initialisation (for latency measurement and smoke runs; it warns, and
    `initialized` is True).  `state_dicts` instead gives the port
    state_dicts for the pipeline's `load_state_dicts` (unet / vae / mlp /
    mixing_logit, and pointnet for the 3D domains) and reads no
    checkpoint.  `step` is 0 unless a checkpoint was read.  It runs on the
    card unless `device="cpu"`.  Parameters are bf16 (`bf16` None: on a
    CUDA device; True: on either) or fp32 (None: on the CPU); the card's
    kernels take bf16 only, so `bf16=False` on a CUDA device raises
    ValueError.  The DDIM carry and the mixing logit stay fp32."""

    def __init__(self, cfg, service_batch: int = 8, resolution: Optional[int] = None,
                 linger_ms: float = 20.0, use_ema: bool = True, bf16: Optional[bool] = None,
                 n_views: int = 8, mesh_kwargs: Optional[dict] = None,
                 allow_init: bool = False, device="cuda",
                 state_dicts: Optional[dict] = None):
        self.domain = cfg.data.domain
        if self.domain not in ("image", "video", "nerf", "occupancy"):
            raise ValueError(f"unknown domain {self.domain!r}")
        if bf16 is None:
            bf16 = torch.device(device).type == "cuda"
        elif not bf16 and torch.device(device).type == "cuda":
            raise ValueError("bf16=False cannot serve on a CUDA device: the kernels take "
                             "bf16 operands only (fp32 serving runs on device='cpu')")
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
        self.step = 0
        self.initialized = False  # True: serving the untrained init
        if state_dicts is None:
            try:
                _, state_dicts = stage1_weights(cfg.data.save_pth, pipe.stage1_modules)
                self.step, stage2 = stage2_weights(cfg.data.save_pth, use_ema)
                state_dicts.update(stage2)
            except FileNotFoundError:
                if not allow_init:
                    raise
                warnings.warn(
                    f"no checkpoints under {cfg.data.save_pth}; serving "
                    "freshly-initialized (UNTRAINED) params because "
                    "allow_init=True; outputs are noise, for latency benchmarking / "
                    "smoke deployment only", stacklevel=2,
                )
                state_dicts, self.step, self.initialized = None, 0, True
        # the cast first, so that the checkpoint's fp32 tensors reach the
        # card as the bf16 copies load_state_dict makes of them
        pipe.cast(torch.bfloat16 if bf16 else torch.float32)
        if state_dicts is not None:
            pipe.load_state_dicts(**state_dicts)
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
            req.enqueued = time.perf_counter()
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
        batch_no = 0
        while True:
            with tracing.span("service.collect") as sp, self._cond:
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
                if take:
                    batch_no += 1
                    sp.set(batch=batch_no, seeds=[r.seed for r in take], samples=count,
                           padding=self.batch - count)
                    taken = time.perf_counter()
                    for r in take:
                        tracing.observe("service.queue_wait", taken - r.enqueued,
                                        batch=batch_no, seed=r.seed)
            if not take:
                continue
            try:
                self._run_batch(take, count)
            except Exception as e:  # report to the callers, keep the worker
                for r in take:
                    r.error = e
                    r.event.set()

    def _run_batch(self, take, count: int) -> None:
        with tracing.span("service.noise"):
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
        with tracing.span("service.finish"):
            finite = bool(torch.isfinite(out).all())
        if not finite:
            raise FloatingPointError("the sampler produced non-finite values")
        if self.domain == "occupancy":
            out = self._extract_meshes(out, count)
        with tracing.span("service.reply"):
            if self.domain != "occupancy":
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


# ------------------------------------------------------------------- HTTP


def _gif_bytes(vids: np.ndarray, fps: int = 8) -> bytes:
    """(n, t, h, w, 3) uint8 -> one animated GIF (videos tiled side by side)."""
    from PIL import Image

    n, t = vids.shape[:2]
    frames = [Image.fromarray(np.concatenate([vids[i, ti] for i in range(n)], axis=1))
              for ti in range(t)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return buf.getvalue()


def _obj_bytes(meshes) -> bytes:
    """[(verts, faces), ...] -> one Wavefront OBJ with `o mesh_i` objects
    (vertex indices global and 1-based, as OBJ has them)."""
    lines = []
    base = 1
    for i, (verts, faces) in enumerate(meshes):
        lines.append(f"o mesh_{i}")
        for v in np.asarray(verts, np.float32):
            lines.append(f"v {v[0]:g} {v[1]:g} {v[2]:g}")
        for f in np.asarray(faces, np.int64):
            lines.append(f"f {f[0] + base} {f[1] + base} {f[2] + base}")
        base += len(verts)
    return ("\n".join(lines) + "\n").encode("ascii")


def _npz_bytes(meshes) -> bytes:
    """[(verts, faces), ...] -> an np.savez archive of verts_i / faces_i."""
    arrays = {}
    for i, (verts, faces) in enumerate(meshes):
        arrays[f"verts_{i}"] = np.asarray(verts, np.float32)
        arrays[f"faces_{i}"] = np.asarray(faces, np.int64)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _png_bytes(imgs: np.ndarray) -> bytes:
    """(n, h, w, 3) uint8 -> one PNG (a row-major grid of 4 columns when n > 1)."""
    from PIL import Image

    n, h, w, c = imgs.shape
    cols = min(4, n)
    canvas = np.zeros((-(-n // cols) * h, cols * w, c), np.uint8)
    for i, im in enumerate(imgs):
        r, cc = divmod(i, cols)
        canvas[r * h : (r + 1) * h, cc * w : (cc + 1) * w] = im
    buf = io.BytesIO()
    Image.fromarray(canvas).save(buf, format="PNG")
    return buf.getvalue()


def _npy_bytes(out: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, out)
    return buf.getvalue()


def _body(domain: str, out, fmt: str):
    """A generated result in the requested format -> (body, content type);
    ValueError for a format the domain does not answer."""
    if domain == "occupancy":
        if fmt == "obj":
            return _obj_bytes(out), "text/plain"
        if fmt == "npz":
            return _npz_bytes(out), "application/octet-stream"
        raise ValueError(f"format {fmt!r} not valid for domain 'occupancy' (obj|npz)")
    if fmt == "png" and out.ndim == 4:
        return _png_bytes(out), "image/png"
    if fmt == "gif" and out.ndim == 5:
        return _gif_bytes(out), "image/gif"
    if fmt == "npy":
        return _npy_bytes(out), "application/octet-stream"
    raise ValueError(f"format {fmt!r} not valid for domain {domain!r} (image: png|npy, "
                     "video: gif|npy, nerf: gif|npy)")


def _make_handler(service: SamplerService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path != "/healthz":
                self._json(404, {"error": "not found"})
                return
            self._json(200, {
                "ok": True,
                "domain": service.domain,
                "step": service.step,
                "resolution": service.res,
                "service_batch": service.batch,
                "initialized": service.initialized,
            })

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                fmt = payload.get("format", "npy")
                out = service.generate(n=int(payload.get("n", 1)), seed=payload.get("seed"),
                                       timeout=600)
                body, ctype = _body(service.domain, out, fmt)
            except ValueError as e:  # a bad payload, n or format
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # the batch failed: report it, keep serving
                self._json(500, {"error": str(e)})
                return
            self._send(200, body, ctype)

    return Handler


def make_http_server(service: SamplerService, host: str = "127.0.0.1",
                     port: int = 8500) -> ThreadingHTTPServer:
    """A threading HTTP server answering /healthz and /generate for
    `service` (port 0 picks a free port: server.server_address[1])."""
    return ThreadingHTTPServer((host, port), _make_handler(service))


def serve_http(service: SamplerService, host: str = "127.0.0.1", port: int = 8500) -> None:
    """Serve until interrupted, then close the server and the service."""
    server = make_http_server(service, host, port)
    print(f"serving on http://{host}:{server.server_address[1]} "
          f"(batch={service.batch}, res={service.res}, step={service.step})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()
