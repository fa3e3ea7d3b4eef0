"""The port's serving entry point on the CPU: the HTTP front end against
the JAX package's, the service restored from checkpoints the port's
Trainer wrote, and cli/serve.py's arguments.

- The body helpers give JAX's bytes for the same uint8 arrays and meshes
  (the NPZ archive its arrays: a zip entry carries the time it was
  written).
- Both front ends, each on a stub service that answers as a SamplerService
  of each domain would, give the same status, content type and body for
  the same requests: /healthz, 404s, every format, bad formats, a bad n,
  bad JSON, a failed batch.
- A tiny image config trained by `Trainer` for a step of stage 1 and three
  of stage 2 (its EMA then lags the weights): the service restores the EMA
  copy, or the raw weights under use_ema=False, reports the stage-2 step,
  and answers over HTTP what `generate` returns in-process; concurrent
  requests coalesce into one batch; a missing checkpoint raises
  FileNotFoundError; allow_init serves the initialisation only when there
  is no checkpoint; bf16 serving on the CPU, and its refusal of fp32 on a
  CUDA device.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from ddmi_tpu_torch.serve import server

torch.set_num_threads(2)

CFG = {
    "model": {
        "DiT": False, "resume": False, "use_fp16": False, "amp": False, "lr": 1e-3,
        "embed_dim": 4,
        "params": {
            "lossconfig": {"epochs": 1, "warmup_epochs": 0, "save_and_sample_every": 1,
                           "gradient_accumulate_every": 1, "multiscale": False,
                           "lr_scheduler": False},
            "ddconfig": {"double_z": True, "z_channels": 8, "resolution": 16, "in_channels": 3,
                         "out_ch": 8, "ch": 32, "ch_mult": [1, 1, 2], "num_res_blocks": 1,
                         "attn_resolutions": [], "hdbf_resolutions": [8, 4]},
            "mlpconfig": {"in_ch": 2, "out_ch": 3, "ch": 32, "latent_dim": 8},
            "unetconfig": {"image_size": 4, "in_channels": 4, "model_channels": 32,
                           "out_channels": 4, "num_res_blocks": 1,
                           "attention_resolutions": [2], "channel_mult": [1, 2],
                           "num_head_channels": 16},
            "ddpmconfig": {"timesteps": 20, "image_size": 4, "channels": 4,
                           "sampling_timesteps": 4},
        },
    },
    "data": {"domain": "image", "mode": "train", "dataset": "synthetic",
             "data_dir": "/tmp/none", "test_data_dir": "/tmp/none",
             "batch_size": 2, "test_batch_size": 2, "test_resolution": 16},
}


def _meshes(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
             rng.integers(0, n, (2 * n, 3)).astype(np.int64)) for n in (5, 9)]


def test_body_helpers_match_jax():
    pytest.importorskip("PIL")
    from ddmi_tpu.serve import server as jax_server

    rng = np.random.default_rng(0)
    for n in (1, 3, 6):
        imgs = rng.integers(0, 256, (n, 8, 12, 3), dtype=np.uint8)
        assert server._png_bytes(imgs) == jax_server._png_bytes(imgs)
    vids = rng.integers(0, 256, (2, 4, 8, 8, 3), dtype=np.uint8)
    assert server._gif_bytes(vids) == jax_server._gif_bytes(vids)
    assert server._obj_bytes(_meshes()) == jax_server._obj_bytes(_meshes())
    got = np.load(io.BytesIO(server._npz_bytes(_meshes())))
    want = np.load(io.BytesIO(jax_server._npz_bytes(_meshes())))
    assert sorted(got.files) == sorted(want.files) == ["faces_0", "faces_1", "verts_0",
                                                       "verts_1"]
    for k in want.files:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


class _Stub:
    """The attributes and `generate` the handlers read, per domain."""

    def __init__(self, domain):
        self.domain, self.step, self.res, self.batch = domain, 7, 8, 2
        self.initialized = False
        self.fail = False

    def generate(self, n=1, seed=None, timeout=None):
        if not 1 <= n <= self.batch:
            raise ValueError(f"n must be in [1, {self.batch}], got {n}")
        if self.fail:
            raise RuntimeError("the sampler produced non-finite values")
        if self.domain == "occupancy":
            return _meshes(int(seed or 0))[:n]
        rng = np.random.default_rng(int(seed or 0))
        shape = {"image": (8, 8, 3), "video": (3, 8, 8, 3), "nerf": (2, 8, 8, 3)}[self.domain]
        return rng.integers(0, 256, (n,) + shape, dtype=np.uint8)


def _serve(make, service):
    httpd = make(service, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _ask(url, path, payload=None, raw=None):
    """-> (status, content type, body) of a GET (payload None) or POST."""
    data = raw if raw is not None else (None if payload is None
                                        else json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(urllib.request.Request(url + path, data=data),
                                    timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.mark.parametrize("domain", ["image", "video", "nerf", "occupancy"])
def test_http_front_end_answers_as_jax(domain):
    """The same requests to JAX's front end and the port's, each on the
    same stub service: equal status, content type and body (NPZ: equal
    arrays)."""
    pytest.importorskip("PIL")
    from ddmi_tpu.serve import server as jax_server

    stub = _Stub(domain)
    ours, url = _serve(server.make_http_server, stub)
    ref, ref_url = _serve(jax_server.make_http_server, stub)
    requests = [("/healthz", None, None), ("/nope", None, None), ("/nope", {}, None),
                ("/generate", {"n": 3, "seed": 1}, None), ("/generate", None, b"{bad"),
                ("/generate", {"n": "x"}, None), ("/generate", {"format": "bmp"}, None)]
    requests += [("/generate", {"n": 2, "seed": 4, "format": f}, None)
                 for f in ("npy", "png", "gif", "obj", "npz")]
    try:
        for path, payload, raw in requests:
            got, want = _ask(url, path, payload, raw), _ask(ref_url, path, payload, raw)
            assert got[:2] == want[:2], (path, payload, got[:2], want[:2])
            if payload and payload.get("format") == "npz" and got[0] == 200:
                g, w = np.load(io.BytesIO(got[2])), np.load(io.BytesIO(want[2]))
                assert all(np.array_equal(g[k], w[k]) for k in w.files)
            else:
                assert got[2] == want[2], (path, payload)
        health = json.loads(_ask(url, "/healthz")[2])
        assert health == {"ok": True, "domain": domain, "step": 7, "resolution": 8,
                          "service_batch": 2, "initialized": False}
        stub.fail = True
        got = _ask(url, "/generate", {"n": 1})
        assert got[:2] == _ask(ref_url, "/generate", {"n": 1})[:2] == (500, "application/json")
        assert json.loads(got[2]) == {"error": "the sampler produced non-finite values"}
    finally:
        for httpd in (ours, ref):
            httpd.shutdown()
            httpd.server_close()


# ------------------------------------------------------ a trained service


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny image config's save_pth written by the port's Trainer: one
    micro-step of stage 1, three of stage 2 (the EMA copies the weights at
    micro-step 0 and next averages at 10, so it lags them); -> (cfg, yaml
    path)."""
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.data.synthetic import SyntheticImages
    from ddmi_tpu_torch.domains.image import ImagePipeline

    root = tmp_path_factory.mktemp("serve")
    raw = json.loads(json.dumps(CFG))
    raw["data"]["save_pth"] = str(root / "save")
    path = root / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    skip = lambda *a: None
    for exp, steps in (("d2c-vae", 1), ("ldm", 3)):
        cfg = load_config(str(path), exp=exp)
        pipe = ImagePipeline(cfg, device="cpu", seed=cfg.seed)
        trainer = Trainer(cfg, pipe, SyntheticImages(2, 16, length=steps))
        if exp == "d2c-vae":
            trainer.train_stage1(epochs=1, eval_hook=skip)
        else:
            trainer.train_stage2(epochs=1, eval_hook=skip)
    return cfg, str(path)


def _saved(cfg, prefix):
    import glob

    (f,) = glob.glob(f"{cfg.data.save_pth}/{prefix}/*.pt")
    return torch.load(f, map_location="cpu", weights_only=True)["state"]


@pytest.mark.parametrize("use_ema", [True, False])
def test_service_restores_the_trainers_checkpoints(trained, use_ema):
    """The UNet and mixing logit come from the stage-2 file's EMA (or its
    raw weights), the VAE and INR from the stage-1 file, bit for bit; the
    step is stage 2's; the samples are those of a service given the same
    weights as state_dicts."""
    cfg, _ = trained
    s1, s2 = _saved(cfg, "stage1"), _saved(cfg, "stage2")
    weights = s2["ema"] if use_ema else s2["params"]
    assert not torch.equal(s2["ema"]["unet.out.2.weight"], s2["params"]["unet.out.2.weight"])
    svc = server.SamplerService(cfg, service_batch=2, resolution=16, device="cpu",
                                use_ema=use_ema)
    try:
        assert svc.step == s2["step"] == 3 and not svc.initialized
        for k, v in svc.pipe.unet.state_dict().items():
            assert torch.equal(v, weights[f"unet.{k}"]), k
        assert torch.equal(svc.pipe.mixing_logit, weights["mixing_logit"])
        for name in ("vae", "mlp"):
            for k, v in getattr(svc.pipe, name).state_dict().items():
                assert torch.equal(v, s1["params"][f"{name}.{k}"]), (name, k)
        got = svc.generate(2, seed=5, timeout=300)
    finally:
        svc.close()
    sds = {"unet": {k[5:]: v for k, v in weights.items() if k.startswith("unet.")},
           "mixing_logit": weights["mixing_logit"],
           **{n: {k[len(n) + 1:]: v for k, v in s1["params"].items() if k.startswith(n + ".")}
              for n in ("vae", "mlp")}}
    ref = server.SamplerService(cfg, service_batch=2, resolution=16, device="cpu",
                                state_dicts=sds)
    try:
        assert ref.step == 0
        assert np.array_equal(got, ref.generate(2, seed=5, timeout=300))
    finally:
        ref.close()


def test_http_serves_the_restored_model_and_coalesces(trained):
    """/healthz reports the restored step; two concurrent /generate
    requests run as one batch, and each npy body is what generate returns
    for its seed in-process; PNG is that array's grid."""
    cfg, _ = trained
    svc = server.SamplerService(cfg, service_batch=2, resolution=16, linger_ms=2000,
                                device="cpu")
    batches, run = [], svc._sample
    svc._sample = lambda noise, seed: batches.append(seed) or run(noise, seed)
    httpd, url = _serve(server.make_http_server, svc)
    try:
        health = json.loads(_ask(url, "/healthz")[2])
        assert health == {"ok": True, "domain": "image", "step": 3, "resolution": 16,
                          "service_batch": 2, "initialized": False}
        bodies = {}

        def post(seed):
            bodies[seed] = _ask(url, "/generate", {"n": 1, "seed": seed, "format": "npy"})

        threads = [threading.Thread(target=post, args=(s,)) for s in (11, 12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert len(batches) == 1
        for seed, (status, ctype, body) in bodies.items():
            assert (status, ctype) == (200, "application/octet-stream")
            arr = np.load(io.BytesIO(body))
            assert arr.shape == (1, 16, 16, 3) and arr.dtype == np.uint8
            assert np.array_equal(arr, svc.generate(1, seed=seed, timeout=300))
        if _has_pil():
            status, ctype, body = _ask(url, "/generate", {"n": 1, "seed": 11, "format": "png"})
            assert (status, ctype) == (200, "image/png")
            assert body == server._png_bytes(svc.generate(1, seed=11, timeout=300))
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()


def _has_pil():
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def test_missing_checkpoint_raises_and_allow_init_serves_the_init(tmp_path):
    from ddmi_tpu_torch.core.config import config_from_dict

    raw = json.loads(json.dumps(CFG))
    raw["data"]["save_pth"] = str(tmp_path / "empty")
    cfg = config_from_dict(raw)
    with pytest.raises(FileNotFoundError):
        server.SamplerService(cfg, service_batch=2, resolution=16, device="cpu")
    assert not (tmp_path / "empty").exists()  # a failed restore creates nothing
    with pytest.warns(UserWarning, match="UNTRAINED"):
        svc = server.SamplerService(cfg, service_batch=2, resolution=16, device="cpu",
                                    allow_init=True)
    httpd, url = _serve(server.make_http_server, svc)
    try:
        health = json.loads(_ask(url, "/healthz")[2])
        assert health["initialized"] is True and health["step"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()


def test_allow_init_restores_the_checkpoints_it_finds(trained):
    """allow_init falls back to the initialisation only when save_pth holds
    no checkpoints, as JAX's service does: with the trainer's files it
    serves them."""
    cfg, _ = trained
    ema = _saved(cfg, "stage2")["ema"]
    svc = server.SamplerService(cfg, service_batch=2, resolution=16, device="cpu",
                                allow_init=True)
    try:
        assert svc.step == 3 and not svc.initialized
        assert torch.equal(svc.pipe.unet.out[2].weight, ema["unet.out.2.weight"])
    finally:
        svc.close()


def test_bf16_serving(trained):
    """bf16=True serves bf16 weights on the CPU too (the card's dtypes
    through the plain versions); bf16=False is refused on a CUDA device,
    whose kernels take bf16 only, before the device is touched."""
    cfg, _ = trained
    with pytest.raises(ValueError, match="bf16=False cannot serve on a CUDA device"):
        server.SamplerService(cfg, service_batch=2, device="cuda", bf16=False)
    ema = _saved(cfg, "stage2")["ema"]
    svc = server.SamplerService(cfg, service_batch=2, resolution=16, device="cpu", bf16=True)
    try:
        w = svc.pipe.unet.out[2].weight
        assert w.dtype == torch.bfloat16 and svc.pipe.mixing_logit.dtype == torch.float32
        assert torch.equal(w, ema["unet.out.2.weight"].to(torch.bfloat16))
        got = svc.generate(2, seed=5, timeout=300)
        assert got.shape == (2, 16, 16, 3) and got.dtype == np.uint8
    finally:
        svc.close()


def test_cli_serve_arguments_and_turbo(trained, capsys):
    """cli/serve.py takes JAX's flags plus --device; --turbo K > 1 sets
    ddpmconfig.extra['encoder_reuse'] and says so; the service it builds is
    restored from save_pth, and under --turbo 2 half of its NFE-4 UNet
    calls run on the cache."""
    from ddmi_tpu_torch.cli.serve import build_service, parse_args

    _, path = trained
    args = parse_args(["--configs", path])
    assert (args.host, args.port, args.batch, args.resolution, args.linger_ms) == (
        "127.0.0.1", 8500, 8, None, 20.0)
    assert (args.no_warmup, args.no_ema, args.n_views, args.mesh_resolution0,
            args.mesh_upsampling, args.turbo, args.device) == (
        False, False, 8, None, None, 1, "cuda")
    args = parse_args(["--configs", path, "--host", "0.0.0.0", "--port", "0", "--batch", "2",
                       "--resolution", "16", "--linger-ms", "5", "--no-warmup", "--no-ema",
                       "--n-views", "3", "--mesh-resolution0", "16", "--mesh-upsampling", "1",
                       "--turbo", "2", "--device", "cpu"])
    assert (args.port, args.batch, args.resolution, args.linger_ms, args.no_warmup,
            args.no_ema, args.n_views, args.mesh_resolution0, args.mesh_upsampling,
            args.turbo, args.device) == (0, 2, 16, 5.0, True, True, 3, 16, 1, 2, "cpu")
    for turbo in (2, 1):
        svc = build_service(parse_args(["--configs", path, "--batch", "2", "--resolution", "16",
                                        "--turbo", str(turbo), "--device", "cpu"]))
        unet, cached = svc.pipe.unet, []
        forward = unet.forward
        unet.forward = lambda *a, **k: cached.append(k.get("cache") is not None) or forward(*a, **k)
        try:
            assert svc.step == 3 and svc.batch == 2 and svc.res == 16
            assert svc.cfg.model.ddpmconfig.extra.get("encoder_reuse", 1) == turbo
            assert svc.generate(2, seed=1, timeout=300).shape == (2, 16, 16, 3)
        finally:
            svc.close()
        assert cached == ([False, True] * 2 if turbo == 2 else [False] * 4)
        said = capsys.readouterr().out
        assert ("turbo sampling: encoder reuse every 2 steps" in said) == (turbo == 2)
