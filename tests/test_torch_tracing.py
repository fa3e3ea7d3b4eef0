"""The port's spans and values (ddmi_tpu_torch/core/tracing.py) on the CPU.

- With no recorder and no profiler, `span` returns the shared no-op and
  nothing is recorded.
- A tiny image service and a tiny NeRF service, driven by client threads
  with a recorder installed: every request has one `service.queue_wait`,
  whose batch is the `service.collect` that took its seed; each batch runs
  collect, noise, finish and reply in that order on the worker's thread;
  `sampler.step` comes sampling_timesteps times a batch, `sampler.norm`
  (ResBlocks x 2 + 1) times a UNet forward, `render.input` and
  `render.mlp` views x chunks times a scene.
- Served outputs are bit-identical with the recorder on and off.
- Under torch.profiler a `stage1/*` span and a sampling span are ranges of
  the profile, with the recorder on or off.
"""

import copy
import threading

import numpy as np
import pytest
import torch

from ddmi_tpu_torch.core import tracing
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.domains import nerf as nerf_domain
from ddmi_tpu_torch.nn.unet import ResBlock
from ddmi_tpu_torch.serve.server import SamplerService

torch.set_num_threads(2)

IMAGE = {
    "model": {
        "embed_dim": 4,
        "params": {
            "ddconfig": {"double_z": True, "z_channels": 8, "resolution": 16, "in_channels": 3,
                         "out_ch": 8, "ch": 32, "ch_mult": [1, 1, 2], "num_res_blocks": 1,
                         "attn_resolutions": [], "hdbf_resolutions": [8, 4]},
            "mlpconfig": {"in_ch": 2, "out_ch": 3, "ch": 32, "latent_dim": 8},
            "unetconfig": {"image_size": 4, "in_channels": 4, "model_channels": 32,
                           "out_channels": 4, "num_res_blocks": 1,
                           "attention_resolutions": [2], "channel_mult": [1, 2],
                           "num_head_channels": 16},
            "ddpmconfig": {"timesteps": 20, "image_size": 4, "channels": 4,
                           "sampling_timesteps": 3},
        },
    },
    "data": {"domain": "image", "test_resolution": 8},
}

NERF = {
    "model": {
        "embed_dim": 8,
        "pointnet": {"c_dim": 8, "hidden_dim": 32, "plane_resolution": 16, "n_blocks": 2},
        "params": {
            "lossconfig": {"epochs": 1, "warmup_epochs": 0, "sn_reg": True},
            "ddconfig": dict(double_z=True, z_channels=32, resolution=16, in_channels=8,
                             out_ch=8, ch=32, ch_mult=[1, 2], num_res_blocks=1,
                             attn_resolutions=[], hdbf_resolutions=[],
                             inter_attn_resolutions=[16], attn_type="vanilla"),
            "unetconfig": dict(image_size=8, in_channels=24, model_channels=32,
                               out_channels=24, num_res_blocks=1, attention_resolutions=[2],
                               channel_mult=[1, 2], num_head_channels=16),
            "ddpmconfig": dict(timesteps=20, image_size=8, channels=24,
                               sampling_timesteps=2, mixed_init=-6.0),
            "mlpconfig": dict(in_ch=3, out_ch=4, ch=32, latent_dim=8, D=2, W=32, skips=[1],
                              multires=4, multires_views=2, N_samples=8, N_rand=16,
                              white_bkgd=True),
        },
    },
    "data": {"domain": "nerf"},
}


@pytest.fixture(autouse=True)
def no_recorder():
    tracing.disable()
    yield
    tracing.disable()


def _service(conf, tmp_path, **kwargs):
    """A CPU service on seeded weights (the init, every parameter moved).
    Its worker opens its first `service.collect` as it starts: a recorder
    installed later sees that batch's values but not its collect."""
    conf = copy.deepcopy(conf)
    conf["data"]["save_pth"] = str(tmp_path / "no_checkpoints")
    with pytest.warns(UserWarning, match="UNTRAINED"):
        svc = SamplerService(config_from_dict(conf), device="cpu", allow_init=True, **kwargs)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for module in (svc.pipe.unet, svc.pipe.vae, svc.pipe.mlp):
            for p in module.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return svc


def _drive(svc, seeds, clients):
    """Each of `clients` threads requests its share of `seeds` one by one."""
    results = {}

    def client(mine):
        for s in mine:
            results[s] = svc.generate(1, seed=s, timeout=300)

    threads = [threading.Thread(target=client, args=(seeds[i::clients],))
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == sorted(seeds)
    return results


def _forwards(svc):
    calls = []
    svc.pipe.unet.register_forward_hook(lambda *_: calls.append(1))
    return calls


def _check_service(rec, svc, seeds):
    """The service's spans and values: -> the batches' numbers."""
    worker = svc._worker_thread.ident
    assert all(tid == worker for _, tid, *_ in rec.spans)
    assert all(tid == worker for _, tid, *_ in rec.values)
    collects = [s for s in rec.spans if s[0] == "service.collect" and "batch" in s[4]]
    taken = {seed: c[4]["batch"] for c in collects for seed in c[4]["seeds"]}
    assert sorted(taken) == sorted(seeds)
    for c in collects:
        assert c[4]["samples"] == len(c[4]["seeds"])
        assert c[4]["padding"] == svc.batch - c[4]["samples"]
    waits = [v for v in rec.values if v[0] == "service.queue_wait"]
    assert sorted(v[4]["seed"] for v in waits) == sorted(seeds)
    assert all(v[4]["batch"] == taken[v[4]["seed"]] and v[3] >= 0 for v in waits)
    # per batch: collect, noise, finish, reply, in that order
    service = sorted((s for s in rec.spans if s[0].startswith("service.")
                      and (s[0] != "service.collect" or "batch" in s[4])), key=lambda s: s[2])
    assert [s[0] for s in service] == len(collects) * [
        "service.collect", "service.noise", "service.finish", "service.reply"]
    assert all(a[3] <= b[2] for a, b in zip(service, service[1:]))
    return [c[4]["batch"] for c in collects]


def test_disabled_span_is_the_shared_noop():
    assert tracing.span("sampler.norm") is tracing.OFF
    with tracing.span("service.collect", batch=1) as sp:
        sp.set(samples=2)
    tracing.observe("service.queue_wait", 0.5, batch=1)
    rec = tracing.enable()
    tracing.disable()
    with tracing.span("sampler.step"):
        pass
    tracing.observe("service.queue_wait", 0.5)
    assert rec.spans == [] and rec.values == []


def test_image_service_spans(tmp_path):
    rec = tracing.enable()
    svc = _service(IMAGE, tmp_path, service_batch=3, linger_ms=30)
    forwards = _forwards(svc)
    seeds = list(range(100, 108))
    try:
        _drive(svc, seeds, clients=3)
    finally:
        svc.close()
    batches = _check_service(rec, svc, seeds)
    steps = [s for s in rec.spans if s[0] == "sampler.step"]
    assert len(steps) == len(batches) * 3
    assert len(forwards) == len(steps)
    blocks = sum(isinstance(m, ResBlock) for m in svc.pipe.unet.modules())
    norms = [s for s in rec.spans if s[0] == "sampler.norm"]
    assert len(norms) == (2 * blocks + 1) * len(forwards)
    # every step lies inside a batch's device work, between noise and finish
    noise = [s for s in rec.spans if s[0] == "service.noise"]
    finish = [s for s in rec.spans if s[0] == "service.finish"]
    for st in steps:
        assert any(n[3] <= st[2] and st[3] <= f[2] for n, f in zip(noise, finish))


def test_nerf_service_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(nerf_domain, "RAY_CHUNK", 24)          # 3 chunks a 8^2 view
    rec = tracing.enable()
    svc = _service(NERF, tmp_path, service_batch=2, linger_ms=30, resolution=8, n_views=2)
    forwards = _forwards(svc)
    seeds = [7, 8, 9]
    try:
        _drive(svc, seeds, clients=2)
    finally:
        svc.close()
    batches = _check_service(rec, svc, seeds)
    assert len([s for s in rec.spans if s[0] == "sampler.step"]) == 2 * len(batches)
    blocks = sum(isinstance(m, ResBlock) for m in svc.pipe.unet.modules())
    assert len([s for s in rec.spans if s[0] == "sampler.norm"]) == (2 * blocks + 1) * len(
        forwards)
    scenes = svc.batch * len(batches)       # the padding slots are rendered too
    for name in ("render.input", "render.mlp"):
        assert len([s for s in rec.spans if s[0] == name]) == scenes * 2 * 3


@pytest.mark.parametrize("conf,kwargs", [
    (IMAGE, {}), (NERF, {"resolution": 8, "n_views": 2})], ids=["image", "nerf"])
def test_outputs_are_bit_identical_with_the_recorder_on_and_off(tmp_path, conf, kwargs):
    svc = _service(conf, tmp_path, service_batch=2, linger_ms=0, **kwargs)
    try:
        off = [svc.generate(1, seed=s) for s in (21, 22)]
        rec = tracing.enable()
        on = [svc.generate(1, seed=s) for s in (21, 22)]
    finally:
        svc.close()
    assert rec.spans and all(np.array_equal(a, b) for a, b in zip(off, on))
    assert float(np.std(off[0])) > 1.0      # not a flat image


@pytest.mark.parametrize("recording", [False, True], ids=["off", "recording"])
def test_spans_are_profiler_ranges(tmp_path, recording):
    """A NeRF stage-1 loss under torch.profiler: its `stage1/*` stages and
    the render's spans inside them are ranges of the profile."""
    from torch.profiler import ProfilerActivity, profile

    from ddmi_tpu_torch.data.nerf import SyntheticNeRF
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline

    conf = copy.deepcopy(NERF)
    conf["data"]["batch_size"] = 1
    pipe = NeRFPipeline(config_from_dict(conf), device="cpu", seed=0)
    state = pipe.init_stage1(4)
    batch = {k: torch.from_numpy(v) for k, v in
             next(iter(SyntheticNeRF(1, 100, 8, length=1, seed=0))).items()}
    draws = pipe.draw_stage1(batch, torch.Generator().manual_seed(0))
    rec = tracing.enable() if recording else None
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.stage1_loss(batch, 1, draws, state.sn)
    names = {e.name for e in prof.events()}
    assert {"stage1/encode", "stage1/decode", "stage1/render", "render.input",
            "render.mlp"} <= names
    if recording:
        assert {"stage1/render", "render.input", "render.mlp"} <= {s[0] for s in rec.spans}
