"""The UNet forward and the DDIM update as CUDA graphs (nn/unet.py's
`UNetGraphs`, diffusion/process.py's `_GraphedUpdate`), on the CPU.

The segment walk, run eagerly, against `UNet.forward`; the engagement rules;
and the graphed paths' control flow with graphs stood in for by `_FakeCapturer`:
a fake graph runs its callable at capture and copies a new run's results
into the first run's tensors at each replay, as a replay rewrites a graph's
static outputs.  The card's graphs are held to the eager forward in
tests/test_torch_cuda.py."""

import dataclasses

import pytest
import torch

from ddmi_tpu_torch.core import graphs, tracing
from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.diffusion import process
from ddmi_tpu_torch.diffusion.schedule import make_schedule
from ddmi_tpu_torch.nn import unet as unet_mod
from ddmi_tpu_torch.nn.unet import AttentionBlock, UNet


def _copy(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dst is not None:
        for d, s in zip(dst, src):
            _copy(d, s)


class _FakeGraph:
    def __init__(self, fn):
        self.fn = fn
        self.out = fn()

    def replay(self):
        _copy(self.out, self.fn())


class _FakeCapturer:
    captures = 0

    def __init__(self, device):
        pass

    def capture(self, fn):
        _FakeCapturer.captures += 1
        g = _FakeGraph(fn)
        return g, g.out


@pytest.fixture
def fake_graphs(monkeypatch):
    """Graphs taken on the CPU, through `_FakeCapturer`."""
    monkeypatch.setattr(graphs, "available", lambda t: True)
    monkeypatch.setattr(graphs, "Capturer", _FakeCapturer)
    _FakeCapturer.captures = 0


@pytest.fixture
def recorder():
    rec = tracing.enable()
    yield rec
    tracing.disable()


def _unet(seed=0, **over):
    """A small UNet with attention at every level: C 64 at ds 1 (the
    PyTorch attention path), C 128 at ds 2 and 4 (the fused block's entry,
    plain on the CPU); 10 attention blocks, 11 segments."""
    kw = dict(image_size=16, in_channels=4, model_channels=64, out_channels=4,
              attention_resolutions=[1, 2, 4], num_res_blocks=1, channel_mult=[1, 2, 2],
              num_head_channels=32)
    kw.update(over)
    cfg = config_from_dict({"model": {"params": {"unetconfig": kw}}}).model.unetconfig
    torch.manual_seed(seed)
    u = UNet(cfg).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in u.parameters():
            if not p.any():  # the zero-initialised output convs
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return u


def _inputs(seed=2, b=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, 4, 16, 16), generator=g), torch.randint(0, 1000, (b,), generator=g)


def _graphed(rec):
    return [v for name, _, _, v, _ in rec.values if name == "sampler.graphed"]


@pytest.mark.parametrize("scale_shift", [False, True])
def test_segment_walk_matches_forward(scale_shift):
    """The segment plan run eagerly, segment by segment with each attention
    block writing into a buffer of its own, is the forward bit for bit."""
    u = _unet(use_scale_shift_norm=scale_shift)
    x, t = _inputs()
    with torch.no_grad():
        ref = u(x, t)
        got, boundaries = unet_mod.walk(u, x, t)
    segments, blocks = unet_mod.segment_plan(u)
    attn = [m for m in u.modules() if isinstance(m, AttentionBlock)]
    assert blocks == attn and len(attn) == 10 and len(segments) == 11
    assert [b for b, _, _ in boundaries] == attn
    assert torch.equal(got, ref)
    # the skips pushed and popped balance: one CAT per output block
    ops = [op for seg in segments for op in seg]
    assert ops.count(unet_mod.PUSH) == len(u.input_blocks)
    assert ops.count(unet_mod.CAT) == len(u.output_blocks)


@pytest.mark.parametrize("channels", [64, 128])
def test_attention_block_writes_into_out(channels):
    """`out=` takes the block's output, bit for bit, on the fused block's
    entry (C 128) and on the PyTorch path (C 64)."""
    torch.manual_seed(channels)
    blk = AttentionBlock(channels, channels // 32).eval()
    with torch.no_grad():
        blk.proj_out.weight.normal_(0, 0.05)
        x = torch.randn(2, channels, 8, 8)
        ref = blk(x)
        buf = torch.empty_like(x)
        got = blk(x, out=buf)
    assert got.data_ptr() == buf.data_ptr() and torch.equal(buf, ref)


def test_graphed_forward_matches_eager_and_keeps_the_hooks(fake_graphs, recorder):
    """Eager, captured, replayed: each forward equals the eager one, runs
    the UNet's and every attention block's forward hooks once, in module
    order, and records sampler.graphed 0, 1, 1."""
    u = _unet()
    x, t = _inputs()
    with torch.no_grad():
        ref = u(x, t, return_cache=True)[0]
    names = {m: n for n, m in u.named_modules()}
    fired = []
    u.register_forward_pre_hook(lambda m, i: fired.append("unet<"))
    u.register_forward_hook(lambda m, i, o: fired.append("unet>"))
    for m in u.modules():
        if isinstance(m, AttentionBlock):
            m.register_forward_hook(lambda m, i, o: fired.append(names[m]))
    order = ["unet<", *(n for n, m in u.named_modules() if isinstance(m, AttentionBlock)),
             "unet>"]
    recorder.clear()
    with torch.inference_mode():
        outs = [u(x, t) for _ in range(3)]
    assert fired == order * 3
    assert _graphed(recorder) == [0, 1, 1]
    assert _FakeCapturer.captures == 11
    for out in outs:
        assert torch.equal(out, ref)


def test_graphed_outputs_do_not_alias(fake_graphs):
    """Two interleaved calls at one key (guidance's two branches) return
    tensors of their own, each its own input's forward."""
    u = _unet()
    (x1, t1), (x2, t2) = _inputs(3), _inputs(4)
    with torch.no_grad():
        r1, r2 = (u(x, t, return_cache=True)[0] for x, t in ((x1, t1), (x2, t2)))
        u(x1, t1)
        u(x1, t1)  # captured
        a = u(x1, t1)
        b = u(x2, t2)
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, r1) and torch.equal(b, r2)


def _eager_cases():
    def grad(u, x, t):
        with torch.enable_grad():
            return u(x, t)

    def cache(u, x, t):
        _, c = u(x, t, return_cache=True)
        return u(x, t, cache=c)

    def labels(u, x, t):
        return u(x, t, y=torch.tensor([1, 3]))

    def cond(u, x, t):
        return u(x, t, cond=torch.randn(2, 5, 16))

    def autocast(u, x, t):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            return u(x, t)

    def functional(u, x, t):
        params = {k: p.detach().clone() for k, p in u.named_parameters()}
        return torch.func.functional_call(u, params, (x, t))

    return [("grad", {}, grad), ("return_cache", {}, lambda u, x, t: u(x, t, return_cache=True)),
            ("cache", {}, cache), ("labels", {"num_classes": 4}, labels),
            ("cond", {"use_spatial_transformer": True, "context_dim": 16}, cond),
            ("autocast", {}, autocast), ("functional_call", {}, functional)]


@pytest.mark.parametrize("name,over,call", _eager_cases(), ids=[c[0] for c in _eager_cases()])
def test_engagement_rules_pick_the_eager_path(fake_graphs, recorder, name, over, call):
    """A gradient, an encoder cache (made or read), labels, a context (the
    spatial transformers), autocast or parameters swapped for the call run
    the eager forward every time, with sampler.graphed 0, and capture
    nothing."""
    u = _unet(**over)
    x, t = _inputs()
    recorder.clear()
    with torch.no_grad():
        for _ in range(3):
            call(u, x, t)
    assert _FakeCapturer.captures == 0 and not u._graphs._forwards
    vals = _graphed(recorder)
    assert len(vals) >= 3 and set(vals) == {0}


def test_forward_on_the_cpu_runs_eagerly(recorder):
    u = _unet()
    x, t = _inputs()
    with torch.no_grad():
        for _ in range(3):
            u(x, t)
    assert _graphed(recorder) == [0, 0, 0] and not u._graphs._forwards


def test_conversion_drops_the_graphs(fake_graphs, recorder):
    """A conversion moves the parameters: the graphs go, and the next
    forward at the key runs eagerly again."""
    u = _unet()
    x, t = _inputs()
    with torch.no_grad():
        u(x, t)
        u(x, t)
        assert u._graphs._forwards
        u.float()
        assert not u._graphs._forwards
        recorder.clear()
        u(x, t)
        u(x, t)
    assert _graphed(recorder) == [0, 1]


def _gd(**over):
    sched = make_schedule(beta_schedule="linear", timesteps=1000, linear_start=1e-4,
                          linear_end=2e-2, cosine_s=8e-3, v_posterior=0.0,
                          parameterization="eps")
    return process.GaussianDiffusion(schedule=sched, sampling_timesteps=10, **over)


@pytest.mark.parametrize("mixed,clip", [(True, False), (False, True)])
def test_graphed_ddim_sample_matches_eager(monkeypatch, recorder, mixed, clip):
    """10 DDIM steps with the UNet's and the update's graphs (stood in for)
    against the eager loop, bit for bit, twice; the update is warmed by the
    first step, captured by the second, and every UNet forward but the
    first replays."""
    u = _unet()
    logit = torch.linspace(-2.0, 1.0, 4).reshape(1, 4, 1, 1)
    x, _ = _inputs(5)
    model = lambda z, t: u(z, t)
    ref = process.ddim_sample(_gd(mixed_prediction=mixed, clip_denoised=clip), model, logit,
                              x.shape, noise=x)
    monkeypatch.setattr(graphs, "available", lambda t: True)
    monkeypatch.setattr(graphs, "Capturer", _FakeCapturer)
    gd = _gd(mixed_prediction=mixed, clip_denoised=clip)
    recorder.clear()
    for _ in range(2):
        got = process.ddim_sample(gd, model, logit, x.shape, noise=x)
        assert torch.equal(got, ref)
    (update,) = gd._graphs.values()
    assert update.graph is not None and got.data_ptr() != update.img.data_ptr()
    assert _graphed(recorder) == [0] + [1] * 19
    assert len([s for s in recorder.spans if s[0] == "sampler.step"]) == 20


def test_update_engagement_rules(monkeypatch):
    """The update runs eagerly with step noise (eta != 0), with guidance, or
    off the card; its graphs are kept per shape and mixing logit."""
    monkeypatch.setattr(graphs, "available", lambda t: True)
    img, logit = torch.zeros(2, 4, 8, 8), torch.zeros(1, 4, 1, 1)
    assert process._graphed_update(_gd(ddim_sampling_eta=0.5), logit, img, None) is None
    gd = _gd()
    assert process._graphed_update(gd, logit, img, lambda z, t: z) is None
    a = process._graphed_update(gd, logit, img, None)
    assert a is process._graphed_update(gd, logit, img.clone(), None)
    assert a is not process._graphed_update(gd, logit.clone(), img, None)
    assert a is not process._graphed_update(gd, logit, torch.zeros(4, 4, 8, 8), None)
    assert dataclasses.replace(gd, w=2.0)._graphs == {}
    monkeypatch.setattr(graphs, "available", lambda t: False)
    assert process._graphed_update(_gd(), logit, img, None) is None


def test_eta_sampling_draws_its_noise_eagerly(monkeypatch):
    """With eta != 0 every step runs `_ddim_step` (its step noise from the
    generator), as off the card."""
    u = _unet()
    x, _ = _inputs(6)
    gd = _gd(ddim_sampling_eta=0.5)
    draw = lambda: process.ddim_sample(gd, lambda z, t: u(z, t), None, x.shape, noise=x,
                                       generator=torch.Generator().manual_seed(7))
    ref = draw()
    monkeypatch.setattr(graphs, "available", lambda t: True)
    monkeypatch.setattr(graphs, "Capturer", _FakeCapturer)
    assert torch.equal(draw(), ref) and gd._graphs == {}
