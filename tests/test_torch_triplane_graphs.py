"""The TriplaneUNet's forward as CUDA graphs cut at its attention calls
(core/graphs.py's `Segments` and `eager`, nn/unet_triplane.py's
`_SegmentedForward`), on the CPU.

Graphs are stood in for by `_FakeCapturer`, whose graphs log their replays
and run nothing: the capture runs the eager forward with a cut at each
attention call, and a replay runs the cuts' calls between the graphs.  The
card's replays are held to the eager forward in
tests/test_torch_video_reference_cuda.py."""

import functools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark.tests.tiny_video import video_conf  # noqa: E402
from ddmi_tpu_torch.core import graphs, tracing  # noqa: E402
from ddmi_tpu_torch.core.config import config_from_dict  # noqa: E402
from ddmi_tpu_torch.nn.attention1d import AttnBlock1D  # noqa: E402
from ddmi_tpu_torch.nn.unet import AttentionBlock  # noqa: E402
from ddmi_tpu_torch.nn.unet_triplane import TriplaneUNet  # noqa: E402


class _FakeGraph:
    def __init__(self, log, i):
        self.log, self.i = log, i

    def replay(self):
        self.log.append(("graph", self.i))


class _FakeCapturer:
    log: list = []
    begun = ended = abandoned = 0

    def __init__(self, device):
        self.graphs = 0

    def begin(self):
        _FakeCapturer.begun += 1

    def abandon(self):
        _FakeCapturer.abandoned += 1

    def end(self):
        _FakeCapturer.ended += 1
        self.graphs += 1
        return _FakeGraph(_FakeCapturer.log, self.graphs - 1)


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "available", lambda t: True)
    monkeypatch.setattr(graphs, "Capturer", _FakeCapturer)
    _FakeCapturer.log = []
    _FakeCapturer.begun = _FakeCapturer.ended = _FakeCapturer.abandoned = 0


@pytest.fixture
def recorder():
    rec = tracing.enable()
    yield rec
    tracing.disable()


def _unet(seed=0):
    """The tiny video config's TriplaneUNet (benchmark/tests/tiny_video.py):
    two levels, attention blocks at ds 2, xt and yt of one shape (stacked
    on the batch), with random output convolutions."""
    cfg = config_from_dict(video_conf()["config"]).model.unetconfig
    torch.manual_seed(seed)
    u = TriplaneUNet(cfg).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in u.parameters():
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return u


def _inputs(u, seed=2, b=2):
    n = sum(h * w for h, w in u.cfg.plane_sizes)
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, n, u.cfg.in_channels), generator=g),
            torch.randint(0, 1000, (b,), generator=g))


def _graphed(rec):
    return [v for name, _, _, v, _ in rec.values if name == "sampler.graphed"]


def _attention_calls(u):
    """AttentionBlock calls of a forward (each block on xy, then on xt and
    yt stacked) and its cross-plane attentions."""
    blocks = sum(isinstance(m, AttentionBlock) for m in u.modules())
    cross = sum(isinstance(m, AttnBlock1D) for m in u.modules())
    return 2 * blocks, cross


def test_eager_outside_a_capture_is_the_call():
    assert graphs.eager(lambda x: x + 1, torch.zeros(2)).tolist() == [1.0, 1.0]


def test_span_outside_a_capture_is_the_tracing_span(recorder):
    with graphs.span("sampler.xattn"):
        pass
    assert [s[0] for s in recorder.spans] == ["sampler.xattn"]


def test_an_error_inside_a_capture_abandons_it(fake_graphs):
    """The capture is left unfinished and `eager` calls plainly again."""
    seg = graphs.Segments("cpu")

    def fails():
        graphs.eager(lambda x, out=None: x, torch.zeros(2))
        raise RuntimeError("inside the capture")

    with pytest.raises(RuntimeError, match="inside the capture"):
        seg.capture(fails)
    assert _FakeCapturer.abandoned == 1 and len(seg.steps) == 1
    assert graphs.eager(lambda x: x + 1, torch.zeros(1)).item() == 1.0


def test_segmented_capture_runs_the_eager_forward(fake_graphs, recorder):
    """A key's first forward runs eagerly, its second captures the eager
    forward, bit for bit the eager output, cut at every AttentionBlock, at
    every cross-plane attention's kernel call and at both ends of its span:
    one graph more than steps; each cut writes a static tensor of its own."""
    u = _unet()
    x, t = _inputs(u)
    with torch.no_grad():
        ref = u(x, t, return_cache=True)[0]
    blocks, cross = _attention_calls(u)
    recorder.clear()
    with torch.inference_mode():
        outs = [u(x, t) for _ in range(2)]
    for out in outs:
        assert torch.equal(out, ref)
    assert _graphed(recorder) == [0, 1]
    (fwd,) = u._graphs._forwards.values()
    seg = fwd.segments
    assert blocks == 8 and cross == 8
    assert len(seg.steps) == blocks + 3 * cross and len(seg.graphs) == len(seg.steps) + 1
    assert _FakeCapturer.begun == _FakeCapturer.ended == len(seg.graphs)
    bufs = [s.keywords["out"] for s in seg.steps
            if isinstance(s, functools.partial) and "out" in s.keywords]
    assert len(bufs) == blocks + cross
    assert len({b.data_ptr() for b in bufs}) == len(bufs)
    assert not any(b.is_inference() for b in bufs)


def test_replay_runs_the_cuts_between_the_graphs(fake_graphs, recorder):
    """A replay runs graph 0, then each step and the next graph, in the
    capture's order: the AttentionBlocks' hooks fire once a forward, in the
    eager forward's order, and each cross-plane attention records its
    sampler.xattn span, which holds its kernel's call.  The output is a
    tensor of its own."""
    u = _unet()
    x, t = _inputs(u)
    fired = []
    names = {m: n for n, m in u.named_modules()}
    for m in u.modules():
        if isinstance(m, AttentionBlock):
            m.register_forward_hook(lambda m, i, o: fired.append(names[m]))
    with torch.inference_mode():
        u(x, t)
        order, fired[:] = list(fired), []
        u(x, t)
        assert fired == order
        fired[:] = []
        _FakeCapturer.log.clear()
        recorder.clear()
        out = u(x, t)
    (fwd,) = u._graphs._forwards.values()
    assert fired == order
    assert _FakeCapturer.log == [("graph", i) for i in range(len(fwd.segments.graphs))]
    spans = [s[0] for s in recorder.spans]
    assert spans.count("sampler.xattn") == _attention_calls(u)[1]
    assert "sampler.norm" not in spans  # inside the graphs
    assert len(fired) == _attention_calls(u)[0]
    assert out.data_ptr() != fwd.out.data_ptr()


@pytest.mark.parametrize("kw", [{"return_cache": True}, {"cache": "made"}],
                         ids=["return_cache", "cache"])
def test_an_encoder_cache_runs_eagerly(fake_graphs, recorder, kw):
    u = _unet()
    x, t = _inputs(u)
    with torch.no_grad():
        if kw.get("cache") == "made":
            kw = {"cache": u(x, t, return_cache=True)[1]}
        recorder.clear()
        for _ in range(3):
            u(x, t, **kw)
    assert _graphed(recorder) == [0, 0, 0]
    assert _FakeCapturer.begun == 0 and not u._graphs._forwards


def test_triplane_forward_on_the_cpu_runs_eagerly(recorder):
    u = _unet()
    x, t = _inputs(u)
    with torch.no_grad():
        for _ in range(3):
            u(x, t)
    assert _graphed(recorder) == [0, 0, 0] and not u._graphs._forwards
