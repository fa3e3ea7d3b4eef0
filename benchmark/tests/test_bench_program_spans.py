"""The readers of the program's own spans and values (ddmi_tpu_torch/core/
tracing.py): each on a synthetic reduction and recorder; the reduction the
device readers share, with the worker's program spans of the profiled
stretch beside the harness's; a traced tiny CPU session of each domain, its
profile made up from the spans it hands to the reduction, reporting every
new entry and naming the idle gaps between its traced batches by the
program's spans; an untraced one installing no recorder; and no program
span named as one of the harness's."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from benchmark.harness import cell as cells
from benchmark.harness import trace
from benchmark.harness.cell import reader
from benchmark.metrics import _program
from ddmi_tpu_torch.core import tracing

MS = 1_000_000
NEW = {"celebahq_256.sample.b32": ["queue_wait_ms.sample", "service_host_ms.sample",
                                   "unet_norm_device_ms.sample"],
       "srn_cars.sample.b4": ["service_host_ms.scene", "step_host_ms.scene",
                              "unet_norm_device_ms.scene", "nerf_input_device_ms.scene",
                              "nerf_mlp_device_ms.scene"]}


@pytest.fixture(autouse=True)
def no_recorder():
    """Loading a reader installs the program's recorder: each test starts
    and ends without one."""
    tracing.disable()
    yield
    tracing.disable()


def _ranges(device_ms):
    n = len(device_ms)
    return trace.Ranges(np.zeros(n), np.ones(n), np.array(device_ms) / 1e3, np.zeros(n),
                        np.ones(n))


def _reduction(ranges, batches=2):
    return trace.Reduction((0, 1), batches, 0.5, ranges, [], [], 0, 0)


def test_device_readers(monkeypatch):
    monkeypatch.setattr(_program, "reduction", lambda run: run.trace)
    t = _reduction({"sampler.unet": _ranges([40.0, 41.0, 42.0, 43.0]),
                    "sampler.norm": _ranges([1.0] * 20 + [2.0] * 10),
                    "render.input": _ranges([3.0, 5.0]), "render.mlp": _ranges([1.5, 2.5])})
    run = SimpleNamespace(trace=t)
    assert reader("unet_norm_device_ms.sample").read(run) == pytest.approx(40.0 / 4)
    assert reader("nerf_input_device_ms.scene").read(run) == pytest.approx(8.0 / 2)
    assert reader("nerf_mlp_device_ms.scene").read(run) == pytest.approx(4.0 / 2)
    # a program that records no spans of its own reads nothing
    bare = SimpleNamespace(trace=_reduction({"sampler.unet": _ranges([40.0])}))
    for name in ("unet_norm_device_ms.sample", "nerf_input_device_ms.scene",
                 "nerf_mlp_device_ms.scene"):
        assert reader(name).read(bare) is None
        assert reader(name).read(SimpleNamespace(trace=None)) is None


def _session(spans=(), values=(), recorder=True):
    """A session whose profile ran from 100 ms to 200 ms on the host's
    clock; batches at [10, 40], [50, 90] (before), [110, 190] (profiled)
    and [210, 250] ms (after); the worker's thread id is 7."""
    tracing.disable()
    if recorder:
        rec = tracing.enable()
        rec.spans.extend(spans)
        rec.values.extend(values)
    worker = SimpleNamespace(_worker_thread=SimpleNamespace(ident=7))
    s = SimpleNamespace(paused=100 * MS, resumed=200 * MS, reduction_args=(1, 2),
                        svc=worker,
                        batch_log=[(0.010, 0.040, 4), (0.050, 0.090, 4), (0.110, 0.190, 4),
                                   (0.210, 0.250, 4)])
    return SimpleNamespace(session=s, trace=_reduction({}), window=SimpleNamespace(opened=0.005))


def _sp(name, a, b, tid=7):
    return (name, tid, int(a * MS), int(b * MS), {})


def test_service_host_ms_reads_the_batches_outside_the_profile():
    spans = [_sp("service.noise", 11, 13), _sp("service.reply", 38, 39),         # no collect
             _sp("service.collect", 40, 50), _sp("service.noise", 50, 52),
             _sp("service.finish", 60, 88), _sp("service.reply", 88, 90),
             _sp("service.collect", 90, 110), _sp("service.noise", 110, 115),     # profiled
             _sp("service.reply", 185, 190),
             _sp("service.collect", 190, 210), _sp("service.noise", 210, 211),
             _sp("service.reply", 247, 250),
             _sp("service.noise", 212, 213, tid=8)]                              # another thread
    # batch 2: collect 10 + noise 2 + reply 2; batch 4: collect 20 + noise 1 + reply 3
    assert reader("service_host_ms.sample").read(_session(spans)) == pytest.approx(19.0)
    assert reader("service_host_ms.scene").read(_session(spans)) == pytest.approx(19.0)
    assert reader("service_host_ms.sample").read(_session(recorder=False)) is None
    assert reader("service_host_ms.sample").read(_session([])) is None


def test_step_host_ms_reads_the_steps_outside_the_profile():
    spans = [_sp("sampler.step", 15, 17), _sp("sampler.step", 55, 59),
             _sp("sampler.step", 120, 150), _sp("sampler.step", 215, 218)]
    assert reader("step_host_ms.scene").read(_session(spans)) == pytest.approx(3.0)
    assert reader("step_host_ms.scene").read(_session(recorder=False)) is None


def test_queue_wait_ms_leaves_out_the_requests_that_met_the_profile():
    def wait(taken_ms, seconds):
        return ("service.queue_wait", 7, int(taken_ms * MS), seconds, {"batch": 1})

    values = [wait(50, 0.001 * (k + 1)) for k in range(40)]
    values += [wait(150, 9.0), wait(205, 0.1), wait(300, 1.0)]   # taken inside, waited through
    values += [("service.other", 7, 50 * MS, 5.0, {})]
    values += [wait(4, 0.002)]                                   # the warm-up's
    got = reader("queue_wait_ms.sample").read(_session(values=values))
    assert got == pytest.approx(np.percentile(np.arange(1, 41), 95))
    assert reader("queue_wait_ms.sample").read(_session(values=values[:10])) is None
    assert reader("queue_wait_ms.sample").read(_session(recorder=False)) is None


def test_reduction_hands_the_worker_spans_of_the_profiled_stretch(monkeypatch, capsys):
    handed = []

    def reduce(events, spans, marks, opened, stop):
        handed.append(sorted(spans))
        return _reduction({}, batches=1)

    monkeypatch.setattr(trace, "reduce", reduce)
    run = _session([_sp("service.noise", 50, 52),                      # before the profile
                    _sp("service.collect", 90, 110), _sp("sampler.norm", 120, 121),
                    _sp("sampler.norm", 130, 131, tid=8),               # another thread
                    _sp("service.reply", 185, 190)])
    run.session.reduction_args = (105 * MS, 195 * MS)
    run.session.events, run.session.prof = ["events"], SimpleNamespace(marks=[])
    run.session.spans = SimpleNamespace(done=[("service.batch", 110 * MS, 190 * MS)])
    got = _program.reduction(run)
    assert got is _program.reduction(run) and len(handed) == 1
    assert handed[0] == [("sampler.norm", 120 * MS, 121 * MS),
                         ("service.batch", 110 * MS, 190 * MS),
                         ("service.collect", 90 * MS, 110 * MS),
                         ("service.reply", 185 * MS, 190 * MS)]
    assert "program spans: idle gaps []" in capsys.readouterr().err
    # untraced, or no recorder: no reduction
    assert _program.reduction(SimpleNamespace(trace=None, session=run.session)) is None
    assert _program.reduction(_session(recorder=False)) is None


class _Ev:
    def __init__(self, name, start, end, cuda, corr):
        self._n, self._s, self._e, self._c, self._k = name, start, end, cuda, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return DeviceType.CUDA if self._c else DeviceType.CPU

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._k


# the program's spans that launch device work, in this made-up profile one
# operation each, over the middle half of the span
LAUNCHING = ("service.noise", "service.finish", "service.reply", "sampler.norm",
             "render.input", "render.mlp")


def _made_up_profile(spans, marks):
    """Events as the card's profile would hold them for `spans`, on the
    host's own clock: each closing spin kernel launched between its marks,
    one operation per launching program span."""
    ev, corr = [], 0
    for h0, h1 in marks:
        corr += 1
        ev.append(_Ev("cudaLaunchKernel", (h0 + h1) // 2, h1, False, corr))
        ev.append(_Ev("at::cuda::spin_kernel", h1, h1 + 1, True, corr))
    for name, s, e in spans:
        if name in LAUNCHING and e > s:
            corr += 1
            at = s + (e - s) // 4
            ev.append(_Ev("cudaLaunchKernel", at, at + 1, False, corr))
            ev.append(_Ev(f"op.{name}", at + 1, e - (e - s) // 4, True, corr))
    return ev


@pytest.mark.parametrize("domain", ["image", "nerf"])
def test_traced_tiny_session_reports_the_program_spans(monkeypatch, capsys, domain):
    import torch

    import benchmark.run as run
    from benchmark.harness import session
    from benchmark.tests import tiny

    torch.set_num_threads(2)
    handed, real_reduce = [], trace.reduce

    class Stand:
        def __init__(self):
            self.marks = []

        def start(self):
            pass

        def stop(self):
            for _ in range(trace.ALIGN):
                t0 = time.perf_counter_ns()
                self.marks.append((t0, time.perf_counter_ns() + 1))
            return "events"

    def made_up(events, spans, marks, opened, stop):
        handed.append({n for n, _, _ in spans})
        return real_reduce(_made_up_profile(spans, marks), spans, marks, opened, stop)

    monkeypatch.setattr(session.trace, "Profile", Stand)
    monkeypatch.setattr(session.trace, "reduce", made_up)
    name = "celebahq_256.sample.b32" if domain == "image" else "srn_cars.sample.b4"
    real = cells.load(name)
    conf = tiny.image_conf(0.02) if domain == "image" else tiny.nerf_conf(0.02)
    c = cells.Cell("tiny", 1, conf, tiny.traffic(trace_batches=2), real.end_to_end,
                   real.per_layer)
    monkeypatch.setattr(cells, "load", lambda workload, root=None: c)
    try:
        rc = run.main(["--workload", "tiny", "--seed", "3000000007", "--seconds", "3",
                       "--trace", "1"], device="cpu")
    finally:
        tracing.disable()
    assert rc == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out["correct"]
    for metric in NEW[name]:
        assert out["metrics"][metric]["value"] > 0, metric
    # the harness's reduction, then the one the device readers share, once
    harness, program = handed
    assert all(n.split("/")[0] in HARNESS for n in harness)
    assert {"service.collect", "service.noise", "service.reply", "sampler.step",
            "sampler.norm"} <= program - harness
    # the run's breakdown stays the harness's; the program's reduction names
    # the idle gaps by the program's spans, but for the window's opening
    # edge: the profile starts inside the harness's batch wrapper, before
    # the program's first span of the batch
    assert all(n.split("/")[0] in HARNESS or n == "between batches"
               for n, _ in out["breakdown"]["idle_gaps"])
    line = [x for x in captured.err.splitlines() if x.startswith("program spans: idle gaps ")]
    assert len(line) == 1
    gaps = [n for n, _ in json.loads(line[0].split("idle gaps ", 1)[1])]
    assert len(gaps) == 5 and gaps.count("between batches") <= 1
    assert all(n in program - set(HARNESS) for n in gaps if n != "between batches")


def test_untraced_tiny_session_installs_no_recorder(monkeypatch, capsys):
    import torch

    import benchmark.run as run
    from benchmark.tests import tiny

    torch.set_num_threads(2)
    real = cells.load("celebahq_256.sample.b32")
    c = cells.Cell("tiny", 1, tiny.image_conf(0.02), tiny.traffic(), real.end_to_end,
                   real.per_layer)
    monkeypatch.setattr(cells, "load", lambda workload, root=None: c)
    rc = run.main(["--workload", "tiny", "--seed", "3000000011", "--seconds", "1",
                   "--trace", "0"], device="cpu")
    assert rc == 0 and tracing.recorder() is None
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["metrics"]


HARNESS = ("service.batch", "sampler.unet", "sampler.sample_latents", "decoder.decode",
           "render.decode", "render.render", "kernels.attn_block")


def test_no_program_span_is_named_as_the_harness():
    """A program span named as one of the harness's (or as one followed by
    '/') would add its device time to that reader's."""
    import re

    from benchmark.domains import image, nerf
    from benchmark.harness import spans

    harness = {spans.BATCH, spans.UNET, spans.ATTN_BLOCK, *image.SPANS, *nerf.SPANS}
    assert harness == set(HARNESS)
    root = Path(__file__).resolve().parents[2] / "ddmi_tpu_torch"
    names = set()
    for path in root.rglob("*.py"):
        text = path.read_text()
        names |= set(re.findall(r"""\bspan\(\s*["']([^"']+)["']""", text))
        names |= set(re.findall(r"""\bobserve\(\s*["']([^"']+)["']""", text))
    assert {"service.collect", "service.queue_wait", "service.noise", "service.finish",
            "service.reply", "sampler.step", "sampler.norm", "render.input",
            "render.mlp"} <= names
    for n in names:
        assert not any(n == h or n.startswith(h + "/") for h in harness), n
