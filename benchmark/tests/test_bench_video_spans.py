"""The readers of the video cell's program spans: `xattn_device_ms`
(`sampler.xattn`), `decoder_xattn_device_ms` (`decoder.xattn`) and
`flash_roofline` (`kernels.mha_vmem/<shape>`, `kernels.flash/<shape>`),
each on a synthetic reduction, each left out for a program that records no
such span; the attention kernels' work from their shapes; and a traced tiny
CPU session of the video domain, its profile made up from the spans it
hands to the reduction, reporting the cross-plane readers and every
per-layer metric the cell inherits (the CPU path launches no kernel, so
`flash_roofline` is left out there)."""

import json
import time
from types import SimpleNamespace

import pytest

from benchmark.harness import cell as cells
from benchmark.harness import trace
from benchmark.harness.cell import reader
from benchmark.metrics import _program
from benchmark.tests.test_bench_program_spans import _Ev, _ranges, _reduction
from benchmark.work.flash import attention_bytes, attention_flops
from benchmark.work.peaks import BF16_FLOPS, HBM_BYTES
from ddmi_tpu_torch.core import tracing

CELL = "skytimelapse_256.sample.b8"
NEW = ("xattn_device_ms.scene", "decoder_xattn_device_ms.scene", "flash_roofline.scene")


@pytest.fixture(autouse=True)
def no_recorder():
    """Loading a reader installs the program's recorder: each test starts
    and ends without one."""
    tracing.disable()
    yield
    tracing.disable()


def test_the_cell_reports_the_new_readers():
    c = cells.load(CELL)
    names = [m["name"] for m in c.metrics(True)]
    assert set(NEW) <= set(names)
    assert [m["name"] for m in c.metrics(False)] == ["samples_per_s.scene", "setup_s"]
    for other in ("celebahq_256.sample.b32", "srn_cars.sample.b4"):
        assert not set(NEW) & {m["name"] for m in cells.load(other).metrics(True)}


def test_attention_work():
    # (2, 8, 73728, 64): two n^2 hd products per head; q, k, v and o in bf16
    assert attention_flops(2, 8, 73728, 64) == 4.0 * 2 * 8 * 73728**2 * 64
    assert attention_bytes(2, 8, 73728, 64) == 2 * 4.0 * 2 * 8 * 73728 * 64


def test_cross_plane_readers(monkeypatch):
    monkeypatch.setattr(_program, "reduction", lambda run: run.trace)
    t = _reduction({"sampler.xattn": _ranges([1.0] * 24 + [2.0] * 24),
                    "decoder.xattn": _ranges([10.0, 20.0, 30.0, 40.0, 50.0])})
    run = SimpleNamespace(trace=t)
    assert reader("xattn_device_ms.scene").read(run) == pytest.approx(72.0 / 2)
    assert reader("decoder_xattn_device_ms.scene").read(run) == pytest.approx(150.0 / 2)


def test_flash_roofline(monkeypatch):
    monkeypatch.setattr(_program, "reduction", lambda run: run.trace)
    # the 73,728-token call: compute-bound; a short one: bound by its bytes
    long, short = (1, 8, 73728, 64), (4, 16, 32, 96)
    least_long = attention_flops(*long) / BF16_FLOPS
    least_short = attention_bytes(*short) / HBM_BYTES
    assert attention_flops(*short) / BF16_FLOPS < least_short
    t = _reduction({"kernels.flash/1x8x73728x64": _ranges([1e3 * least_long / 0.4] * 2),
                    "kernels.mha_vmem/4x16x32x96": _ranges([1e3 * least_short / 0.1] * 3),
                    # the harness's attention blocks do not count
                    "kernels.attn_block/2x512x16x16x8": _ranges([500.0]),
                    "sampler.xattn": _ranges([500.0])})
    got = reader("flash_roofline.scene").read(SimpleNamespace(trace=t))
    want = 100.0 * (2 * least_long + 3 * least_short) / (
        2 * least_long / 0.4 + 3 * least_short / 0.1)
    assert got == pytest.approx(want)


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(_program, "reduction", lambda run: run.trace)
    bare = SimpleNamespace(trace=_reduction({"sampler.unet": _ranges([40.0]),
                                             "sampler.xattn": _ranges([])}))
    for name in NEW:
        assert reader(name).read(bare) is None
        assert reader(name).read(SimpleNamespace(trace=None)) is None


# the spans that launch device work in the made-up profile, one operation
# each over the middle half of the span
LAUNCHING = ("service.noise", "service.finish", "service.reply", "sampler.norm",
             "sampler.xattn", "decoder.xattn", "render.render", "kernels.attn_block")


def _made_up_profile(spans, marks):
    ev, corr = [], 0
    for h0, h1 in marks:
        corr += 1
        ev.append(_Ev("cudaLaunchKernel", (h0 + h1) // 2, h1, False, corr))
        ev.append(_Ev("at::cuda::spin_kernel", h1, h1 + 1, True, corr))
    for name, s, e in spans:
        if name.split("/")[0] in LAUNCHING and e > s:
            corr += 1
            at = s + (e - s) // 4
            ev.append(_Ev("cudaLaunchKernel", at, at + 1, False, corr))
            ev.append(_Ev(f"op.{name}", at + 1, e - (e - s) // 4, True, corr))
    return ev


def test_traced_tiny_video_session(monkeypatch, capsys):
    import torch

    import benchmark.run as run
    from benchmark.harness import session
    from benchmark.tests.tiny import traffic
    from benchmark.tests.tiny_video import video_conf

    torch.set_num_threads(2)
    real_reduce = trace.reduce

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
        return real_reduce(_made_up_profile(spans, marks), spans, marks, opened, stop)

    monkeypatch.setattr(session.trace, "Profile", Stand)
    monkeypatch.setattr(session.trace, "reduce", made_up)
    real = cells.load(CELL)
    c = cells.Cell("tiny", 1, video_conf(0.02), traffic(trace_batches=2), real.end_to_end,
                   real.per_layer)
    monkeypatch.setattr(cells, "load", lambda workload, root=None: c)
    try:
        rc = run.main(["--workload", "tiny", "--seed", "3000000019", "--seconds", "3",
                       "--trace", "1"], device="cpu")
    finally:
        tracing.disable()
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"]
    got = out["metrics"]
    for name in ("xattn_device_ms.scene", "decoder_xattn_device_ms.scene"):
        assert got[name]["value"] > 0, name
    assert "flash_roofline.scene" not in got
    # every inherited per-layer metric but those read from the card
    # (memory) or from the kernels' own spans
    for m in real.per_layer:
        if m["name"] not in ("peak_mem_gib.scene", "flash_roofline.scene"):
            assert m["name"] in got, m["name"]
