"""The trace reduction on a synthetic profile: the clocks tied by the pad
kernels, device operations given to the spans open at their launch, the
window ending with the last complete batch, busy time as the union of
operations, idle gaps named by the span open on the host."""

import pytest
from torch.autograd import DeviceType

from benchmark.harness import trace

MS = 1_000_000
OFFSET = 7_000 * MS          # the profile's clock ahead of the host's


class Ev:
    def __init__(self, name, start, end, cuda=False, corr=0):
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


def _profile():
    ev, marks = [], []
    for i in range(trace.PAD):                    # the opening pads, half lost
        if i % 2:
            ev.append(Ev("cudaLaunchKernel", OFFSET - MS + i, OFFSET - MS + i + 1, corr=400 + i))
            ev.append(Ev("at::cuda::spin_kernel", OFFSET, OFFSET + 1, cuda=True, corr=400 + i))
    for i in range(trace.ALIGN):                  # the closing marks, 10 us apart
        h0 = 26 * MS + i * 10_000
        marks.append((h0, h0 + 4_000))
        ev.append(Ev("cudaLaunchKernel", h0 + 2_000 + OFFSET, h0 + 3_000 + OFFSET, corr=500 + i))
        ev.append(Ev("at::cuda::spin_kernel", OFFSET + 30 * MS, OFFSET + 30 * MS + 1, cuda=True,
                     corr=500 + i))
    spans = [("service.batch", 1 * MS, 20 * MS), ("sampler.unet", 2 * MS, 5 * MS),
             ("sampler.unet", 6 * MS, 9 * MS), ("kernels.attn_block/2x64x4x4x2", 3 * MS, 4 * MS),
             ("service.batch", 30 * MS, 60 * MS)]            # not complete in the profile
    launches = [(1, 3 * MS + 10, 4 * MS, 6 * MS),      # in unet 1 and the attention block
                (2, 4 * MS + 500_000, 6 * MS, 8 * MS),  # in unet 1
                (3, 7 * MS, 8 * MS, 11 * MS),           # in unet 2
                (4, 15 * MS, 16 * MS, 17 * MS),         # in the batch only
                (5, 31 * MS, 32 * MS, 33 * MS)]         # in the incomplete batch
    for corr, at, s, e in launches:
        ev.append(Ev("cudaLaunchKernel", at + OFFSET, at + OFFSET + 1000, corr=corr))
        ev.append(Ev(f"kernel{corr}", s + OFFSET, e + OFFSET, cuda=True, corr=corr))
    return ev, spans, marks


def test_clock_offset():
    ev, _, marks = _profile()
    launches = [e.start_ns() for e in ev if e.name() == "cudaLaunchKernel" and e._k >= 400]
    offset, err = trace.clock_offset(launches, marks)
    # every mark bounds it to [launch - 4 us, launch]: 2 us either side of OFFSET
    assert offset == OFFSET and err == 2_000


def test_reduction():
    ev, spans, marks = _profile()
    r = trace.reduce(ev, spans, marks, 0, 25 * MS)
    ms = 1e-3
    assert r.window == (OFFSET, OFFSET + 20 * MS) and r.batches == 1
    assert r.window_s == pytest.approx(20 * ms)
    # union of [4, 6], [6, 8], [8, 11], [16, 17] inside [0, 20]
    assert r.busy_s == pytest.approx(8 * ms)
    unet = r.ranges["sampler.unet"]
    assert list(unet.device_s) == pytest.approx([4 * ms, 3 * ms])
    attn = r.select("kernels.attn_block")
    assert len(attn) == 1 and list(attn[0].device_s) == pytest.approx([2 * ms])
    batch = r.ranges["service.batch"]
    assert len(batch.start) == 1 and batch.device_s[0] == pytest.approx(8 * ms)
    assert batch.first_op[0] == OFFSET + 4 * MS and batch.last_op[0] == OFFSET + 17 * MS
    # gaps: [11, 16] and [17, 20] inside the batch, [0, 4] before it opened
    named = sorted((round(s / ms), n) for n, s in r.idle_gaps)
    assert named == [(3, "service.batch"), (4, "between batches"), (5, "service.batch")]
    assert r.top_ops[0] == ("kernel3", pytest.approx(3 * ms))
    assert "at::cuda::spin_kernel" not in dict(r.top_ops)


def test_traced_run_profiles_the_batches_after_the_first(monkeypatch, capsys):
    """A traced run on the CPU with a stand-in for the card's profile: the
    profile starts after the window's first batch and stops after the
    traced ones, from the service's worker; the host readers read the
    window outside the profile; the result line carries busy_s, window_s and breakdown."""
    import json

    import numpy as np
    import torch

    import benchmark.run as run
    from benchmark.harness import cell as cells
    from benchmark.harness import session
    from benchmark.tests import tiny

    torch.set_num_threads(2)
    calls = []

    class Stand:
        def __init__(self):
            self.marks = []

        def start(self):
            calls.append("start")

        def stop(self):
            calls.append("stop")
            return ["events"]

    def fake_reduce(events, spans, marks, opened, stop):
        assert events == ["events"] and opened < stop
        batches = [s for s in spans if s[0] == "service.batch" and opened <= s[1] <= stop]
        one = trace.Ranges(np.array([opened]), np.array([stop]), np.array([0.5]),
                           np.array([opened]), np.array([stop]))
        names = {n for n, _, _ in spans}
        assert {"sampler.unet", "sampler.sample_latents", "decoder.decode",
                "render.render", "render.decode"} <= names
        return trace.Reduction((opened, stop), len(batches), 0.5 * (stop - opened) / 1e9,
                               {"service.batch": one, "render.render": one,
                                "sampler.unet": one, "decoder.decode": one},
                               [("k", 0.1)], [("service.batch", 0.01)], 3, 1000)

    monkeypatch.setattr(session.trace, "Profile", Stand)
    monkeypatch.setattr(session.trace, "reduce", fake_reduce)
    c = tiny.cell(tiny.image_conf(tiny._load("celebahq_256")["check"]["limits"]["pixel_mae"]))
    monkeypatch.setattr(cells, "load", lambda name, root=None: c)
    rc = run.main(["--workload", "tiny", "--seed", "7", "--seconds", "1.5", "--trace", "1"],
                  device="cpu")
    assert rc == 0 and calls == ["start", "stop"]
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    m = out["metrics"]
    assert m["unet_host_ms.sample"]["value"] > 0 and m["mfu.sample"]["value"] > 0
    assert m["device_idle.sample"]["value"] == pytest.approx(50.0)


def test_host_readers_leave_out_the_profile_and_its_read_out():
    """Batches and UNet forwards from before the profiler starts to the end
    of its read-out are left out, and so are those seconds of the window."""
    from types import SimpleNamespace

    from benchmark.harness.session import Session

    s = SimpleNamespace(paused=10 * 10**9, resumed=30 * 10**9, reduction_args=(1, 2),
                        batch_log=[(7.0, 9.5, 4), (10.0, 12.0, 4), (12.5, 14.0, 4), (31.0, 33.0, 2)],
                        unet_log=[(8.0, 0.01), (11.0, 0.5), (32.0, 0.03)])
    samples, seconds, forwards = Session.unprofiled(s, 40.0)
    assert samples == 6 and seconds == pytest.approx(20.0)
    assert forwards == [0.01, 0.03]
    s.reduction_args = None
    assert Session.unprofiled(s, 40.0) is None
