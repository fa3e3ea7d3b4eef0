"""`unet_graphed_pct`: the share of the window's UNet forwards that replayed
the forward's CUDA graphs, from the program's `sampler.graphed` values, on
a synthetic recorder (the session of test_bench_program_spans.py: profile
from 100 to 200 ms, window opened at 5 ms)."""

import pytest

from benchmark.harness.cell import reader
from benchmark.tests.test_bench_program_spans import MS, _session, no_recorder  # noqa: F401


def _graphed(at_ms, value):
    return ("sampler.graphed", 7, int(at_ms * MS), value, {})


def test_unet_graphed_pct_reads_the_forwards_outside_the_profile():
    values = [_graphed(2, 0)]                                    # the warm-up's eager forward
    values += [_graphed(10 + k, 1) for k in range(30)]
    values += [_graphed(60, 0)]
    values += [_graphed(150, 0), _graphed(160, 0)]               # inside the profile
    values += [_graphed(220 + k, 1) for k in range(9)]
    values += [("service.queue_wait", 7, 50 * MS, 0.0, {})]
    for name in ("unet_graphed_pct.scene", "unet_graphed_pct.sample"):
        assert reader(name).read(_session(values=values)) == pytest.approx(100.0 * 39 / 40)


def test_unet_graphed_pct_without_the_values_reads_nothing():
    # a program that records no sampler.graphed value (the parent of the graphs)
    queue = [("service.queue_wait", 7, 50 * MS, 0.1, {})]
    assert reader("unet_graphed_pct.scene").read(_session(values=queue)) is None
    assert reader("unet_graphed_pct.scene").read(_session(recorder=False)) is None
