"""The yardstick's arithmetic on hand-worked numbers: bounds, rates,
percentiles and spreads, the trace's busy and idle time, and the metric
readers."""

from __future__ import annotations

import pytest

from benchmark import costs, harness, manifest
from benchmark.trace import Trace


def test_bounds():
    fm = manifest.cell("fm_bank.capture").config["cost"]
    # K1a's shape in PERF.md: 64 ch x 2^24, 9.66 GB at 3.35 TB/s = 2.885 ms
    assert costs.bound_s(fm, 64 * 2 ** 24) == pytest.approx(2.8847e-3,
                                                            rel=1e-4)
    pager = manifest.cell("pager.capture").config["cost"]
    # 2^26 x 8.0625 B = 541 MB: 0.1615 ms (its 100 operations: 0.100 ms)
    assert costs.bound_s(pager, 2 ** 26) == pytest.approx(1.6152e-4,
                                                          rel=1e-4)
    ops_bound = {"bytes_per_sample": 1.0, "flops_per_sample": 670.0}
    assert costs.bound_s(ops_bound, 1e9) == pytest.approx(1e-2)


def test_rates_and_percentiles():
    assert costs.msps(1e9, 2.0) == 500.0
    assert costs.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert costs.percentile([3.0], 95) == 3.0


def _trace():
    ops = [("a", 10.0, 20.0), ("b", 25.0, 10.0), ("a", 50.0, 10.0)]
    spans = [("entry", 0.0, 12.0), ("wait", 34.0, 55.0)]
    return Trace((0.0, 100.0), ops, spans, kernels=3)


def test_trace_busy_and_gaps():
    tr = _trace()
    assert tr.busy_intervals() == [[10.0, 35.0], [50.0, 60.0]]
    assert tr.busy_s == pytest.approx(35e-6)
    assert tr.op_s == pytest.approx(40e-6)
    assert tr.top_ops() == [["a", pytest.approx(30e-6)],
                            ["b", pytest.approx(10e-6)]]
    assert tr.idle_gaps() == [["outside", pytest.approx(40e-6)],
                              ["wait", pytest.approx(15e-6)],
                              ["entry", pytest.approx(10e-6)]]


def test_metric_readers():
    cell = manifest.cell("fm_bank.capture")
    win = harness.Window(seconds=2.0, blocks=4, dispatches=2,
                         latencies_ms=list(map(float, range(1, 21))),
                         entry_s=0.004, launches=8, trace=_trace())
    ctx = harness.Context(cell.config, cell.traffic, win, 7.5, 10 ** 6)

    def read(name):
        return cell.module("metrics", name).read(ctx)
    assert read("throughput") == pytest.approx(2.0)
    assert read("latency_p95") == pytest.approx(19.05)
    assert read("dispatch_p95_ms") == pytest.approx(19.05)
    assert read("setup_s") == 7.5
    assert read("device_idle_pct") == pytest.approx(65.0)
    assert read("enqueue_ms") == pytest.approx(2.0)
    assert read("wrapper_calls_per_block") == 2.0
    assert read("kernels_per_block") == 0.75
    # 4e6 samples x 9 B / 3.35 TB/s over 40 us of device operations
    assert read("step_roofline") == pytest.approx(
        100 * 4e6 * 9 / 3.35e12 / 40e-6)
    win.trace = None
    assert all(read(n) is None for n in ("device_idle_pct", "step_roofline",
                                         "kernels_per_block"))
