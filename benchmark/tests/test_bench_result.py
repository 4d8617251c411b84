"""The result line has exactly the keys its reader expects, in order, with
the compared numbers last."""

from __future__ import annotations

import json

import pytest

from benchmark import manifest

from conftest import run_tiny


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    r = json.loads(json.dumps(run_tiny("fm_bank.stream", trace=trace)))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == keys + (["breakdown"] if trace else []) + [
        "reference_s", "setup_parts", "compared"]
    assert list(r["setup_parts"]) == ["imports", "context", "traffic",
                                      "program", "warm"]
    if not trace:
        assert sum(r["setup_parts"].values()) == pytest.approx(
            r["metrics"]["setup_s"]["value"])
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    cell = manifest.cell("fm_bank.stream")
    want = [m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)]
    got = list(r["metrics"])
    assert set(got) <= set(want)
    assert all(set(v) >= {"value", "unit"} for v in r["metrics"].values())
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["device"]) == (dev | {"busy_s", "window_s"} if trace
                                else dev)
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    else:
        assert set(got) == set(want)
    assert set(r["compared"]) == {"audio_err", "audio_rms"}
    assert all(set(v) == {"value", "limit"} for v in r["compared"].values())
