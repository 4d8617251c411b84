"""The readers of the program's spans (``entry_host_ms``, ``op_host_ms``,
``wrapper_host_ms``, ``compaction_device_pct``, ``entry_idle_pct``) on
hand-made records and a hand-made trace, each metric in exactly its
cells, and, on the card, the placement of the program's spans on the
trace's clock against the program's own annotations in it."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from benchmark import harness, manifest, signals
from benchmark import trace as trace_mod
from benchmark.trace import Trace

from conftest import tiny_cell

NEW = ("entry_host_ms", "op_host_ms", "wrapper_host_ms",
       "compaction_device_pct", "entry_idle_pct")
TOP = ("pipeline", "chunked.run", "scanner.step")


class Rec:
    """A stand-in for the program's ``SpanRecord``."""

    def __init__(self, name, parent, t0_us, t1_us, device_ms=None,
                 shift_ns=0):
        self.name, self.parent = name, parent
        self.t0_ns = shift_ns + int(t0_us * 1000)
        self.t1_ns = shift_ns + int(t1_us * 1000)
        self.device_ms = device_ms


def _records(shift_ns: int) -> list:
    """Two dispatches (us on the program's clock, less ``shift_ns``): a
    scanner step of 150 us with its compaction and PLL (and the PLL's
    wrapper), then one of 100 us with a stage whose wrapper calls
    another."""
    r = lambda *a, **k: Rec(*a, shift_ns=shift_ns, **k)  # noqa: E731
    return [
        r("scanner.step", None, 0, 150, device_ms=2.0),
        r("scanner.compact", 0, 30, 90, device_ms=0.5),
        r("scanner.pll", 0, 90, 140),
        r("wrapper:pll", 2, 95, 135),
        r("scanner.step", None, 1000, 1100, device_ms=1.0),
        r("stage:FMBasebandFused", 4, 1010, 1090),
        r("wrapper:fir_fm_exact", 5, 1020, 1070),
        r("wrapper:fir_mxu", 6, 1030, 1060),
    ]


def _trace(entries=(100.0, 500.0)) -> Trace:
    """A 1000 us window busy over [0, 120], [200, 260] and [400, 900]: idle
    [120, 200], [260, 400], [900, 1000]; the benchmark's entry spans start
    at ``entries``."""
    ops = [("k", 0.0, 120.0), ("k", 200.0, 60.0), ("k", 400.0, 500.0)]
    spans = [("entry", s, s + 200.0) for s in entries] + [
        ("wait", 300.0, 400.0)]
    return Trace((0.0, 1000.0), ops, spans, kernels=3)


def _ctx(trace) -> harness.Context:
    cell = manifest.cell("pager.capture")
    win = harness.Window(seconds=1e-3, blocks=2, dispatches=2,
                         latencies_ms=[], entry_s=4e-4, launches=4,
                         trace=trace)
    return harness.Context(cell.config, cell.traffic, win, 1.0, 1)


def _read(name, ctx):
    return manifest.cell("pager.capture").module("metrics", name).read(ctx)


@pytest.fixture
def program(monkeypatch):
    """Hands the readers ``recs`` as the program's records."""
    from libsdr_tpu_torch.utils import profiling

    def give(recs):
        monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return give


@pytest.mark.parametrize("shift_ns", [0, 123_457, 7_123_456_789_012])
def test_entry_idle_placed_under_any_clock_offset(program, shift_ns):
    program(_records(shift_ns))
    ctx = _ctx(_trace())
    # placed: the first step over [100, 250], idle inside it [120, 200];
    # the second over [500, 600], all busy
    assert _read("entry_idle_pct", ctx) == pytest.approx(8.0)
    by = manifest.cell("pager.capture").module(
        "metrics", "entry_idle_pct").idle_by_span(ctx)
    # the first step's edges: itself [100, 130], compact [130, 190], pll
    # [190, 240] (its wrapper [195, 235]), itself [240, 250]
    want = {"outside": 240e-6, "scanner.step": 10e-6,
            "scanner.compact": 60e-6, "scanner.pll": 5e-6,
            "wrapper:pll": 5e-6}
    assert set(by) == set(want)
    for k, v in want.items():
        assert by[k] == pytest.approx(v, abs=1e-12), k


@pytest.mark.parametrize("entries", [(100.0,), (100.0, 500.0, 800.0)])
def test_entry_idle_none_when_counts_differ(program, entries):
    program(_records(0))
    assert _read("entry_idle_pct", _ctx(_trace(entries))) is None


def test_host_and_device_readers(program):
    program(_records(5_000))
    ctx = _ctx(_trace())
    # the top-level spans, 150 + 100 us, over 2 dispatches
    assert _read("entry_host_ms", ctx) == pytest.approx(0.125)
    # self time of the Op spans: compact 60, pll 50 - 40, the stage 80 -
    # 50, over 2 blocks
    assert _read("op_host_ms", ctx) == pytest.approx(0.05)
    # the outermost wrappers: 40 + 50 (the nested one once), over 2 blocks
    assert _read("wrapper_host_ms", ctx) == pytest.approx(0.045)
    # compaction 0.5 ms of the steps' 2.0 + 1.0
    assert _read("compaction_device_pct", ctx) == pytest.approx(100 / 6)


def test_readers_report_nothing_without_spans(program, monkeypatch):
    """A program without records (the parent of the spans, or a run with
    no profiler) gives no reading and no error."""
    from libsdr_tpu_torch.utils import profiling
    ctx = _ctx(_trace())
    program([r for r in _records(0) if not r.name.startswith("wrapper")])
    assert _read("wrapper_host_ms", ctx) is None
    assert _read("entry_idle_pct", _ctx(None)) is None
    program([])
    assert all(_read(n, ctx) is None for n in NEW)
    monkeypatch.delattr(profiling, "records")
    assert all(_read(n, ctx) is None for n in NEW)


@pytest.mark.parametrize("metric", NEW)
def test_each_span_metric_in_exactly_its_cells(metric):
    man = manifest.load()
    entry = next(m for m in man["per_layer"] if m["name"] == metric)
    assert entry["source"] == "program_span"
    assert entry["moves"] == "throughput"
    for w in man["workloads"]:
        names = [m["name"] for m in manifest.cell(w["name"]).per_layer]
        assert (metric in names) == (w["name"] in entry["workloads"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fm_bank.capture", "pager.capture",
                                  "fm_bank.stream"])
def test_placement_against_the_programs_annotations(card, name, tmp_path):
    """On the card, tiny cells: each top-level program span, placed at its
    entry's start, lies inside that entry by the program's own annotation
    of it in the exported trace; each reader reads in exactly its cells,
    ``entry_host_ms`` within ``enqueue_ms`` and ``entry_idle_pct`` within
    ``device_idle_pct``."""
    from libsdr_tpu_torch.utils import profiling
    cell = tiny_cell(name)
    made = signals.make(cell.config, cell.traffic, 5, card, root=cell.root)
    system = cell.module("systems", cell.config["system"]).System(
        cell.config, cell.traffic, made, 5, card)
    system.warm()
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        win = harness.drive(system, 0.3, int(cell.traffic["in_flight"]),
                            card, profiled=True)
    f = tmp_path / "trace.json"
    prof.export_chrome_trace(str(f))       # a trace is saved only once

    class Saved:
        def export_chrome_trace(self, path):
            shutil.copyfile(f, path)
    win.trace = trace_mod.read(Saved())
    ev = sorted((e["ts"], e["ts"] + e["dur"]) for e in json.loads(
        f.read_text())["traceEvents"] if e.get("ph") == "X"
        and e.get("cat") == "user_annotation" and e["name"] in TOP)
    entries = sorted((s, e) for n, s, e in win.trace.spans if n == "entry")
    ctx = harness.Context(cell.config, cell.traffic, win, 1.0,
                          system.samples_per_block)
    mod = cell.module("metrics", "entry_idle_pct")
    placed = sorted(s for _, d, s, _ in mod.placed(ctx) if d == 0)
    assert len(placed) == len(ev) == len(entries) == win.dispatches
    assert placed == pytest.approx([s for s, _ in entries], abs=1e-3)
    # each program span lies inside its entry (the trace's clock rounds to
    # a nanosecond): the placement errs early by at most the entry's lead
    assert all(s - 1e-3 <= a and b <= e + 1e-3
               for (a, b), (s, e) in zip(ev, entries))
    lead = sorted(a - s for (a, _), (s, _) in zip(ev, entries))
    print(f"{name}: program span after its entry by {lead[0]:.1f}-"
          f"{lead[-1]:.1f} us, median {lead[len(lead) // 2]:.1f}")
    got = {m: cell.module("metrics", m).read(ctx) for m in NEW}
    for m in NEW:
        mine = m in [x["name"] for x in cell.per_layer]
        assert (got[m] is not None) == mine, m
    assert got["entry_host_ms"] <= cell.module(
        "metrics", "enqueue_ms").read(ctx)
    assert got["entry_idle_pct"] <= cell.module(
        "metrics", "device_idle_pct").read(ctx)
    if got["compaction_device_pct"] is not None:
        assert 0.0 < got["compaction_device_pct"] < 100.0
