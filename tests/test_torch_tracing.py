"""The program's spans (``utils/profiling.span``): off and free without a
profiler, on and nested under ``torch.profiler`` on each entry path the
benchmark's cells drive (``Pipeline.apply``, ``ChunkedStep.run`` and the
pager scanner's step), the store's bound, and the private flag that
switches them.  The card test (marker ``cuda``) runs with ``python -m
pytest --noconftest -m cuda tests/test_torch_tracing.py``."""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest
import torch

import libsdr_tpu_torch as L
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.graph import Combine, Tee, _leaves, kernel_entries
from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand
from libsdr_tpu_torch.parallel.wideband import build_scanner_step
from libsdr_tpu_torch.utils import profiling

C, B = 3, 4096                  # FM lanes and block
M, FS = 16, 16 * 24_000.0       # scanner channels and band rate
SCAN_BLOCK = M * 16 * 64


def _fm_chain():
    return [IQBaseBand(fc=120e3, width=200e3, order=64, decim=4,
                       design="textbook"), FMDemod(gain=1.0), FMDeemph()]


def _block(seed: int, shape):
    g = torch.Generator().manual_seed(seed)
    return Complex(torch.randn(shape, generator=g),
                   torch.randn(shape, generator=g))


def _pipeline_path(tee: bool = False):
    stages = ([Tee([L.Pipeline(_fm_chain()), L.Pipeline(_fm_chain())]),
               Combine(2)] if tee else _fm_chain())
    p = L.Pipeline(stages)
    p.bind(L.StreamSpec(np.complex64, 960e3, B, channels=(C,)))
    xs = [_block(i, (C, B)) for i in range(2)]

    def run():
        c, ys = p.init_carry("cpu"), []
        for x in xs:
            c, y = p.compile()(c, x)
            ys.append(y)
        return ys
    return run


def _chunked_path():
    p = L.Pipeline(_fm_chain())
    p.bind(L.StreamSpec(np.complex64, 960e3, B, channels=(C,)))
    xs = tuple(_block(i, (C, B)) for i in range(2))
    return lambda: p.compile_chunked("unroll").run(p.init_carry("cpu"), xs)


def _scanner_path():
    step, init, place = build_scanner_step(M, SCAN_BLOCK, FS,
                                           compact_window=16, packed=True,
                                           device="cpu")
    xs = [_block(10 + i, (SCAN_BLOCK,)) for i in range(2)]

    def run():
        c, ys = init(), []
        for x in xs:
            c, y = step(c, place(x))
            ys.append(y)
        return ys
    return run


FUSED = {"stage:FMBasebandFused": ["wrapper:fir_fm_exact"]}
# path: (its runner, the top-level span, its child spans, the spans under
# the others by parent name, the top-level spans a run opens)
PATHS = {
    "pipeline": (_pipeline_path, "pipeline", ["stage:FMBasebandFused"],
                 FUSED, 2),
    "tee": (lambda: _pipeline_path(tee=True), "pipeline",
            ["stage:Tee", "stage:Combine"],
            {"stage:Tee": ["stage:Pipeline", "stage:Pipeline"],
             "stage:Pipeline": ["pipeline"], **FUSED}, 2),
    "chunked": (_chunked_path, "chunked.run", ["pipeline", "pipeline"],
                {"pipeline": ["stage:FMBasebandFused"], **FUSED}, 1),
    "scanner": (_scanner_path, "scanner.step",
                ["scanner.channelize", "scanner.ask", "scanner.pll",
                 "scanner.compact"], {"scanner.pll": ["wrapper:pll"]}, 2),
}


def _profiled(fn):
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            out = fn()
    return out, profiling.records(), prof


@pytest.fixture(autouse=True)
def _fresh_store():
    profiling.reset()
    yield
    profiling.reset()


def test_flag_flips_with_the_profiler():
    """The private flag the gate reads exists and follows a session: a
    torch without it would leave every span off unseen."""
    assert profiling._FLAG is torch.autograd.profiler
    assert torch.autograd.profiler._is_profiler_enabled is False
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert isinstance(profiling.span("x"), profiling._Span)
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert profiling.span("x") is profiling._OFF


def test_span_off_allocates_and_records_nothing(monkeypatch):
    """With no profiler a span is the one shared no-op context: no span
    object is made (the live one refuses here) and nothing is stored."""
    def refuse(*_):
        raise AssertionError("a live span was made with no profiler")
    monkeypatch.setattr(profiling, "_Span", refuse)
    for device in (False, True):
        assert profiling.span("a", device) is profiling._OFF
        with profiling.span("b", device):
            pass
    assert profiling.spanned("c")(lambda v: v + 1)(1) == 2
    assert profiling.records() == [] and profiling.summary() == {}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_outputs_equal_with_spans_on_and_off(path):
    run = PATHS[path][0]()
    off = run()
    assert profiling.records() == []
    on, recs, _ = _profiled(run)
    assert recs
    a, b = _leaves(off)[0], _leaves(on)[0]
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_under_each_entry(path):
    make, top, top_kids, children, n_top = PATHS[path]
    _, recs, _ = _profiled(make())
    tops = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in tops] == [top] * n_top
    for i in tops:
        assert [k.name for k in recs if k.parent == i] == top_kids
    assert len({recs[i].dispatch for i in tops}) == n_top
    for i, r in enumerate(recs):
        assert r.t1_ns is not None and r.t0_ns <= r.t1_ns
        assert r.events is None            # host work: no device events
        if r.parent is not None:
            p = recs[r.parent]
            assert r.parent < i and p.dispatch == r.dispatch
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns
    for parent, names in children.items():
        for i, r in enumerate(recs):
            if r.name == parent:
                kids = [k.name for k in recs if k.parent == i]
                assert kids == names, (parent, kids)
    # self time: the total less the child spans' intervals
    s = profiling.summary()
    assert set(s) == {r.name for r in recs}
    for name, v in s.items():
        mine = [i for i, r in enumerate(recs) if r.name == name]
        kids = sum(k.t1_ns - k.t0_ns for k in recs if k.parent in mine)
        assert v["calls"] == len(mine)
        assert v["self_host_ms"] == pytest.approx(v["host_ms"] - kids * 1e-6,
                                                  abs=1e-6)
        assert v["device_ms"] is None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_in_the_chrome_trace(path, tmp_path):
    make, top, top_kids, children, _ = PATHS[path]
    _, recs, prof = _profiled(make())
    f = tmp_path / "trace.json"
    prof.export_chrome_trace(str(f))
    ev = [e for e in json.loads(f.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    caller = next(e for e in ev if e["name"] == "caller")
    lo, hi = caller["ts"], caller["ts"] + caller["dur"]
    mine = [e for e in ev if e["name"] != "caller"]
    assert sorted(e["name"] for e in mine) == sorted(r.name for r in recs)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in mine)
    assert {top, *top_kids, *children} <= {e["name"] for e in mine}


def test_store_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "STORE_LIMIT", 3)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("a"):
            with profiling.span("b"):
                pass
        for _ in range(4):
            with profiling.span("c"):
                with profiling.span("d"):
                    pass
    assert [r.name for r in profiling.records()] == ["a", "b", "c"]
    assert profiling.records()[2].parent is None
    assert profiling.dropped() == 7
    profiling.reset()
    assert profiling.records() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("entry", kernel_entries(), ids=lambda e: e.__name__)
def test_wrappers_keep_their_counters(entry):
    """Each kernel entry is spanned where it is defined, its counters on
    the object every caller holds."""
    assert entry.__wrapped__.__name__ == entry.__name__
    assert isinstance(entry.launches, int)
    module = importlib.import_module(entry.__module__)
    assert getattr(module, entry.__name__) is entry


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device spans time the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_capture_once_and_device_times(cuda):
    p = L.Pipeline(_fm_chain())
    p.bind(L.StreamSpec(np.complex64, 960e3, B, channels=(C,)))
    step = p.compile_chunked("unroll")
    xs = tuple(_block(i, (C, B)).map(lambda v: v.to(cuda)) for i in range(2))

    def chunked():
        c = p.init_carry(cuda)
        for _ in range(3):
            c, _ = step.run(c, xs)
        return c
    _, recs, _ = _profiled(chunked)
    names = [r.name for r in recs if r.parent is not None
             and recs[r.parent].name == "chunked.run"]
    assert names == ["chunked.capture", "chunked.copy_in", "chunked.replay",
                     "chunked.copy_in", "chunked.replay",
                     "chunked.copy_in", "chunked.replay"]
    assert all(r.events is None for r in recs)      # no events in a capture

    step_s, init, place = build_scanner_step(M, SCAN_BLOCK, FS,
                                             compact_window=16, packed=True,
                                             device=cuda)
    x = _block(3, (SCAN_BLOCK,)).map(lambda v: v.to(cuda))

    def scan():
        c = init()
        for _ in range(3):
            c, y = step_s(c, place(x))
        return y
    _, recs, _ = _profiled(scan)
    timed = {"scanner.step", "scanner.compact"}
    for i, r in enumerate(recs):
        assert (r.events is not None) == (r.name in timed), r.name
        if r.parent is None:
            assert r.name == "scanner.step"
            kids = [k for k in recs if k.parent == i]
            assert [k.name for k in kids] == PATHS["scanner"][2]
            compact = kids[-1].device_ms
            # the compaction's events lie inside the step's; each interval
            # is rounded to the events' resolution (about half a
            # microsecond)
            assert 0.0 <= compact <= r.device_ms + 1e-3
    s = profiling.summary()
    assert s["scanner.step"]["device_ms"] > 0.0
    assert s["scanner.compact"]["device_ms"] > 0.0
    assert s["scanner.pll"]["device_ms"] is None
