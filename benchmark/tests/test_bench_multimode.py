"""The multi-mode bank's cell: its generator's rounding, its cost by hand,
its line codes against the program's decoders, its span metrics on
hand-made records (and nothing without the spans), each in exactly its
cell, and its control, which reads ``correct`` false."""

from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark import costs, harness, manifest
from benchmark.reference import codes
from benchmark.signals import mode_band

from conftest import tiny_cell

NEW = ("bank_host_ms", "bank_pll_device_pct", "bank_psk31_device_pct",
       "bank_compact_device_pct")


def test_rounding_keeps_the_full_block_and_fits_the_tiny_one():
    cell = manifest.cell("multimode.capture")
    assert mode_band.decimation(cell.config) == 12
    assert mode_band.block_frames(cell.config, cell.traffic) == 196_608
    assert 196_608 * 256 == cell.traffic["block_samples"]
    tiny = tiny_cell("multimode.capture")
    # 2^18 / 16 = 16,384 frames, down to a multiple of lcm(16, 12) = 48
    assert mode_band.block_frames(tiny.config, tiny.traffic) == 16_368


def test_cost_bound_by_hand():
    cost = manifest.cell("multimode.capture").config["cost"]
    b = 196_608 * 256
    # 8.106 B x 50,331,648 = 408.0 MB at 3.35 TB/s: 121.79 us; its 96
    # operations a sample at 67 TFLOP/s: 72.12 us
    assert costs.bound_s(cost, b) == pytest.approx(1.21786e-4, rel=1e-4)
    assert 96 * b / costs.F32_FLOPS_PER_S == pytest.approx(7.212e-5,
                                                           rel=1e-3)


def test_codes_are_the_programs():
    from libsdr_tpu_torch.decode import (AX25Decoder, BaudotDecoder,
                                         VaricodeDecoder)
    from libsdr_tpu_torch.decode.varicode import _CODES

    rng = np.random.default_rng(8)
    noise = rng.integers(0, 2, 400).astype(np.uint8)
    frame = codes.ui_frame("W17", "APRS", b"!4903.50N/07201.75W-bank 17")
    bits = np.concatenate([noise, codes.hdlc_bits(frame, 8), noise])
    dec = AX25Decoder()
    dec.process(bits)
    assert dec.frames == codes.deframe(bits) == [frame]
    lv = codes.nrzi(codes.hdlc_bits(frame, 8))
    assert np.array_equal((lv[1:] == lv[:-1]).astype(np.uint8),
                          codes.hdlc_bits(frame, 8)[1:])
    half = np.concatenate([noise[:50], codes.ita2_half_bits("DE W17 K"),
                           noise[:40]])
    text = BaudotDecoder(stop_bits="1.5").process(half)
    assert text == codes.ita2_decode(half) and "DE W17 K" in text
    var = np.concatenate([noise[:77], np.zeros(8, np.uint8),
                          codes.varicode_bits("cq de wbh k 0128"),
                          noise[:50]])
    text = VaricodeDecoder().process(var)
    assert text == codes.varicode_decode(var) and "cq de wbh k" in text
    assert all(_CODES[c] == int(v, 2) for c, v in codes.VARICODE.items())


def test_missed_counts_each_mode_against_its_plan():
    from benchmark.reference.multimode import missed
    M = mode_band.Message
    plan = [M(0, "pocsag", 0, 1, 1.0, "p0"), M(1, "psk31", 0, 1, 1.0, "ab"),
            M(2, "pocsag", 0, 1, 1.0, "p2"), M(3, "psk31", 0, 1, 1.0, "cd"),
            M(5, "psk31", 0, 1, 1.0, "ef"), M(7, "psk31", 0, 1, 1.0, "gh")]
    got = {0: ["p0"], 1: "xaby", 2: [], 3: "c d", 5: "ef", 7: "gh"}
    # pocsag 1 of 2 missed, psk31 1 of 4 ("c d" holds no "cd")
    assert missed(plan, got) == 0.5
    assert missed(plan[1::2], got) == pytest.approx(1 / 3)
    assert missed([], {}) == 0.0


def test_psk31_burst_rises_from_and_falls_to_silence():
    cell = manifest.cell("multimode.capture")
    fs = cell.config["sample_rate"] / cell.config["channels"]
    tr = cell.traffic["psk31"]
    text, iq = mode_band._message(cell.config, cell.traffic, 7, "psk31",
                                  np.random.default_rng(3))
    spb = int(round(fs / mode_band.PSK31_BAUD))
    n = tr["preamble"] + len(codes.varicode_bits(text)) + tr["postamble"]
    assert text == "cq de wh k" and len(iq) == (n + 1) * spb
    env = np.abs(iq)
    assert env[0] == 0 and env[-1] < 1e-3 and env[spb] == pytest.approx(1)
    # the preamble's reversals: the envelope through zero at each
    assert env[spb + spb // 2:tr["preamble"] * spb:spb].max() < 1e-6


class Rec:
    """A stand-in for the program's ``SpanRecord``."""

    def __init__(self, name, parent, t0_us, t1_us, device_ms=None):
        self.name, self.parent = name, parent
        self.t0_ns, self.t1_ns = int(t0_us * 1000), int(t1_us * 1000)
        self.device_ms = device_ms


def _records():
    """Two dispatches: a step of 300 us (8 ms on the card) with its
    stages, then its packing of 40 us (2 ms); the second alike, the step
    200 us (6 ms), the packing 60 us (2 ms)."""
    out = []
    for t0, step, pack, dev in ((0, 300, 40, 8.0), (1000, 200, 60, 6.0)):
        top = len(out)
        out += [Rec("multimode.step", None, t0, t0 + step, dev),
                Rec("multimode.channelize", top, t0, t0 + 20),
                Rec("multimode.chains", top, t0 + 20, t0 + 60),
                Rec("multimode.psk31", top, t0 + 60, t0 + 100, dev / 4),
                Rec("multimode.pll", top, t0 + 100, t0 + 150, dev / 2),
                Rec("multimode.compact", top, t0 + 150, t0 + 200,
                    dev / 8),
                Rec("multimode.pack", None, t0 + step, t0 + step + pack,
                    2.0)]
    return out


def _ctx():
    cell = manifest.cell("multimode.capture")
    win = harness.Window(seconds=1e-3, blocks=2, dispatches=2,
                         latencies_ms=[], entry_s=1e-3, launches=4)
    return harness.Context(cell.config, cell.traffic, win, 1.0, 1)


def _read(name, ctx):
    return manifest.cell("multimode.capture").module("metrics",
                                                     name).read(ctx)


@pytest.fixture
def program(monkeypatch):
    """Hands the readers ``recs`` as the program's records."""
    from libsdr_tpu_torch.utils import profiling

    def give(recs):
        monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return give


def test_bank_readers(program):
    program(_records())
    ctx = _ctx()
    # (300 + 40 + 200 + 60) us over 2 dispatches
    assert _read("bank_host_ms", ctx) == pytest.approx(0.3)
    # of 8 + 2 + 6 + 2 = 18 ms: the PLL 4 + 3, PSK31 2 + 1.5, the
    # compaction 1 + 0.75 and the packing 2 + 2
    assert _read("bank_pll_device_pct", ctx) == pytest.approx(700 / 18)
    assert _read("bank_psk31_device_pct", ctx) == pytest.approx(350 / 18)
    assert _read("bank_compact_device_pct", ctx) == pytest.approx(575 / 18)


def test_bank_readers_report_nothing_without_spans(program, monkeypatch):
    """The parent's program (no bank spans), a run with no profiler, or a
    run on the CPU (spans without the card's events) gives no reading and
    no error."""
    from libsdr_tpu_torch.utils import profiling
    ctx = _ctx()
    program([])
    assert all(_read(n, ctx) is None for n in NEW)
    program([Rec("scanner.step", None, 0, 150, 2.0)])
    assert all(_read(n, ctx) is None for n in NEW)
    program([Rec(r.name, r.parent, r.t0_ns / 1000, r.t1_ns / 1000)
             for r in _records()])
    assert all(_read(n, ctx) is None for n in NEW[1:])
    monkeypatch.delattr(profiling, "records")
    assert all(_read(n, ctx) is None for n in NEW)


@pytest.mark.parametrize("metric", NEW)
def test_each_bank_metric_in_exactly_its_cell(metric):
    man = manifest.load()
    entry = next(m for m in man["per_layer"] if m["name"] == metric)
    assert entry["source"] == "program_span"
    assert entry["moves"] == "throughput"
    assert entry["workloads"] == ["multimode.capture"]
    for w in man["workloads"]:
        names = [m["name"] for m in manifest.cell(w["name"]).per_layer]
        assert (metric in names) == (w["name"] == "multimode.capture")


def test_tiny_cell_is_correct_and_its_control_is_not():
    cell = tiny_cell("multimode.capture")
    r = harness.run_cell(cell, 2 ** 31 + 77, 0.05, False, "cpu",
                         time.perf_counter())
    assert r["correct"], r["compared"]
    c = harness.run_cell(cell, 2 ** 31 + 77, 0.05, False, "cpu",
                         time.perf_counter(), planes="bfloat16")
    assert not c["correct"], c["compared"]
