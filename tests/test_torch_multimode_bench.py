"""The multi-mode bank's benchmark comparison on the CPU, at a size a test
holds: the port's bank (``parallel/multimode.build_multimode_step``, one
device) over 16 channels of 24 kHz in two blocks of 14,400 frames, on
seeded traffic from ``benchmark/signals/mode_band.py`` with a short
message of every mode, judged by the benchmark's system against the plain
reference ``benchmark/reference/multimode.py``.  The sound bank passes
every limit; a group fed the wrong channel rows, a channel map off by one
and PSK31's decimation off by one sample each fail one.  The bank's spans
record under ``torch.profiler`` and not without it."""

from __future__ import annotations

import copy
import json
import time

import numpy as np
import pytest
import torch

from benchmark import manifest, signals
from benchmark.reference import multimode as reference
from benchmark.signals import mode_band

M, FRAMES, SEED = 16, 14_400, 2_147_483_659
SPANS = {"multimode.step", "multimode.channelize", "multimode.chains",
         "multimode.pll", "multimode.psk31", "multimode.compact",
         "multimode.pack"}


@pytest.fixture(autouse=True)
def one_thread():
    """The bank's small CPU ops run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell():
    cell = manifest.cell("multimode.capture")
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg.update(channels=M, sample_rate=M * cfg["sample_rate"]
               / cfg["channels"])
    tr["block_samples"] = M * FRAMES
    tr["pocsag"]["text"] = "B{ch}"
    tr["ax25"].update(lead_flags=32, info="!4903.50N/07201.75W-{ch}")
    tr["rtty"].update(sync="", text="RY")
    tr["psk31"].update(text="e", preamble=8, postamble=4)
    return cell, cfg, tr


def _judged(cfg, tr, seed=SEED):
    """The system's comparison after one period of warm-up and one more."""
    made = signals.make(cfg, tr, seed, "cpu", root=manifest.ROOT)
    cell = manifest.cell("multimode.capture")
    system = cell.module("systems", "multimode").System(cfg, tr, made,
                                                         seed, "cpu")
    system.warm()
    for i in range(len(made[0])):
        system.dispatch(i)
    return {k: v for k, (v, _) in system.judge().items()}, made[1]


def _ok(cfg, got) -> bool:
    return all(v <= cfg["limits"][k] for k, v in got.items())


def test_traffic_holds_a_message_of_every_mode():
    _, cfg, tr = _cell()
    assert mode_band.block_frames(cfg, tr) == FRAMES
    plan = mode_band.plan(cfg, tr, SEED)
    assert {m.mode for m in plan} == {"pocsag", "ax25", "rtty", "psk31"}
    frames = 2 * FRAMES
    assert all(0 <= m.start and m.start + m.length <= frames for m in plan)


def test_sound_bank_keeps_every_limit():
    t = time.perf_counter()
    _, cfg, tr = _cell()
    got, plan = _judged(cfg, tr)
    assert _ok(cfg, got), got
    # one AX.25 frame of the four is lost here, by the reference's clock as
    # well: the bits agree
    assert got["msgs_missed"] <= 0.25 and got["bits_diff"] < 200, got
    assert got["chan_err"] < 1e-6 and got["stage_err"] < 1e-4, got
    print(f"sound bank judged in {time.perf_counter() - t:.1f} s: "
          f"{json.dumps(got)}")


def _shift_rows(monkeypatch):
    """RTTY's chains fed the PSK31 rows (each one channel up)."""
    from libsdr_tpu_torch.ops import bitsync
    apply = bitsync.apply_mode_chains

    def broken(sub, carries, y, groups, windows):
        groups = dict(groups, rtty=groups["rtty"] + 1)
        return apply(sub, carries, y, groups, windows)
    monkeypatch.setattr(bitsync, "apply_mode_chains", broken)


def _shift_map(monkeypatch):
    """Every channel given its right neighbour's mode."""
    from libsdr_tpu_torch.apps import multimode
    parts = multimode.mode_parts

    def broken(ch_rate, t_full, mode_map):
        n = len(mode_map)
        return parts(ch_rate, t_full,
                     {ch: mode_map[(ch + 1) % n] for ch in mode_map})
    monkeypatch.setattr(multimode, "mode_parts", broken)


def _shift_decimation(monkeypatch):
    """PSK31's decimator one input sample early: the select's outputs end
    one sample before the block's D-th."""
    from libsdr_tpu_torch.ops import fir
    overlap_save = fir.fir_overlap_save

    def broken(taps, x, tail, stride=1, offset=0):
        if stride == 12:
            offset -= 1
        return overlap_save(taps, x, tail, stride=stride, offset=offset)
    monkeypatch.setattr(fir, "fir_overlap_save", broken)


@pytest.mark.parametrize("fault", [_shift_rows, _shift_map,
                                   _shift_decimation])
def test_broken_bank_is_not_correct(monkeypatch, fault):
    _, cfg, tr = _cell()
    fault(monkeypatch)
    got, _ = _judged(cfg, tr)
    print(fault.__name__, json.dumps(got))
    assert not _ok(cfg, got), got


def test_spans_record_only_under_the_profiler():
    from libsdr_tpu_torch.apps.multimode import pack_bank_outputs
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.parallel.multimode import build_multimode_step
    from libsdr_tpu_torch.utils import profiling

    b = M * 96
    step, init, place, _ = build_multimode_step(
        M, b, M * 24_000.0, ("pocsag", "ax25", "rtty", "psk31"),
        mesh=None, device="cpu")
    g = torch.Generator().manual_seed(3)
    x = Complex(torch.randn(b, generator=g), torch.randn(b, generator=g))
    carry = init()
    profiling.reset()
    carry, outs = step(carry, place(x))
    pack_bank_outputs(outs)
    assert not profiling.records()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        carry, outs = step(carry, place(x))
        pack_bank_outputs(outs)
    recs = profiling.records()
    profiling.reset()
    names = {r.name for r in recs}
    assert SPANS <= names, names
    top = {r.name for r in recs if r.parent is None}
    assert top == {"multimode.step", "multimode.pack"}
    # on the CPU no span holds a device event pair
    assert all(r.device_ms is None for r in recs)


def test_reference_clock_and_bpsk31_are_the_programs():
    """From one state and one input, the reference's bit clocks (the three
    modes' lanes in one pass) and BPSK31 decide as the program's plain
    versions do."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops.pll import pll_bank_plain
    from libsdr_tpu_torch.ops.psk31 import BPSK31, bpsk31_scan_plain

    rng = np.random.default_rng(5)
    fs, t = 24_000.0, 6_000
    bauds, trans = [1200.0, 1200.0, 90.9], [False, True, False]
    ells = [int(fs / b) for b in bauds]
    big = max(ells)
    spb = [int(fs / b) for b in bauds]
    sym = np.stack([np.repeat(rng.integers(0, 2, (big + t) // s + 1),
                              s)[:big + t] for s in spb], 1).astype(bool)
    sym ^= rng.random(sym.shape) < 0.02
    om0 = [b / fs for b in bauds]
    ph = rng.random(3).astype(np.float32)
    om = (np.asarray(om0) * (1 + 0.004 * rng.uniform(-1, 1, 3))).astype(
        np.float32)
    last = np.asarray([0, 1, 0], np.int32)
    bits, emit = reference.bit_clock(sym, ells, om0, trans, (ph, om, last))
    hist = np.where(sym[:big], 1, -1).astype(np.int32).T     # (3, big)
    # each lane's last ell - 1 signs in the last columns of big - 1
    signs = np.stack([np.pad(hist[j, big - ells[j] + 1:], (big - ells[j], 0))
                      for j in range(3)])
    sums = np.asarray([hist[j, big - ells[j]:].sum() for j in range(3)],
                      np.int32)
    out, *_ = pll_bank_plain(
        torch.from_numpy(sym[big:].T.astype(np.uint8).copy()),
        torch.from_numpy(signs), torch.from_numpy(sums),
        torch.from_numpy(ph), torch.from_numpy(om), torch.from_numpy(last),
        omega_min=(np.asarray(om0) * 0.995).astype(np.float32),
        omega_max=(np.asarray(om0) * 1.005).astype(np.float32),
        gain=np.full(3, 0.0005, np.float32),
        transition=np.asarray(trans, np.int32),
        ell=np.asarray(ells, np.int32))
    out = out.numpy()
    assert np.array_equal((out >> 1 & 1).T.astype(bool), emit)
    assert np.array_equal((out & 1).T[emit], bits[emit])

    bp = BPSK31()
    bp.bind(__import__("libsdr_tpu_torch").StreamSpec(
        np.complex64, 2_000.0, 512, channels=(4,)))
    c = bp.init_carry("cpu")
    x = (rng.standard_normal((4, 512)) + 1j * rng.standard_normal(
        (4, 512))).astype(np.complex64)
    xc = Complex(torch.from_numpy(x.real.copy()),
                 torch.from_numpy(x.imag.copy()))
    c, *_ = bpsk31_scan_plain(xc, c, **bp.constants())     # a used state
    state = {k: v.re.numpy() + 1j * v.im.numpy() if isinstance(v, Complex)
             else v.numpy() for k, v in c.items()}
    _, want_bits, want_emit = bpsk31_scan_plain(xc, c, **bp.constants())
    k = reference.bpsk31_constants(2_000.0, manifest.cell(
        "multimode.capture").config["chains"]["psk31"])
    got_bits, got_emit = reference.bpsk31(x, state, k)
    assert np.array_equal(got_emit, want_emit.numpy())
    assert np.array_equal(got_bits[got_emit], want_bits.numpy()[got_emit])
