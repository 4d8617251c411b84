"""Each plain reference agrees with the program's plain CPU path at tiny
sizes (the test imports both; the references import nothing of the
program)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import signals
from benchmark.reference import fm_bank, pager_scan

from conftest import tiny_cell


def test_iir_chunked_is_the_recurrence():
    x = torch.randn(3, 2048, dtype=torch.float64)
    a, b = 1 - 1 / 19, 1 / 19
    y = fm_bank.iir(x, a, b)
    ref = torch.zeros_like(x)
    prev = torch.zeros(3, dtype=torch.float64)
    for n in range(x.shape[1]):
        prev = a * prev + b * x[:, n]
        ref[:, n] = prev
    assert float((y - ref).abs().max()) < 1e-13


def test_fm_reference_matches_the_programs_plain_chain():
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand

    cell = tiny_cell("fm_bank.capture")
    cfg, ch = cell.config, cell.config["chain"]
    blocks, _ = signals.make(cfg, cell.traffic, 5, "cpu")
    p = L.Pipeline([IQBaseBand(fc=ch["fc"], width=ch["width"],
                               order=ch["order"], decim=ch["decim"],
                               design=ch["design"]),
                    FMDemod(gain=ch["gain"]), FMDeemph(tau=ch["tau"])])
    p.bind(L.StreamSpec(np.complex64, cfg["sample_rate"],
                        cell.traffic["block_samples"],
                        channels=(cfg["channels"],)))
    carry = p.init_carry("cpu")
    outs = []
    for i in (0, 1, 0, 1):
        carry, y = p.apply(carry, Complex(*blocks[i]))
        outs.append(y)
    worst, rms = fm_bank.compare(cfg, blocks, [1, 0, 1], outs[-2:])
    assert worst < 1e-5 and rms < 1e-6


def test_channelizer_matches_the_programs_plain_pfb():
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops.channelizer import (fold_commutator,
                                                  prototype_lowpass)
    from libsdr_tpu_torch.ops.pfb import pfb_frames_plain

    m, p, f = 16, 8, 64
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, (f + p) * m, generator=g)
    hist, blk = x[:, :p * m], x[:, p * m:]
    taps3 = fold_commutator(prototype_lowpass(m, p), m, p)
    got = pfb_frames_plain(Complex(blk[0].reshape(f, m), blk[1].reshape(f, m)),
                           Complex(hist[0].reshape(p, m),
                                   hist[1].reshape(p, m)), taps3)
    x, h = blk.double(), hist.double()
    ref = pager_scan.channelize(torch.complex(x[0], x[1]),
                                torch.complex(h[0], h[1]), m, p)
    got = torch.complex(got.re.double(), got.im.double())
    assert pager_scan.rel_gap(got, ref) < 1e-5


@pytest.mark.parametrize("fs_ch", [24_000.0, 25_000.0])
def test_bit_clock_matches_the_programs_pll(fs_ch):
    from libsdr_tpu_torch.ops.pll import pll_plain

    rng = np.random.default_rng(4)
    t, c, spb = 20 * 400, 3, 20
    ell = int(fs_ch / 1200.0)
    bits = rng.integers(0, 2, (400, c))
    sym = np.repeat(bits, spb, axis=0).astype(bool)
    sym ^= rng.random(sym.shape) < 0.02              # a few flipped symbols
    packed, ours, _ = pager_scan.bit_clock(sym, 1200.0, fs_ch, w=16)
    om0 = np.float32(1200.0 / fs_ch)
    out, *_ = pll_plain(
        torch.from_numpy(sym.T.astype(np.uint8).copy()),
        torch.zeros(c, ell - 1, dtype=torch.int32),
        torch.zeros(c, dtype=torch.int32), torch.zeros(c),
        torch.full((c,), float(om0)), torch.zeros(c, dtype=torch.int32),
        omega_min=om0 * 0.995, omega_max=om0 * 1.005, gain=0.0005,
        transition=False)
    out = out.numpy()
    for j in range(c):
        theirs = (out[j] & 1)[(out[j] & 2) != 0]
        assert len(theirs) == len(ours[j]) and np.array_equal(theirs,
                                                               ours[j])
    # the program's windows of 16 steps: the bit where one was sampled
    win = out.reshape(c, t // 16, 16)
    valid = (win & 2).any(-1)
    data = ((win & 1) * ((win & 2) != 0)).sum(-1)
    assert np.array_equal(packed, data.astype(np.int64)
                          | valid.astype(np.int64) << 1)


@pytest.mark.parametrize("own", [False, True])
def test_pager_reference_decodes_every_page(own):
    cell = tiny_cell("pager.capture")
    cfg = cell.config
    blocks, plan = signals.make(cfg, cell.traffic, 9, "cpu")
    _, sym = pager_scan.symbols(cfg, blocks)
    clock = pager_scan.own_clock(cfg, sym) if own else None
    _, bits = pager_scan.scan(cfg, sym, len(blocks), clock)
    pages = pager_scan.pages({ch: bits[ch] for ch, _, _ in plan})
    assert pages == pager_scan.planned_pages(plan)
    assert {(ch, a) for ch, a, _, _ in pages} == {
        (ch, cell.traffic["address0"] + ch) for ch, _, _ in plan}


def test_scanner_clock_starts_as_stated_and_keeps_to_the_reference():
    """The pager's comparison starts the reference's clock from the
    program's phase and rate; the start that skips is checked here: the
    program's first clock state is the configuration's, one period from
    it decodes the pages that the reference's fresh clock decodes, and
    the symbol history it then carries is the one the reference works out
    from the capture.  (Noise channels' windows part where the program's
    first frames, with no history, and the reference's, with the
    capture's, differ.)"""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.decode import pocsag_decode_bits
    from libsdr_tpu_torch.ops.pfb import lane_of_channel
    from libsdr_tpu_torch.parallel.wideband import build_scanner_step

    cell = tiny_cell("pager.capture")
    cfg, tr = cell.config, cell.traffic
    m, b, fs = cfg["channels"], tr["block_samples"], cfg["sample_rate"]
    blocks, plan = signals.make(cfg, tr, 13, "cpu")
    w = pager_scan.window(cfg["baud"], fs / m, b // m)
    step, init, place = build_scanner_step(m, b, fs, baud=cfg["baud"],
                                           compact_window=w, packed=True,
                                           device="cpu")
    carry = init()
    clock = carry[1]
    assert not clock["signs"].any() and not clock["sym_sum"].any()
    assert not clock["phase"].any()
    assert (clock["omega"] == np.float32(cfg["baud"] * m / fs)).all()
    outs = []
    for blk in blocks:
        carry, y = step(carry, place(Complex(*blk)))
        outs.append(y)
    packed = torch.cat(outs, -1).numpy()
    _, sym = pager_scan.symbols(cfg, blocks)
    ref_packed, _ = pager_scan.scan(cfg, sym, len(blocks))
    signs, sums = pager_scan.history(sym, int(fs / m / cfg["baud"]))
    lanes = torch.as_tensor(lane_of_channel(m))
    assert np.array_equal(carry[1]["signs"][lanes].numpy(), signs)
    assert np.array_equal(carry[1]["sym_sum"][lanes].numpy(), sums)
    assert packed.shape == ref_packed.shape
    data, valid = packed & 1, packed >= 2
    got = {(ch, p.address) for ch, _, _ in plan
           for p in pocsag_decode_bits(data[ch][valid[ch]])}
    assert got == {(ch, a) for ch, a, _, _ in pager_scan.planned_pages(plan)}


def test_clock_witness_runs_and_agrees_at_a_tiny_size():
    from benchmark import clock_witness

    r = clock_witness.witness(tiny_cell("pager.capture"), 17, 0.05, "cpu",
                              states=3)
    assert r["planned"] == 2 and r["starts"] >= 1, r
    assert r["program_pages"] == r["own_clock_pages"] == 2, r
    assert r["program_is_ref_from_its_start"], r
    assert r["card_and_cpu_pll_are_ref"], r
