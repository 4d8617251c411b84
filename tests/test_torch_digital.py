"""The port's digital receive path (``libsdr_tpu_torch``: core/ragged,
ops/fsk, ops/pll, ops/bitsync, mode afsk of ops/fir_fm, ops/afsk_fused, the
AFSK fusion rule, decode/*) against the JAX package on the CPU.

The inputs are made with numpy from a seed and go through both packages.
Where the JAX function reaches a Pallas kernel it runs in interpret mode.
Bounds:

* the bit-clock PLL (``pll*``, ``BitStream``, ``bitstream_bank_apply``,
  ``apply_mode_chains``) is bit-exact: bits, valid flags and every carry
  leaf, also with the omega bounds widened to 0.5-2x omega0, where a nudge
  rounded twice instead of once (as an FMA rounds it) ends with another
  omega in 37 of 64 lanes after 20,000 steps;
* ``fir_afsk_exact`` within 2e-3 of the largest |disc| and its tails within
  1e-3: the JAX kernel's own bounds against its oracle (its FIR runs as
  bf16 3-pass matmuls);
* symbols of the fused AFSK op agree with the JAX chains in >= 99.5% of
  places (they differ only at near-zero discriminator ties), and the AX.25
  fixture decodes to the identical payload;
* the FSK correlator's sums within 1e-3 of a float64 oracle, the JAX
  test's bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libsdr_tpu as J
import libsdr_tpu_torch as P
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu.core import ragged as jragged
from libsdr_tpu.ops import bitsync as jbitsync
from libsdr_tpu.ops import fsk as jfsk
from libsdr_tpu.ops import pallas_bitsync as jpb
from libsdr_tpu.ops import pallas_fir_mxu as pfm
from libsdr_tpu.ops.fir import kernel_mode
from libsdr_tpu_torch import interop
from libsdr_tpu_torch.core import cplx, ragged
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import RuntimeSDRError
from libsdr_tpu_torch.ops import bitsync, fsk
from libsdr_tpu_torch.ops.afsk_fused import AFSKFrontendFused
from libsdr_tpu_torch.ops.fir_fm import fir_afsk_exact
from libsdr_tpu_torch.ops.pll import pll, pll_bank, pll_bank_plain


def _signature(tree):
    """Nesting, shapes and dtypes of a carry of either package."""
    if hasattr(tree, "re") and hasattr(tree, "im"):
        return ("complex", _signature(tree.re))
    if isinstance(tree, dict):
        return {k: _signature(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_signature(t) for t in tree)
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _runs(rng, m, t, run):
    """(m, t) uint8 symbols in runs of about ``run`` steps, with flips."""
    sym = np.repeat(rng.integers(0, 2, (m, t // run + 2)), run, axis=1)
    flips = rng.random((m, sym.shape[1])) < 0.02
    return (sym ^ flips)[:, :t].astype(np.uint8)


# -- ragged helpers ----------------------------------------------------------

def test_ragged_helpers_match_jax(rng):
    data = rng.integers(0, 2, (3, 256)).astype(np.uint8)
    valid = np.zeros((3, 256), bool)
    valid[:, 5::20] = True                       # one item per 20 slots
    pr, jr = ragged.Ragged(torch.from_numpy(data), torch.from_numpy(valid)), \
        jragged.Ragged(jnp.asarray(data), jnp.asarray(valid))
    for a, b in zip(ragged.compact(pr), jragged.compact(jr)):
        np.testing.assert_array_equal(a, b)
    for cap in (8, 20):                          # overflow and room
        pd, pc = ragged.compact_device(pr, cap)
        jd, jc = jragged.compact_device(jr, cap)
        np.testing.assert_array_equal(_np(pd), np.asarray(jd))
        np.testing.assert_array_equal(_np(pc), np.asarray(jc))
    for w in (4, 16):
        pw, jw = ragged.compact_windows(pr, w), jragged.compact_windows(jr, w)
        np.testing.assert_array_equal(_np(pw.data), np.asarray(jw.data))
        np.testing.assert_array_equal(_np(pw.valid), np.asarray(jw.valid))
    for om in (0.05, 0.05025, 1 / 264 * 1.005):
        assert ragged.min_valid_gap(om) == jragged.min_valid_gap(om)
        for t in (4096, 12000, 262144):
            g = ragged.min_valid_gap(om)
            assert ragged.pick_window(g, t, 256) == jragged.pick_window(
                g, t, 256)
    one = ragged.compact(ragged.Ragged(torch.from_numpy(data[0]),
                                       torch.from_numpy(valid[0])))
    np.testing.assert_array_equal(one, data[0][valid[0]])


# -- FSK / ASK detection -----------------------------------------------------

@pytest.mark.parametrize("L", [2, 3, 127, 128, 129, 264, 640])
def test_sliding_sum_matches_oracle_and_jax(rng, L):
    """Both block paths (the banded matmul at 128-aligned blocks, the direct
    sums otherwise) against a float64 oracle and JAX's sliding_sum,
    including the tail hand-off between two blocks."""
    for b in (512, 320):
        u = rng.normal(size=(2, 2 * b)).astype(np.float32)
        pt = cplx.zeros((2, L - 1))
        jt = jcplx.Complex(jnp.zeros((2, L - 1)), jnp.zeros((2, L - 1)))
        outs, jouts = [], []
        for i in range(2):
            blk = u[:, i * b:(i + 1) * b]
            s, pt = fsk.sliding_sum(pt, Complex(torch.from_numpy(blk),
                                                torch.from_numpy(-blk)), L)
            js, jt = jfsk.sliding_sum(jt, jcplx.Complex(jnp.asarray(blk),
                                                        jnp.asarray(-blk)), L)
            assert torch.equal(s.im, -s.re)
            outs.append(s.re.numpy())
            jouts.append(np.asarray(js.re))
        got = np.concatenate(outs, -1)
        full = np.concatenate([np.zeros((2, L - 1)), u.astype(np.float64)],
                              -1)
        cs = np.cumsum(full, -1)
        want = cs[:, L - 1:] - np.concatenate([np.zeros((2, 1)),
                                               cs[:, :-L]], -1)
        np.testing.assert_allclose(got, want, atol=1e-3)
        np.testing.assert_allclose(got, np.concatenate(jouts, -1), atol=1e-3)


@pytest.mark.parametrize("fs,baud,fm_,fsp", [
    (24000, 90.90, 930.0, 1100.0), (24000, 1200.0, 1200.0, 2200.0)])
def test_fsk_detector_matches_jax(rng, fs, baud, fm_, fsp):
    """FSKDetector on 3 channels against JAX's, at a matmul-path block and
    an unaligned one; symbols agree except at near-zero ties; the carries
    have JAX's layout."""
    x = rng.normal(size=(3, 4096)).astype(np.float32)

    def run(pkg, blk, dev_kw):
        det = pkg.ops.FSKDetector(baud, fm_, fsp)
        det.bind(pkg.StreamSpec(np.float32, fs, blk, channels=(3,)))
        c = det.init_carry(**dev_kw)
        outs = []
        for i in range(4096 // blk):
            xb = x[:, i * blk:(i + 1) * blk]
            c, y = det.apply(c, torch.from_numpy(xb) if pkg is P
                             else jnp.asarray(xb))
            outs.append(_np(y))
        return c, np.concatenate(outs, -1)

    for blk in (1024, 320):
        pc, p = run(P, blk, {"device": "cpu"})
        jc, j = run(J, blk, {})
        assert p.dtype == np.uint8
        assert (p == j).mean() > 0.995, (blk, (p == j).mean())
        assert _signature(pc) == _signature(jc)
        assert int(pc[0]) == int(jc[0])


def test_ask_detector_matches_jax(rng):
    x = rng.normal(size=(2, 1000)).astype(np.float32)
    for inv in (False, True):
        pd, jd = P.ops.ASKDetector(inv), J.ops.ASKDetector(inv)
        pd.bind(P.StreamSpec(np.float32, 24000, 1000, channels=(2,)))
        jd.bind(J.StreamSpec(np.float32, 24000, 1000, channels=(2,)))
        _, py = pd.apply((), torch.from_numpy(x))
        _, jy = jd.apply((), jnp.asarray(x))
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))


# -- the bit-clock PLL -------------------------------------------------------

def _bitstreams(L, mode, m, t, wide=False, time_major=False):
    """A JAX and a port BitStream bound alike (window L), optionally with
    the omega bounds widened to 0.5-2x omega0."""
    out = []
    for pkg in (J, P):
        bs = pkg.ops.BitStream(1200.0, mode=mode, time_major=time_major)
        bs.bind(pkg.StreamSpec(np.uint8, 1200.0 * L, t, channels=(m,)))
        assert bs.corr_len == L
        if wide:
            bs._omega_min, bs._omega_max = bs._omega0 * 0.5, bs._omega0 * 2
        out.append(bs)
    return out


@pytest.mark.parametrize("mode", ["normal", "transition"])
@pytest.mark.parametrize("L,wide", [(20, False), (40, False), (264, False),
                                    (40, True)])
def test_bitstream_bit_exact_vs_jax_scan(rng, mode, L, wide):
    """BitStream (its plain PLL on the CPU) against the JAX scan over two
    chained blocks: bits, valid flags and every carry leaf equal."""
    m, t = 64, 2048
    jbs, pbs = _bitstreams(L, mode, m, t, wide)
    jc, pc = jbs.init_carry(), pbs.init_carry("cpu")
    assert _signature(pc) == _signature(jc)
    sym = _runs(rng, m, 2 * t, max(1, L // 2))
    for b in range(2):
        blk = sym[:, b * t:(b + 1) * t]
        jc, jr = jbs.apply(jc, jnp.asarray(blk))
        pc, pr = pbs.apply(pc, torch.from_numpy(blk))
        np.testing.assert_array_equal(pr.data.numpy(), np.asarray(jr.data))
        np.testing.assert_array_equal(pr.valid.numpy(), np.asarray(jr.valid))
        for k in jc:
            np.testing.assert_array_equal(pc[k].numpy(), np.asarray(jc[k]),
                                          err_msg=k)


def test_pll_needs_one_rounding_in_the_nudge(rng):
    """The reason for the single rounding: over 20,000 steps with the bounds
    widened to 0.5-2x omega0, the port's PLL (its nudge a float64 product
    and sum rounded once) ends with JAX's omega in every lane, and the same
    recurrence with the nudge as a float32 multiply, then add, does not in
    many lanes."""
    m, t, L = 64, 20_000, 40
    jbs, pbs = _bitstreams(L, "transition", m, t, wide=True)
    blk = _runs(rng, m, t, L // 2)
    jc, _ = jbs.apply(jbs.init_carry(), jnp.asarray(blk))
    pc, _ = pbs.apply(pbs.init_carry("cpu"), torch.from_numpy(blk))
    want = np.asarray(jc["omega"])
    np.testing.assert_array_equal(pc["omega"].numpy(), want)
    from libsdr_tpu_torch.ops.pll import _majority_plain
    _, cr, _, _ = _majority_plain(
        torch.from_numpy(blk), torch.zeros(m, L - 1, dtype=torch.int32),
        torch.zeros(m, dtype=torch.int32),
        torch.full((m,), L, dtype=torch.int32))
    cr = cr.numpy()
    om = np.full(m, np.float32(pbs._omega0))
    ph = np.zeros(m, np.float32)
    lo, hi = np.float32(pbs._omega_min), np.float32(pbs._omega_max)
    g, one, half = np.float32(pbs._pll_gain), np.float32(1), np.float32(0.5)
    for k in range(t):
        ph = ph + om
        ph = np.where(ph >= one, ph - one, ph)
        om = np.minimum(np.maximum(np.where(cr[:, k], om + g * (half - ph),
                                            om), lo), hi)
    assert (om != want).sum() >= 10, (om != want).sum()


def test_pll_matches_pallas_kernel(rng):
    """pll_plain against the JAX kernel pll_pallas (interpret mode), two
    chained blocks, both bit mappings; the port is lane-major, the JAX
    kernel time-major."""
    t, m, L = 256, 128, 20
    om0 = 1.0 / L
    kw = dict(omega_min=om0 * 0.995, omega_max=om0 * 1.005, gain=5e-4)
    for mode in (False, True):
        jst = [jnp.zeros((L - 1, m), np.int32), jnp.zeros((m,), np.int32),
               jnp.zeros((m,), np.float32), jnp.full((m,), om0, np.float32),
               jnp.zeros((m,), np.int32)]
        pst = [torch.zeros(m, L - 1, dtype=torch.int32),
               torch.zeros(m, dtype=torch.int32), torch.zeros(m),
               torch.full((m,), om0), torch.zeros(m, dtype=torch.int32)]
        for _ in range(2):
            sym = _runs(rng, m, t, 8)
            jout, *jst = jpb.pll_pallas(jnp.asarray(sym.T), *jst,
                                        transition=mode, interpret=True,
                                        **kw)
            pout, *pst = pll(torch.from_numpy(sym), *pst, transition=mode,
                             **kw)
            np.testing.assert_array_equal(pout.numpy().T,
                                          np.asarray(jout).astype(np.uint8))
            np.testing.assert_array_equal(pst[0].numpy().T,
                                          np.asarray(jst[0]))
            for a, b in zip(pst[1:], jst[1:]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pll_bank_matches_pallas_bank_kernel(rng):
    """pll_bank_plain against pll_pallas_bank (interpret mode) on a bank of
    L = 20 normal, 20 transition and 264 normal lanes, two chained blocks
    (each lane's signs in the last L-1 of the shared rows, zero-padded)."""
    t = 256
    cfg = [(20, 0, 48), (20, 1, 40), (264, 0, 40)]
    ells = np.concatenate([np.full(n, e, np.int32) for e, _, n in cfg])
    trans = np.concatenate([np.full(n, tr, np.int32) for _, tr, n in cfg])
    m, r = len(ells), 263
    om0 = (1.0 / ells).astype(np.float32)
    lo, hi = om0 * np.float32(0.995), om0 * np.float32(1.005)
    gain = np.full(m, 5e-4, np.float32)
    uniq = (20, 264)
    onehot = np.stack([(ells == e).astype(np.int32) for e in uniq])
    jst = [jnp.zeros((r, m), np.int32), jnp.zeros((m,), np.int32),
           jnp.zeros((m,), np.float32), jnp.asarray(om0),
           jnp.zeros((m,), np.int32)]
    pst = [torch.zeros(m, r, dtype=torch.int32),
           torch.zeros(m, dtype=torch.int32), torch.zeros(m),
           torch.from_numpy(om0), torch.zeros(m, dtype=torch.int32)]
    for _ in range(2):
        sym = _runs(rng, m, t, 10)
        jout, *jst = jpb.pll_pallas_bank(
            jnp.asarray(sym.T), *jst, jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(gain), jnp.asarray(trans), jnp.asarray(onehot),
            ells=uniq, interpret=True)
        pout, *pst = pll_bank(torch.from_numpy(sym), *pst, omega_min=lo,
                              omega_max=hi, gain=gain, transition=trans,
                              ell=ells)
        np.testing.assert_array_equal(pout.numpy().T,
                                      np.asarray(jout).astype(np.uint8))
        # each lane's own window of the signs (the JAX bank re-pads zeros)
        jsg = np.asarray(jst[0]).T
        for i, e in enumerate(ells):
            np.testing.assert_array_equal(pst[0][i, r - (e - 1):].numpy(),
                                          jsg[i, r - (e - 1):])
        for a, b in zip(pst[1:], jst[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jst[0] = jnp.asarray(np.where(
            np.arange(r)[None, :] >= r - (ells[:, None] - 1), jsg, 0).T)
    with pytest.raises(ValueError, match="windows"):
        pll_bank_plain(torch.from_numpy(sym), *pst, omega_min=lo,
                       omega_max=hi, gain=gain, transition=trans,
                       ell=ells + 1)


def _mode_sub(pkg, t, per):
    """The mode bank's three BitStream chains (apps/multimode.py) bound at
    24 kHz complex, ``per`` channels each."""
    o = pkg.ops
    stages = {
        "pocsag": [o.FMDemod(), o.ASKDetector(invert=True),
                   o.BitStream(1200.0, mode="normal")],
        "ax25": [o.FMDemod(), o.FSKDetector(1200.0, 1200.0, 2200.0),
                 o.BitStream(1200.0, mode="transition")],
        "rtty": [o.USBDemod(), o.FSKDetector(2 * 45.45, 930.0, 1100.0),
                 o.BitStream(2 * 45.45, mode="normal")]}
    sub = {}
    for mode, st in stages.items():
        p = pkg.Pipeline(st)
        p.bind(pkg.StreamSpec(np.complex64, 24_000.0, t, channels=(per,)))
        sub[mode] = p
    return sub


def test_bank_apply_and_mode_chains_match_jax(rng):
    """apply_mode_chains over three groups and two blocks: the port runs the
    three BitStreams as one pll_bank call, the JAX package (on its CPU)
    each on its own; outputs, compacted with the PLL's windows, and
    carries equal.  bitstream_bank_apply alone equals per-stream apply."""
    t, per = 1024, 8
    ps, js = _mode_sub(P, t, per), _mode_sub(J, t, per)
    groups = {m: list(range(i, 3 * per, 3)) for i, m in enumerate(ps)}
    windows = {m: jragged.pick_window(jragged.min_valid_gap(
        js[m].stages[-1]), t, cap=256) for m in js}
    pc = {m: p.init_carry("cpu") for m, p in ps.items()}
    jc = {m: p.init_carry() for m, p in js.items()}
    n0 = pll_bank.launches
    for _ in range(2):
        y = (rng.normal(size=(3 * per, t))
             + 1j * rng.normal(size=(3 * per, t))).astype(np.complex64)
        po, pc = bitsync.apply_mode_chains(ps, pc, cplx.as_block(y), groups,
                                           windows)
        jo, jc = jbitsync.apply_mode_chains(js, jc, jcplx.as_block(y),
                                            groups, windows)
        for m in ps:
            np.testing.assert_array_equal(po[m].data.numpy(),
                                          np.asarray(jo[m].data))
            np.testing.assert_array_equal(po[m].valid.numpy(),
                                          np.asarray(jo[m].valid))
            for k in jc[m][-1]:
                np.testing.assert_array_equal(pc[m][-1][k].numpy(),
                                              np.asarray(jc[m][-1][k]))
    assert pll_bank.launches == n0        # CPU blocks take the plain version
    # bitstream_bank_apply alone against each BitStream's own apply
    bss = [p.stages[-1] for p in ps.values()]
    syms = [_runs(rng, per, t, 10) for _ in bss]
    entries = [(bs, bs.init_carry("cpu"), torch.from_numpy(s))
               for bs, s in zip(bss, syms)]
    assert bitsync.bitstream_bank_supported(entries)
    for (nc, r), (bs, c, x) in zip(bitsync.bitstream_bank_apply(entries),
                                   entries):
        rc, rr = bs.apply(c, x)
        assert torch.equal(r.data, rr.data) and torch.equal(r.valid,
                                                            rr.valid)
        for k in rc:
            assert torch.equal(nc[k], rc[k]), k


def test_mode_bank_traffic_decodes_like_jax():
    """tools/digital_signals.mode_bank (the multi-mode bank's traffic: a
    POCSAG, an AX.25 and an RTTY channel) through mode_chains: the port's
    bits and carries equal the JAX package's on the same block, and every
    channel decodes its mode's message."""
    from libsdr_tpu_torch.core.ragged import compact
    from libsdr_tpu_torch.tools import digital_signals as S

    t = 1 << 18
    gen = torch.Generator()
    gen.manual_seed(5)
    y, groups = S.mode_bank(1, t, gen)
    ps, windows = S.mode_chains(1, t)
    js = _mode_sub(J, t, 1)
    po, pc = bitsync.apply_mode_chains(
        ps, {m: p.init_carry("cpu") for m, p in ps.items()}, y, groups,
        windows)
    yn = cplx.to_numpy(y)
    jo, jc = jbitsync.apply_mode_chains(
        js, {m: p.init_carry() for m, p in js.items()}, jcplx.as_block(yn),
        {m: np.asarray(g) for m, g in groups.items()}, windows)
    for m in S.MODES:
        np.testing.assert_array_equal(po[m].data.numpy(),
                                      np.asarray(jo[m].data))
        np.testing.assert_array_equal(po[m].valid.numpy(),
                                      np.asarray(jo[m].valid))
        for k in jc[m][-1]:
            np.testing.assert_array_equal(pc[m][-1][k].numpy(),
                                          np.asarray(jc[m][-1][k]))
        bits = compact(ragged.Ragged(po[m].data[0].numpy(),
                                     po[m].valid[0].numpy()))
        if m == "pocsag":
            from libsdr_tpu_torch.decode import pocsag_decode_bits
            assert any(x.address == S.POCSAG_ADDRESS
                       for x in pocsag_decode_bits(bits))
        elif m == "ax25":
            from libsdr_tpu_torch.decode import AX25Decoder
            d = AX25Decoder()
            d.process(bits)
            assert any(x.payload.endswith(S.AX25_INFO) for x in d.messages)
        else:
            from libsdr_tpu_torch.decode import BaudotDecoder
            assert S.RTTY_TEXT in BaudotDecoder().process(bits)


@pytest.mark.parametrize("bank", ["ax25", "pocsag"])
def test_bank_traffic_decodes(bank):
    """The AX.25 and POCSAG banks' traffic (tools/digital_signals) decodes
    through the port's chains on the CPU: every frame on every channel,
    every page."""
    from libsdr_tpu_torch.apps.chains import pocsag_front_end
    from libsdr_tpu_torch.core.ragged import compact, concat_host
    from libsdr_tpu_torch.decode import AX25Decoder, pocsag_decode_bits
    from libsdr_tpu_torch.tools import digital_signals as S

    gen = torch.Generator()
    gen.manual_seed(2)
    if bank == "pocsag":
        blk = 117_760
        blocks = S.pocsag_blocks(2, blk, 3, gen)
        p = pocsag_front_end(240e3, blk, channels=(2,))
    else:
        b = 1 << 19
        blocks = [S.ax25_bank(2, b, gen, frames=2)]
        p = P.Pipeline([P.ops.IQBaseBand(fc=24e3, width=12.5e3, order=48,
                                         out_rate=48e3, design="textbook"),
                        P.ops.FMDemod(),
                        P.ops.FSKDetector(1200.0, 1200.0, 2200.0),
                        P.ops.BitStream(1200.0, mode="transition")])
        p.bind(P.StreamSpec(np.complex64, 192e3, b, channels=(2,)))
        assert type(p.stages[0]) is AFSKFrontendFused
    carry, outs = p.init_carry("cpu"), []
    for x in blocks:
        carry, y = p.apply(carry, x)
        outs.append(y)
    for bits in compact(concat_host(outs)):
        if bank == "pocsag":
            assert [m.address for m in pocsag_decode_bits(bits)] == [
                S.POCSAG_ADDRESS]
        else:
            d = AX25Decoder()
            d.process(bits)
            assert len(d.messages) == 2 and all(
                m.payload.endswith(S.AX25_INFO + str(k).encode())
                for k, m in enumerate(d.messages))


def test_bitstream_time_major_equals_channel_major(rng):
    _, a = _bitstreams(20, "transition", 16, 512)
    _, b = _bitstreams(20, "transition", 16, 512, time_major=True)
    sym = torch.from_numpy(_runs(rng, 16, 512, 10))
    ca, ra = a.apply(a.init_carry("cpu"), sym)
    cb, rb = b.apply(b.init_carry("cpu"), sym.t().contiguous())
    assert torch.equal(ra.data, rb.data.t()) and torch.equal(ra.valid,
                                                             rb.valid.t())
    for k in ca:
        assert torch.equal(ca[k], cb[k])


def test_bitstream_carry_round_trips_through_jax(rng):
    """A BitStream carry handed JAX -> port -> JAX through interop (dict
    carries) continues bit-exactly in either package."""
    jbs, pbs = _bitstreams(40, "normal", 8, 512)
    sym = _runs(rng, 8, 1024, 20)
    jc, _ = jbs.apply(jbs.init_carry(), jnp.asarray(sym[:, :512]))
    pc = interop.state_from_numpy(jc, "cpu")
    assert _signature(pc) == _signature(jc)
    back = {k: jnp.asarray(v) for k, v in
            interop.state_to_numpy(pc).items()}
    jc2, jr = jbs.apply(back, jnp.asarray(sym[:, 512:]))
    pc2, pr = pbs.apply(pc, torch.from_numpy(sym[:, 512:]))
    np.testing.assert_array_equal(pr.data.numpy(), np.asarray(jr.data))
    for k in jc2:
        np.testing.assert_array_equal(pc2[k].numpy(), np.asarray(jc2[k]))


# -- K1e: the fused AFSK front end ------------------------------------------

def test_fir_afsk_exact_plain_matches_pallas_kernel(rng):
    """fir_afsk_exact (its plain version on the CPU) against the JAX kernel
    (interpret mode) at tests/test_pallas.py's case: C = 8, D = 4, T = 49,
    L = 40, B = 16384, template phase n0 = 16 and nonzero carried
    products."""
    C, D, T, L, B, n0 = 8, 4, 49, 40, 16384, 16
    fs_audio, s = 48000.0, pfm._S
    x = (rng.normal(size=(C, B)) + 1j * rng.normal(size=(C, B))).astype(
        np.complex64)
    g = rng.normal(size=T) + 1j * rng.normal(size=T)
    rot, gain, n_audio = np.exp(-0.37j), 0.8, B // D
    tm, ts = fsk.tone_tables(1200.0, 2200.0, fs_audio, L)
    reps = -(-(n_audio + L) // L)
    tpl = np.zeros((8, reps * L), np.float32)
    tpl[0], tpl[1] = np.tile(tm.real, reps), np.tile(tm.imag, reps)
    tpl[2], tpl[3] = np.tile(ts.real, reps), np.tile(ts.imag, reps)
    um = rng.normal(size=(C, 2, L - 1)).astype(np.float32)
    us = rng.normal(size=(C, 2, L - 1)).astype(np.float32)
    up = np.zeros((C, 4 * s), np.float32)
    lo = s - (L - 1)
    up[:, lo:s], up[:, s + lo:2 * s] = um[:, 0], um[:, 1]
    up[:, 2 * s + lo:3 * s], up[:, 3 * s + lo:] = us[:, 0], us[:, 1]
    lead = (rng.normal(size=(C, 1)) + 1j * rng.normal(size=(C, 1))).astype(
        np.complex64)
    tail = (rng.normal(size=(C, T - 1)) + 1j * rng.normal(size=(C, T - 1))
            ).astype(np.complex64)
    jd, jy, jul = pfm.fir_afsk_exact(
        jcplx.as_block(x), g, D, jcplx.as_block(tail), jcplx.as_block(lead),
        rot, gain, L, jnp.asarray(tpl[:, n0:n0 + n_audio]), jnp.asarray(up),
        interpret=True)
    n_before = fir_afsk_exact.launches
    pd, py, pum, pus = fir_afsk_exact(
        cplx.as_block(x), cplx.constant(g), D, cplx.as_block(tail),
        cplx.as_block(lead[:, 0]), rot, gain, cplx.constant(tm),
        cplx.constant(ts), torch.tensor(n0, dtype=torch.int32),
        Complex(torch.from_numpy(um[:, 0]), torch.from_numpy(um[:, 1])),
        Complex(torch.from_numpy(us[:, 0]), torch.from_numpy(us[:, 1])))
    assert fir_afsk_exact.launches == n_before   # the CPU's plain version
    jd = np.asarray(jd)
    scale = np.maximum(1.0, np.abs(jd).max(axis=1, keepdims=True))
    assert (np.abs(pd.numpy() - jd) / scale).max() < 2e-3
    jul = np.asarray(jul)
    for k, v in enumerate((pum.re, pum.im, pus.re, pus.im)):
        np.testing.assert_allclose(v.numpy(),
                                   jul[:, (k + 1) * s - (L - 1):(k + 1) * s],
                                   atol=1e-3)
    np.testing.assert_allclose(py.re.numpy(), np.asarray(jy.re)[:, 0],
                               atol=1e-3)


def _afsk_pipe(pkg, fs, blk, nch, bitstream=False):
    o = pkg.ops
    stages = [o.IQBaseBand(fc=24e3, width=12.5e3, order=48, out_rate=48e3,
                           design="textbook"),
              o.FMDemod(), o.FSKDetector(1200.0, 1200.0, 2200.0)]
    if bitstream:
        stages.append(o.BitStream(1200.0, mode="transition"))
    p = pkg.Pipeline(stages)
    p.bind(pkg.StreamSpec(np.complex64, fs, blk, channels=(nch,)))
    return p


def _run(p, x, blk, jax_pkg):
    c = p.init_carry() if jax_pkg else p.init_carry("cpu")
    step = p.compile()
    outs = []
    for i in range(x.shape[-1] // blk):
        xb = x[:, i * blk:(i + 1) * blk]
        c, y = step(c, jcplx.as_block(xb) if jax_pkg else cplx.as_block(xb))
        outs.append(y)
    return c, outs


def test_afsk_fused_invariant_and_like_jax(rng):
    """AFSKFrontendFused: bit-identical across block sizes; symbols agree
    with JAX's fused op (interpret mode) and unfused chain in >= 99.5% of
    places; the fusion picks it and its carry has JAX's layout."""
    fs, nch, total = 192_000.0, 64, 16384
    x = (rng.normal(size=(nch, total)) + 1j * rng.normal(size=(nch, total))
         ).astype(np.complex64)
    port = {}
    for blk in (total, total // 2):
        p = _afsk_pipe(P, fs, blk, nch)
        assert type(p.stages[0]) is AFSKFrontendFused
        c, outs = _run(p, x, blk, False)
        port[blk] = np.concatenate([o.numpy() for o in outs], -1)
    np.testing.assert_array_equal(port[total], port[total // 2])
    with kernel_mode("interpret"):
        jp = _afsk_pipe(J, fs, total, nch)
        assert type(jp.stages[0]).__name__ == "AFSKFrontendFused"
        jc, jouts = _run(jp, x, total, True)
    assert _signature(c) == _signature(jc)
    fused = np.asarray(jouts[0])
    assert (port[total] == fused).mean() > 0.995
    _, uouts = _run(_afsk_pipe(J, fs, total, nch), x, total, True)
    assert (port[total] == np.asarray(uouts[0])).mean() > 0.995


def test_afsk_carry_hand_off_with_jax(rng):
    """JAX -> port -> JAX: the AFSK op's carry after a JAX block continues
    in the port, and the port's carry back in JAX; the symbols of each
    next block agree with an uninterrupted JAX run in >= 99.5% of places."""
    fs, nch, blk = 192_000.0, 4, 8192
    x = (rng.normal(size=(nch, 3 * blk)) + 1j * rng.normal(size=(nch, 3 *
                                                                  blk))
         ).astype(np.complex64)
    with kernel_mode("interpret"):
        jp = _afsk_pipe(J, fs, blk, nch)
        jstep = jp.compile()
        jc = jp.init_carry()
        ref = []
        for i in range(3):
            jc, y = jstep(jc, jcplx.as_block(x[:, i * blk:(i + 1) * blk]))
            ref.append(np.asarray(y))
        jc0, _ = jstep(jp.init_carry(), jcplx.as_block(x[:, :blk]))
        pp = _afsk_pipe(P, fs, blk, nch)
        pc = interop.state_from_numpy(jc0, "cpu")
        pc, py = pp.apply(pc, cplx.as_block(x[:, blk:2 * blk]))
        host = interop.state_to_numpy(pc)
        jc2 = tuple(
            tuple(jcplx.Complex(jnp.asarray(s.re), jnp.asarray(s.im))
                  if hasattr(s, "re") else jnp.asarray(s) for s in stage)
            for stage in host)
        _, jy = jstep(jc2, jcplx.as_block(x[:, 2 * blk:]))
    assert (py.numpy() == ref[1]).mean() > 0.995
    assert (np.asarray(jy) == ref[2]).mean() > 0.995


def _ax25_iq(info, fs=96_000.0, blk=8192, nch=64):
    from libsdr_tpu_torch.decode import ax25_frame_bits
    from libsdr_tpu_torch.ops import siggen

    line, cur = [], 0
    for bb in ax25_frame_bits("N0CALL", "APRS", info, n_flags=20):
        cur ^= int(bb == 0)
        line.append(cur)
    audio = siggen.fsk_modulate(48000.0, np.asarray(line, np.uint8), 1200.0,
                                1200.0, 2200.0).real
    up = np.repeat(audio, 2)
    n = -(-len(up) // blk) * blk
    up = np.pad(up, (256, n - len(up) - 256))
    inst = 2 * np.pi * (24e3 / fs) + 2 * np.pi * (3e3 / fs) * up
    iq = np.exp(1j * np.cumsum(inst)).astype(np.complex64)
    return np.broadcast_to(iq, (nch, len(iq))).copy()


def test_afsk_fused_decodes_ax25_like_jax():
    """tests/test_pallas.py's AX.25 fixture at 64 channels: the port's fused
    chain + BitStream decodes the payload that JAX's fused chain (interpret
    mode) decodes, on every channel."""
    from libsdr_tpu.decode import AX25Decoder as JDec
    from libsdr_tpu_torch.decode import AX25Decoder

    fs, blk = 96_000.0, 8192
    info = b"!4903.50N/07201.75W-fused"
    x = _ax25_iq(info, fs, blk)
    p = _afsk_pipe(P, fs, blk, 64, bitstream=True)
    assert [type(s).__name__ for s in p.stages] == ["AFSKFrontendFused",
                                                    "BitStream"]
    _, outs = _run(p, x, blk, False)
    bits = ragged.compact(ragged.concat_host(outs))
    with kernel_mode("interpret"):
        _, jouts = _run(_afsk_pipe(J, fs, blk, 64, bitstream=True), x, blk,
                        True)
    jbits = jragged.compact(jragged.concat_host(
        [jragged.Ragged(np.asarray(o.data), np.asarray(o.valid))
         for o in jouts]))
    jd = JDec()
    jd.process(jbits[0])
    assert jd.messages and jd.messages[0].payload.endswith(info)
    for ch in bits:
        d = AX25Decoder()
        d.process(ch)
        assert [m.payload for m in d.messages] == [m.payload
                                                   for m in jd.messages]


# -- decoders ----------------------------------------------------------------

def test_decoders_match_jax(rng):
    """The numpy-only decoder copies against the JAX package's on the same
    bits: round trips of every encoder, repaired and corrupted streams,
    and noise."""
    import libsdr_tpu.decode as jd
    import libsdr_tpu_torch.decode as pd

    for w in (0, 1, 0x1FFFFF, 0x12345):
        assert pd.bch_encode(w) == jd.bch_encode(w)
        e = pd.bch_encode(w) ^ (1 << 3) ^ (1 << 17)
        assert pd.bch_repair(e) == jd.bch_repair(e)
        assert pd.bch_syndrome(e) == jd.bch_syndrome(e)
    bits = pd.pocsag_encode_batch(address=4242, function=1,
                                  text="TPU PAGER " * 8)
    np.testing.assert_array_equal(bits, jd.pocsag_encode_batch(
        address=4242, function=1, text="TPU PAGER " * 8))
    noisy = bits.copy()
    noisy[700] ^= 1
    noisy[850] ^= 1
    for b in (bits, noisy):
        pm, jm = pd.pocsag_decode_bits(b), jd.POCSAGDecoder().process(b)
        assert [(m.address, m.function, m.as_text()) for m in pm] == [
            (m.address, m.function, m.as_text()) for m in jm]
        assert pm[0].address == 4242 and pm[0].as_text().startswith(
            "TPU PAGER")
    frame = pd.ax25_frame_bits("N0CALL", "APRS", b"!4903.50N/07201.75W-x",
                               via=["WIDE1"], n_flags=4)
    np.testing.assert_array_equal(frame, jd.ax25_frame_bits(
        "N0CALL", "APRS", b"!4903.50N/07201.75W-x", via=["WIDE1"],
        n_flags=4))
    bad = frame.copy()
    bad[60] ^= 1
    for b in (frame, bad):
        assert [str(m) for m in pd.ax25_decode_bits(b)] == [
            str(m) for m in jd.AX25Decoder().process(b)]
    from libsdr_tpu.decode.aprs import APRSDecoder as JA
    from libsdr_tpu_torch.decode.aprs import APRSDecoder as PA
    pa, ja = PA(), JA()
    pa.process(frame)
    ja.process(frame)
    assert [str(a) for a in pa.aprs_messages] == [str(a) for a in
                                                  ja.aprs_messages]
    assert pa.aprs_messages[0].has_location
    for text in ("RYRY HELLO RTTY 123", "CQ DE N0CALL"):
        hb = pd.baudot_encode_bits(text, stop_bits="1.5")
        np.testing.assert_array_equal(hb, jd.baudot_encode_bits(
            text, stop_bits="1.5"))
        assert pd.BaudotDecoder(stop_bits="1.5").process(hb) == \
            jd.BaudotDecoder(stop_bits="1.5").process(hb)
        vb = pd.varicode_encode_bits(text.lower())
        assert pd.VaricodeDecoder().process(vb) == \
            jd.VaricodeDecoder().process(vb)
    noise = (rng.random(20_000) > 0.5).astype(np.uint8)
    assert [(m.address, m.bits) for m in pd.pocsag_decode_bits(noise)] == [
        (m.address, m.bits) for m in jd.POCSAGDecoder().process(noise)]
    assert [str(m) for m in pd.ax25_decode_bits(noise)] == [
        str(m) for m in jd.AX25Decoder().process(noise)]
    assert pd.BaudotDecoder().process(noise) == jd.BaudotDecoder().process(
        noise)


# -- the runtime and the entry points ---------------------------------------

def test_run_pipeline_compacts_ragged_outputs(rng):
    """run_pipeline on a bit front end returns the compacted bits, equal to
    run_bit_chain's and to the JAX package's (tests/test_decode.py's
    case)."""
    from libsdr_tpu.apps.chains import run_bit_chain as j_run_bit_chain
    from libsdr_tpu.core import run_pipeline as j_run_pipeline
    from libsdr_tpu.core import stream_blocks as j_stream_blocks
    from libsdr_tpu_torch.apps.chains import run_bit_chain
    from libsdr_tpu_torch.core import run_pipeline, stream_blocks

    x = rng.normal(size=9600).astype(np.float32)

    def fe(pkg):
        p = pkg.Pipeline([pkg.ops.ASKDetector(),
                          pkg.ops.BitStream(1200.0, mode="normal")])
        p.bind(pkg.StreamSpec(np.float32, 24000.0, 4800))
        assert p.out_spec.ragged
        return p

    _, bits = run_pipeline(fe(P), stream_blocks(x, 4800), device="cpu")
    np.testing.assert_array_equal(bits, run_bit_chain(fe(P), x, "cpu"))
    _, jbits = j_run_pipeline(fe(J), j_stream_blocks(x, 4800))
    np.testing.assert_array_equal(bits, jbits)
    np.testing.assert_array_equal(bits, j_run_bit_chain(fe(J), x))
    seen = []
    run_pipeline(fe(P), stream_blocks(x, 4800), sink=seen.append,
                 device="cpu", collect=False)
    assert len(seen) == 2 and isinstance(seen[0], ragged.Ragged)


def test_entry_points_default_to_the_card():
    """run_pipeline and Pipeline.init_carry without a device take the card;
    without one they raise instead of running on the CPU."""
    from libsdr_tpu_torch.core import run_pipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = P.Pipeline([P.ops.ASKDetector()])
    p.bind(P.StreamSpec(np.float32, 24000.0, 100))
    with pytest.raises(RuntimeSDRError, match="no CUDA device"):
        p.init_carry()
    with pytest.raises(RuntimeSDRError, match="no CUDA device"):
        run_pipeline(p, [np.zeros(100, np.float32)])
    assert p.init_carry("cpu") == ((),)


def test_cuda_tensors_without_a_card_are_refused():
    """The kernels' wrappers take the plain version only for a CPU tensor:
    any other device launches a kernel or raises."""
    sym = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    z = torch.zeros(2, dtype=torch.int32, device="meta")
    f = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pll(sym, torch.zeros((2, 19), dtype=torch.int32, device="meta"), z,
            f, f, z, omega_min=0.0497, omega_max=0.0503, gain=5e-4,
            transition=True)
    m = Complex(torch.zeros(2, 64, device="meta"),
                torch.zeros(2, 64, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fir_afsk_exact(m, m[0, :5], 4, m[:, :4], m[:, 0], 1j, 1.0,
                       m[0, :4], m[0, :4], 0, m[:, :3], m[:, :3])
