"""The tensor-core route of the FM-mode FIR (``ops/fir_tc.py``, the layout
and arithmetic of ``csrc/fir_tc.cu``) on the CPU.

1. The layout: the plan rule, the tap matrix's band in the kernel's
   shared-memory blocks (bf16 hi and lo), and the frame GEMM over the
   spans the kernel stages, in float32, against the plain y of K1
   (``ops/fir_fm.py::_fir_y``) and of K6 (``ops/fir_mxu.py::_y_plain``):
   1e-6 of the largest |y| (float32 sums in two orders, ~1e-7 measured).
2. The split arithmetic: y in 3, 2 and 1 bf16 passes against the JAX
   kernels in interpret mode (``pallas_fir_mxu.fir_fm_exact`` for K1a,
   ``fir_fm_mxu`` for K6), at 'high' and after
   ``set_mxu_precision('fast')``, under the JAX tests' own bounds
   (tests/test_pallas.py): y within 1e-4 of the largest output, FM and AM
   audio within 5e-3 x max(1, |v|).  Both sides form the same bf16
   products (the kernels' passes), so they agree far inside those bounds;
   the 'fast' case is also held against the 'high' JAX kernel, from which
   it must differ (one pass keeps ~8 bits of each tap).

3. Mode afsk (K1e): the kernel's blocked window sums against the direct
   ones, the plan's room for them, and ``afsk_exact_split`` at 'high' and
   'fast' against the JAX kernel in interpret mode
   (``pallas_fir_mxu.fir_afsk_exact``) under the JAX test's bounds (disc
   within 2e-3 of each channel's max(1, max |disc|), tails within 1e-3;
   after 'fast' disc within 1e-2, the JAX kernel's one-pass band product
   rounding each product to bf16 where the port sums in float32),
   at 'high' against ``fir_afsk_exact_plain`` (disc within 1e-4 of each
   channel's largest; the tails and y_last, of this noise input whose |y|
   comes near 0, within the JAX bound 1e-3), and cut into K > 1 chunks,
   each from its L-early start, against K = 1.

4. Modes fir (K1b) and am (K1c) on the route: ``fir_exact_split`` and
   ``am_exact_split`` against the JAX exact-tiling kernel in interpret mode
   (``pallas_fir_mxu.fir_exact``, ``fir_fm_exact(mode="am")`` with and
   without the AGC) at float32 and bfloat16 planes, 'high' and 'fast',
   from a nonzero tail, at the DDC bank's (T 67, D 4) shape and the AM
   bank's taps at a stride the JAX kernel takes on 16 channels (T 71, D
   20: its VMEM gate refuses D = 40, where its Toeplitz block alone is 21
   MB of its 13.5 MB); at the AM bank's own (T 71, D 40) against the JAX
   package's path there (``fir._conv1d`` and the AGC's
   ``iir_first_order``, float32 whatever the precision, so at 'high'
   only).  Bounds: y within FIR_REL of max |y|; am audio within
   AUDIO_BOUND x max(1, |v|) and the exported sd within FIR_REL.  Then the
   split cut into K chunks against K = 1, and at 'high' against the plain
   versions under the card's gates (1e-5 of max |y|; with the AGC 1e-4).

5. Mode usb (K1d) and the v1 any-offset FIR (K5) on the route:
   ``usb_exact_split`` (+- the AGC) against the JAX exact-tiling kernel in
   mode 'usb' in interpret mode (``pallas_fir_mxu.fir_fm_exact(mode="usb",
   usb_phasors=...)``, its VMEM budget lifted: the TPU's gate refuses D >=
   40, interpret mode runs the same kernel at any size) at the USB bank's
   (T 143, D 80) and at D = 100, both plane dtypes, 'high' and 'fast',
   under test_am_split_matches_jax's bounds; ``fir_mxu_split`` at window
   starts 0, 1, D - 1 and D against the JAX v1 kernel ``fir_mxu`` in
   interpret mode (y within FIR_REL of max |y|), and from starts in the
   tail (F1's offsets 0 and 1) against the JAX package's
   ``fir_overlap_save`` in interpret mode; K5's split at every window
   form of its callers (starts in the tail with wrap 0, 0 with wrap 0 and
   with 128*D, D, 2D + 1) cut into K chunks against the plain versions
   under the card's gate; and K1d's split in the chunks test of (4).

The CUDA kernel is held to this emulation on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu.ops import fir as jfir
from libsdr_tpu.ops import pallas_fir_mxu as pfm
from libsdr_tpu.ops.fir import set_mxu_precision as jax_set_precision
from libsdr_tpu.ops.iir import iir_first_order as jax_iir
from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import ConfigError
from libsdr_tpu_torch.ops import fir_tc as TC
from libsdr_tpu_torch.ops import fsk
from libsdr_tpu_torch.ops.fir import mxu_precision, set_mxu_precision
from libsdr_tpu_torch.ops.fir_fm import (_fir_y, fir_afsk_exact_plain,
                                         fir_am_exact_plain, fir_exact_plain,
                                         fir_usb_exact_plain)
from libsdr_tpu_torch.ops.fir_mxu import (_y_plain, fir_mxu_plain,
                                          fir_offset_plain)

Y_REL = 1e-6        # frame GEMM in float32 against the plain y
FIR_REL = 1e-4      # tests/test_pallas.py:36-37
AUDIO_BOUND = 5e-3  # tests/test_pallas.py:125, 162 (x max(1, |v|))
ROT, GAIN = np.exp(-0.41j), 1.3


def _cn(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _t(x, dtype=torch.float32):
    """numpy complex -> torch Complex of float32 planes (then dtype)."""
    return Complex(torch.from_numpy(x.real.copy()),
                   torch.from_numpy(x.imag.copy())).to(dtype)


def _taps(g):
    return Complex(torch.tensor(g.real, dtype=torch.float32),
                   torch.tensor(g.imag, dtype=torch.float32))


def _j(x, dtype):
    """torch Complex -> JAX Complex of the same values in ``dtype``."""
    return jcplx.Complex(jnp.asarray(x.re.float().numpy()).astype(dtype),
                         jnp.asarray(x.im.float().numpy()).astype(dtype))


def _np(y):
    return y.re.numpy() + 1j * y.im.numpy()


def _worst(got, want):
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 8, 10, 16, 40])
def test_plan_rule(d):
    """Every plan the rule makes keeps the kernel's constraints: 16-byte
    rows (S*D a multiple of 8), at most 4 n-tiles, 16 frames a MMA warp,
    each n-tile's band inside the k-tiles, its shared memory within a
    block's; the main path's plan (T = 67, D = 4) is 14 outputs a frame at
    a conflict-free 112-byte row stride, 64 frames a tile, two blocks an
    SM for both plane dtypes."""
    for t in (1, 17, 67, 71, 143, 263):
        for isz, passes in ((4, 3), (2, 2), (4, 1), (2, 1)):
            plan = TC.tc_plan(t, d, isz, passes)
            assert plan is not None, (t, d, isz)
            assert plan.S * d % 8 == 0 and 1 <= plan.S <= 16
            assert plan.F in (16, 32, 64) and plan.NTL == -(-plan.S // 4)
            assert plan.Kp % 16 == 0 and plan.Kp >= (plan.S - 1) * d + t
            assert plan.bytes <= TC.SMEM_BLOCK
            for nt in range(plan.NTL):
                lo, hi = TC.band(nt, plan.S, d, t, plan.Kp // 16)
                assert 0 <= lo < hi <= plan.Kp // 16
                assert hi - lo <= plan.KBW
    if d == 4:
        for isz, passes in ((4, 3), (2, 2)):
            plan = TC.tc_plan(67, 4, isz, passes)
            assert (plan.S, plan.F) == (14, 64)
            assert TC.ldsm_ways(2 * plan.S * 4) == 1
            assert plan.bytes <= TC.SMEM_SM // 2 - 1024
    if d == 40:
        # the AM bank (T = 71): S*D = 40 S bytes a frame, an odd multiple
        # of 8 so that ldmatrix's rows miss each other's banks, and two
        # blocks an SM in every arithmetic
        for isz, passes in ((4, 3), (2, 2), (4, 1), (2, 1)):
            plan = TC.tc_plan(71, 40, isz, passes)
            assert plan.S % 2 == 1 and TC.ldsm_ways(2 * plan.S * 40) == 1
            assert plan.bytes <= TC.SMEM_SM // 2 - 1024
    # thousands of taps do not fit: such launches take the staged kernel
    assert TC.tc_plan(12001, 16, 4, 3) is None


@pytest.mark.parametrize("d,t", [(2, 17), (4, 67), (16, 143), (5, 68)])
def test_tap_blocks_hold_the_band(d, t):
    """The kernel's shared-memory tap blocks are the tap matrix's band:
    reassembled they equal the matrix's bf16 hi and lo parts exactly, and
    the matrix has no nonzero outside the band; hi + lo is the tap to
    2^-16 of the largest."""
    rng = np.random.default_rng(d * 100 + t)
    g = rng.normal(size=t) + 1j * rng.normal(size=t)
    plan = TC.tc_plan(t, d, 4, 3)
    kp, ntl = plan.Kp, plan.NTL
    dense = torch.zeros(2 * kp, 8 * ntl)
    dense[:, :2 * plan.S] = TC.tap_matrix(_taps(g), d, plan.S, kp)
    hi, lo = TC.split_bf16(dense)
    blocks = TC.tap_blocks(_taps(g), d, plan).float()
    back = torch.zeros(2, 2 * kp, 8 * ntl)   # (hi/lo, rows, columns)
    covered = torch.zeros(2 * kp, 8 * ntl, dtype=torch.bool)
    for h in range(2):
        for nt in range(ntl):
            b_lo, b_hi = TC.band(nt, plan.S, d, t, kp // 16)
            for kb in range(b_hi - b_lo):
                r0 = h * kp + 16 * (b_lo + kb)
                for hl in range(2):
                    blk = blocks[h, nt, kb, hl]          # (kh, n, kq)
                    back[hl, r0:r0 + 16, 8 * nt:8 * nt + 8] = \
                        blk.transpose(1, 2).reshape(16, 8)
                covered[r0:r0 + 16, 8 * nt:8 * nt + 8] = True
            # slots past the band are zeros
            assert not blocks[h, nt, b_hi - b_lo:].any()
    assert torch.equal(back[0], hi) and torch.equal(back[1], lo)
    assert not dense[~covered].any()
    assert float((hi + lo - dense).abs().max()) <= \
        2.0 ** -16 * float(dense.abs().max())
    # one frame through the matrix: its interleaved columns are y's planes
    x = _cn(rng, kp)
    y = torch.cat([_t(x).re, _t(x).im]) @ TC.tap_matrix(_taps(g), d,
                                                       plan.S, kp)
    want = [np.dot(g, x[s * d:s * d + t].astype(np.complex128))
            for s in range(plan.S)]
    got = y[0::2].numpy() + 1j * y[1::2].numpy()
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("d,t", [(2, 17), (4, 67), (16, 143), (2, 143),
                                 (16, 17)])
def test_frame_gemm_equals_plain_y_k1(d, t):
    """K1's window start (D - T, the first windows in the carry tail): the
    frame GEMM over the staged span in float32 equals _fir_y, with a ragged
    last frame (B/D not a multiple of S)."""
    rng = np.random.default_rng(d + 7 * t)
    c = 3
    s = TC.tc_plan(t, d, 4, 3).S
    n_out = 37 * s + s // 2 + 1
    x, tail = _t(_cn(rng, c, n_out * d)), _t(_cn(rng, c, t - 1))
    g = _taps(rng.normal(size=t) + 1j * rng.normal(size=t))
    want = _fir_y(x, g, d, tail)
    got = TC.fir_y_split(TC.span_k1(x, tail, d), g, d, n_out, passes=None,
                         s=s)
    scale = float(max(want.re.abs().max(), want.im.abs().max()))
    assert got.re.shape == want.re.shape == (c, n_out)
    assert float(max((got.re - want.re).abs().max(),
                     (got.im - want.im).abs().max())) < Y_REL * scale


@pytest.mark.parametrize("s0", [0, 1, "D"])
@pytest.mark.parametrize("d,t", [(2, 17), (4, 67), (16, 143)])
def test_frame_gemm_equals_plain_y_k6(d, t, s0):
    """K6's window starts 0, 1 and D, its last frame wrapping to the frame
    before it (x[n - 128 D] past the block): the frame GEMM equals K6's
    plain y, the ragged last frame included."""
    s0 = d if s0 == "D" else s0
    rng = np.random.default_rng(3 * d + t + s0)
    c, b = 3, 2 * 128 * d
    x = _t(_cn(rng, c, b))
    g = _taps(rng.normal(size=t) + 1j * rng.normal(size=t))
    want = _y_plain(x, g, d, s0)
    s = TC.tc_plan(t, d, 4, 3).S
    assert (b // d) % s != 0
    got = TC.fir_y_split(TC.span_k6(x, t, d, s0), g, d, b // d,
                         passes=None, s=s)
    scale = float(max(want.re.abs().max(), want.im.abs().max()))
    assert float(max((got.re - want.re).abs().max(),
                     (got.im - want.im).abs().max())) < Y_REL * scale


@pytest.fixture
def jax_precision():
    """Sets the JAX package's FIR precision for a test and restores 'high'
    after it."""
    def set_(mode):
        jax_set_precision(mode)
    try:
        yield set_
    finally:
        jax_set_precision("high")


def _k1_case(rng, c, d, t, b, dtype):
    x = _t(_cn(rng, c, b), dtype)
    tail = _t(_cn(rng, c, t - 1), dtype)
    prev = _t(_cn(rng, c))
    state = torch.from_numpy(rng.uniform(-0.5, 0.5, size=c).astype(
        np.float32))
    g = rng.normal(size=t) + 1j * rng.normal(size=t)
    return x, tail, prev, state, g


@pytest.mark.parametrize("precision", ["high", "fast"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_matches_jax_k1a(dtype, precision, jax_precision):
    """K1a: the kernel's split arithmetic (3 passes on float32 planes, 2 on
    bfloat16, 1 after 'fast') with the FM discriminator and the
    de-emphasis, from nonzero carries, against the JAX exact-tiling kernel
    in interpret mode at the same precision: every output and y_last."""
    rng = np.random.default_rng(11 if dtype == "float32" else 12)
    c, d, t, b = 16, 4, 67, 4096
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x, tail, prev, state, g = _k1_case(rng, c, d, t, b, tdt)
    ab = (0.95, 0.05)
    fast = precision == "fast"
    jax_precision(precision)
    want, jy = pfm.fir_fm_exact(
        _j(x, dtype), g, d, _j(tail, dtype),
        jcplx.as_block(_np(prev)[:, None]), ROT, GAIN, deemph_ab=ab,
        deemph_lead=jnp.asarray(state.numpy()[:, None]), interpret=True)
    got, ty = TC.fm_exact_split(x, _taps(g), d, tail, prev, ROT, GAIN, ab,
                                state, passes=TC.passes_for(tdt, fast))
    want = np.asarray(want)
    assert got.shape == want.shape == (c, b // d)
    assert _worst(got.numpy(), want) < AUDIO_BOUND
    y_ref = jcplx.to_numpy(jy)[:, 0]
    assert np.abs(_np(ty) - y_ref).max() < FIR_REL * np.abs(y_ref).max()
    if fast:
        # one pass is not three: the 'high' kernel differs from it
        jax_precision("high")
        high, _ = pfm.fir_fm_exact(
            _j(x, dtype), g, d, _j(tail, dtype),
            jcplx.as_block(_np(prev)[:, None]), ROT, GAIN, deemph_ab=ab,
            deemph_lead=jnp.asarray(state.numpy()[:, None]), interpret=True)
        assert np.abs(np.asarray(high) - want).max() > 1e-4


def _k6_case(rng, dtype):
    c, d, t, s0 = 8, 2, 37, 1
    b = 2 * pfm._FT * pfm._S * d
    x = _t(_cn(rng, c, b), dtype)
    g = rng.normal(size=t) + 1j * rng.normal(size=t)
    lead = _t(_cn(rng, c, 1))
    state = rng.uniform(0.3, 1.0, size=(c, 1)).astype(np.float32)
    return x, g, d, s0, lead, state


@pytest.mark.parametrize("precision", ["high", "fast"])
@pytest.mark.parametrize("mode,ab", [("fm", None), ("fm", (0.93, 0.07)),
                                     ("am", None), ("am", (0.97, 0.03))])
def test_split_emulation_matches_jax_k6(mode, ab, precision, jax_precision):
    """K6, modes fm (+- de-emphasis) and am (+- the AGC): the split
    arithmetic against the JAX v1 kernel in interpret mode at the same
    precision, every output (the clamped last frame too) and the AGC's
    exported state."""
    rng = np.random.default_rng(21)
    x, g, d, s0, lead, state = _k6_case(rng, torch.float32)
    rot, gain = (np.exp(-0.37j), 1.7) if mode == "fm" else (1.0, 0.125)
    jax_precision(precision)
    jr = pfm.fir_fm_mxu(
        _j(x, "float32"), g, d, s0, jcplx.as_block(_np(lead)), rot, gain,
        deemph_ab=ab, deemph_lead=None if ab is None else jnp.asarray(state),
        mode=mode, interpret=True)
    tr = TC.fm_mxu_split(x, _taps(g), d, s0, lead, rot, gain, ab,
                         None if ab is None else torch.from_numpy(state),
                         mode=mode,
                         passes=TC.passes_for(torch.float32,
                                              precision == "fast"))
    jr = jr if isinstance(jr, tuple) else (jr,)
    assert len(tr) == len(jr) == (3 if mode == "am" and ab else 2)
    want, got = np.asarray(jr[0]), tr[0].numpy()
    assert got.shape == want.shape
    assert _worst(got, want) < AUDIO_BOUND
    if mode == "am" and ab:
        sd_want, sd_got = np.asarray(jr[1]), tr[1].numpy()
        assert np.abs(sd_got - sd_want).max() < FIR_REL * np.abs(
            sd_want).max()


def test_passes_and_the_precision_switch():
    """set_mxu_precision('fast') selects one pass for both plane dtypes;
    'high' three for float32 planes and two for bfloat16; an unknown mode
    raises and leaves the mode as it was."""
    assert mxu_precision() == "high"
    try:
        set_mxu_precision("fast")
        assert mxu_precision() == "fast"
        with pytest.raises(ConfigError):
            set_mxu_precision("x3")
        assert mxu_precision() == "fast"
    finally:
        set_mxu_precision("high")
    assert [TC.passes_for(dt, f) for dt in (torch.float32, torch.bfloat16)
            for f in (False, True)] == [3, 1, 2, 1]


# -- mode afsk (K1e): the correlator's band product -------------------------

AFSK_JAX_DISC = 2e-3   # tests/test_torch_digital.py's K1e case: of max
AFSK_JAX_TAIL = 1e-3   # |disc| (at least 1), and the tails absolute
AFSK_PLAIN = 1e-4      # chip_smoke.py's K1e bound against the plain version
# after 'fast' the JAX kernel's band product rounds each product to bf16
# (2^-9 of it; one pass of wmm), the port's sums are float32: 3.5e-3 of
# max |disc| apart on this case
AFSK_JAX_FAST_DISC = 1e-2


@pytest.mark.parametrize("ell", [2, 3, 4, 5, 9, 40, 42, 128, 255, 256])
def test_afsk_blocked_sums(ell):
    """The kernel's blocked window sums (each window start e = (L-1) % 4
    places it, and the history of (L-1)//4 + 1 blocks reaches every start)
    equal the direct sums: exactly on integer products, to float32
    round-off on others; and the plan of mode afsk holds its prefix sums
    over the converted span without costing the main path's P1 shape its
    two blocks an SM."""
    rng = np.random.default_rng(ell)
    hb = TC.history_blocks(ell)
    assert 4 * hb >= ell and 4 * (hb - 1) <= ell - 1
    for n in (1, 4, 37, 4 * 64 + 3):
        ui = torch.from_numpy(rng.integers(-50, 50, size=(3, ell - 1 + n))
                              .astype(np.float32))
        assert torch.equal(TC.blocked_sums(ui, ell), fsk.window_sum(ui, ell))
        u = torch.from_numpy(rng.normal(size=(3, ell - 1 + n)).astype(
            np.float32))
        want = fsk.window_sum(u.double(), ell)
        got = TC.blocked_sums(u, ell)
        assert got.shape == (3, n)
        assert float((got - want).abs().max()) < 1e-6 * ell * float(
            u.abs().max())
    for isz, passes in ((4, 3), (2, 2)):
        base = TC.tc_plan(51, 4, isz, passes)
        plan = TC.tc_plan(51, 4, isz, passes, ell=ell)
        assert plan is not None and plan[:7] == base[:7]
        assert plan.bytes - base.bytes >= 4 * hb * 16 + 16 * ell
    p1 = TC.tc_plan(51, 4, 4, 3, ell=40)
    assert p1.bytes <= TC.SMEM_SM // 2 - 1024


def _afsk_case(dtype):
    """tests/test_torch_digital.py's K1e case: C = 8, D = 4, T = 49,
    L = 40, B = 16384, template phase 16, nonzero carried products."""
    rng = np.random.default_rng(497)
    c, d, t, ell, b, n0 = 8, 4, 49, 40, 16384, 16
    x = _cn(rng, c, b)
    g = rng.normal(size=t) + 1j * rng.normal(size=t)
    tm, ts = fsk.tone_tables(1200.0, 2200.0, 48000.0, ell)
    um = rng.normal(size=(c, 2, ell - 1)).astype(np.float32)
    us = rng.normal(size=(c, 2, ell - 1)).astype(np.float32)
    lead = _cn(rng, c)
    tail = _cn(rng, c, t - 1)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    args = (_t(x, tdt), _taps(g), d, _t(tail, tdt), _t(lead), np.exp(-0.37j),
            0.8, cplx.constant(tm), cplx.constant(ts), n0,
            Complex(torch.from_numpy(um[:, 0]), torch.from_numpy(um[:, 1])),
            Complex(torch.from_numpy(us[:, 0]), torch.from_numpy(us[:, 1])))
    return args, (g, tm, ts, um, us)


def _afsk_jax(args, extra, dtype):
    """The JAX kernel (interpret mode) on the case: disc, y_last and the
    two tails as numpy."""
    x, _, d, tail, lead, rot, gain, _, _, n0, _, _ = args
    g, tm, ts, um, us = extra
    s, ell = pfm._S, tm.shape[0]
    n_audio = x.re.shape[-1] // d
    reps = -(-(n_audio + n0 + ell) // ell)
    tpl = np.zeros((8, reps * ell), np.float32)
    tpl[0], tpl[1] = np.tile(tm.real, reps), np.tile(tm.imag, reps)
    tpl[2], tpl[3] = np.tile(ts.real, reps), np.tile(ts.imag, reps)
    c = x.re.shape[0]
    up = np.zeros((c, 4 * s), np.float32)
    lo = s - (ell - 1)
    up[:, lo:s], up[:, s + lo:2 * s] = um[:, 0], um[:, 1]
    up[:, 2 * s + lo:3 * s], up[:, 3 * s + lo:] = us[:, 0], us[:, 1]
    jd, jy, jul = pfm.fir_afsk_exact(
        _j(x, dtype), g, d, _j(tail, dtype),
        jcplx.as_block(_np(lead)[:, None]), rot, gain, ell,
        jnp.asarray(tpl[:, n0:n0 + n_audio]), jnp.asarray(up),
        interpret=True)
    jul = np.asarray(jul)
    tails = [jul[:, (k + 1) * s - (ell - 1):(k + 1) * s] for k in range(4)]
    return np.asarray(jd), jcplx.to_numpy(jy)[:, 0], tails


def _tails(res):
    return [v.numpy() for v in (res[2].re, res[2].im, res[3].re, res[3].im)]


@pytest.mark.parametrize("precision", ["high", "fast"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_afsk_split_matches_jax(dtype, precision, jax_precision):
    """K1e's split (the FIR in 3, 2 or 1 bf16 passes, the window sums in
    float32; the JAX kernel's band product in 2 or 1) against the JAX
    kernel in interpret mode at the same precision, under the JAX test's
    bounds (disc after 'fast' under AFSK_JAX_FAST_DISC): disc, y_last and
    the exported products."""
    args, extra = _afsk_case(dtype)
    fast = precision == "fast"
    jax_precision(precision)
    jd, jy, jt = _afsk_jax(args, extra, dtype)
    passes = TC.passes_for(args[0].re.dtype, fast)
    got = TC.afsk_exact_split(*args, passes=passes)
    disc = got[0].numpy()
    assert disc.shape == jd.shape == (8, 4096)
    scale = np.maximum(1.0, np.abs(jd).max(axis=1, keepdims=True))
    bound = AFSK_JAX_FAST_DISC if fast else AFSK_JAX_DISC
    assert (np.abs(disc - jd) / scale).max() < bound
    for a, b in zip(_tails(got), jt):
        np.testing.assert_allclose(a, b, atol=AFSK_JAX_TAIL)
    np.testing.assert_allclose(_np(got[1]), jy, atol=AFSK_JAX_TAIL)


@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_afsk_split_matches_plain_and_chunks(dtype, chunks):
    """At 'high', the split against fir_afsk_exact_plain: disc within 1e-4
    of each channel's largest |disc|, the tails and y_last within 1e-3;
    cut into K chunks, each from its L-early start with zero history, it
    gives what K = 1 gives, to float32 round-off of the frame grid."""
    args, _ = _afsk_case(dtype)
    passes = TC.passes_for(args[0].re.dtype, False)
    got = TC.afsk_exact_split(*args, passes=passes, chunks=chunks)
    ref = fir_afsk_exact_plain(*args)
    scale = ref[0].abs().amax(dim=1, keepdim=True)
    assert float(((got[0] - ref[0]).abs() / scale).max()) < AFSK_PLAIN
    for a, b in zip(_tails(got), _tails(ref)):
        assert np.abs(a - b).max() < AFSK_JAX_TAIL
    assert np.abs(_np(got[1]) - _np(ref[1])).max() < AFSK_JAX_TAIL
    if chunks > 1:
        one = TC.afsk_exact_split(*args, passes=passes, chunks=1)
        assert float(((got[0] - one[0]).abs() / scale).max()) < 1e-6
        for a, b in zip(_tails(got), _tails(one)):
            assert np.abs(a - b).max() < 1e-6


# -- modes fir (K1b) and am (K1c) on the tensor-core route -----------------

LAM, AM_GAIN = 0.96, 0.125   # tests/test_torch_analog.py's AGC
CARD_REL, CARD_AGC = 1e-5, 1e-4   # chip_smoke.py's REL_BOUND, AGC_BOUND
# (T, D, C, B): the DDC bank's taps and stride, the AM bank's taps at a
# stride the JAX kernel takes, the AM bank's own (no JAX kernel)
# (16 channels: the JAX kernel's gate wants a multiple of 16 with bfloat16
# planes)
K1_SHAPES = [(67, 4, 16, 4096), (71, 20, 16, 10240), (71, 40, 4, 10240)]


def _k1_mode_case(t, d, c, b, dtype):
    rng = np.random.default_rng(100 * d + t + (dtype == "bfloat16"))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = _t(_cn(rng, c, b), tdt)
    tail = _t(_cn(rng, c, t - 1), tdt)
    g = rng.normal(size=t) + 1j * rng.normal(size=t)
    sd = rng.uniform(0.3, 1.0, size=c).astype(np.float32)
    return x, tail, g, sd


def _jax_fir(x, tail, g, d, dtype):
    """The JAX package's y at this shape: its exact-tiling kernel where its
    gate takes the shape, else its own path there, ``_conv1d`` over tail +
    block from window start D - 1."""
    c, b = x.re.shape
    kernel = pfm.mxu_fir2_supported(len(g), d, c, b, dtype=dtype)
    assert kernel == (d <= 20)
    if kernel:
        return jcplx.to_numpy(pfm.fir_exact(_j(x, dtype), g, d,
                                            _j(tail, dtype), interpret=True))
    # in float32 over the same samples (bfloat16 ones are exact in it)
    xc = jcplx.concatenate([_j(tail, "float32"), _j(x, "float32")], axis=-1)
    return jcplx.to_numpy(jfir._conv1d(xc[..., d - 1:], g, d))


def _jax_am(x, tail, g, d, dtype, agc, sd):
    """The JAX package's AM audio (and sd_last with the AGC) at this shape:
    ``fir_fm_exact(mode="am")`` where its gate takes the shape, else
    AMBasebandFused's path, ``|_conv1d|`` and ``iir_first_order``."""
    c, b = x.re.shape
    ab = (LAM, 1 - LAM) if agc else None
    gain = AM_GAIN if agc else 1.0
    if pfm.mxu_fir2_supported(len(g), d, c, b, dtype=dtype):
        aj, ej = pfm.fir_fm_exact(
            _j(x, dtype), g, d, _j(tail, dtype), jcplx.zeros((c, 1)), 1.0,
            gain, deemph_ab=ab,
            deemph_lead=jnp.asarray(sd[:, None]) if agc else None,
            mode="am", interpret=True)
        return np.asarray(aj), np.asarray(ej.re)[:, 0] if agc else None
    sig = jnp.abs(jnp.asarray(_jax_fir(x, tail, g, d, dtype))).astype(
        jnp.float32)
    if not agc:
        return np.asarray(gain * sig), None
    sdv, sd_last = jax_iir(sig, ab[0], ab[1], jnp.asarray(sd))
    return np.asarray(gain * sig / sdv), np.asarray(sd_last)


# 'fast' where the JAX kernel runs (at D = 40 the JAX package is float32
# at either precision)
K1_CASES = [(*shape, precision) for shape in K1_SHAPES
            for precision in ("high", "fast")
            if precision == "high" or shape[1] <= 20]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,c,b,precision", K1_CASES)
def test_fir_split_matches_jax(t, d, c, b, precision, dtype, jax_precision):
    """K1b: fir_exact_split (3, 2 or 1 bf16 passes) from a nonzero tail
    against the JAX package at the same precision: every output within
    FIR_REL of max |y|.  At 'fast' the 'high' JAX kernel differs from it
    by more than that (one pass keeps ~8 bits of each tap)."""
    x, tail, g, _ = _k1_mode_case(t, d, c, b, dtype)
    fast = precision == "fast"
    jax_precision(precision)
    want = _jax_fir(x, tail, g, d, dtype)
    got = _np(TC.fir_exact_split(x, _taps(g), d, tail,
                                 passes=TC.passes_for(x.re.dtype, fast)))
    assert got.shape == want.shape == (c, b // d)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < FIR_REL * scale
    if fast:
        jax_precision("high")
        high = _jax_fir(x, tail, g, d, dtype)
        assert np.abs(high - want).max() > FIR_REL * scale


@pytest.mark.parametrize("agc", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,c,b,precision", K1_CASES)
def test_am_split_matches_jax(t, d, c, b, precision, dtype, agc,
                              jax_precision):
    """K1c: am_exact_split with and without the AGC (from a nonzero sd)
    against the JAX package at the same precision: the audio within
    AUDIO_BOUND x max(1, |v|), the exported sd within FIR_REL of its
    largest."""
    x, tail, g, sd = _k1_mode_case(t, d, c, b, dtype)
    fast = precision == "fast"
    jax_precision(precision)
    want, sd_want = _jax_am(x, tail, g, d, dtype, agc, sd)
    ab = (LAM, 1 - LAM) if agc else None
    got, sd_got = TC.am_exact_split(
        x, _taps(g), d, tail, AM_GAIN if agc else 1.0, ab,
        torch.from_numpy(sd) if agc else None,
        passes=TC.passes_for(x.re.dtype, fast))
    assert got.shape == want.shape == (c, b // d)
    assert _worst(got.numpy(), want) < AUDIO_BOUND
    if agc:
        assert np.abs(sd_got.numpy() - sd_want).max() < FIR_REL * np.abs(
            sd_want).max()
    else:
        assert sd_got is None and sd_want is None


@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(67, 4), (71, 40), (143, 80)])
def test_k1_split_chunks_and_plain(t, d, dtype, chunks):
    """K1b's, K1c's and K1d's split at 'high' cut into K chunks (each from
    its own frame grid, as the kernel's blocks run them) gives what K = 1
    gives, to float32 round-off of the frame grid (1e-6 of the largest
    output); and it holds the card's gates against the plain versions: y,
    |y| and the USB audio within 1e-5 of the largest output, with the AGC
    1e-4 on the audio and of the exported sd."""
    c, n = 3, 1000
    x, tail, g, sd = _k1_mode_case(t, d, c, d * n, dtype)
    taps = _taps(g)
    passes = TC.passes_for(x.re.dtype, False)
    ab, sdt = (LAM, 1 - LAM), torch.from_numpy(sd)
    y = TC.fir_exact_split(x, taps, d, tail, passes=passes, chunks=chunks)
    am = TC.am_exact_split(x, taps, d, tail, 1.0, passes=passes,
                           chunks=chunks)[0]
    agc, sd_last = TC.am_exact_split(x, taps, d, tail, AM_GAIN, ab, sdt,
                                     passes=passes, chunks=chunks)
    y_ref = fir_exact_plain(x, taps, d, tail)
    scale = float(torch.maximum(y_ref.re.abs().max(), y_ref.im.abs().max()))
    assert y.re.shape == (c, n)
    assert float(max((y.re - y_ref.re).abs().max(),
                     (y.im - y_ref.im).abs().max())) < CARD_REL * scale
    am_ref = fir_am_exact_plain(x, taps, d, tail, 1.0)[0]
    assert float((am - am_ref).abs().max()) < CARD_REL * float(
        am_ref.abs().max())
    agc_ref, sd_ref = fir_am_exact_plain(x, taps, d, tail, AM_GAIN, ab, sdt)
    assert float((agc - agc_ref).abs().max()) < CARD_AGC
    assert float(((sd_last - sd_ref) / sd_ref).abs().max()) < CARD_AGC
    ph, ramp, _ = _usb_operands(d, n)
    usb = TC.usb_exact_split(x, taps, d, tail, ph, ramp, 1.0, passes=passes,
                             chunks=chunks)[0]
    usb_ref = fir_usb_exact_plain(x, taps, d, tail, ph, ramp, 1.0)[0]
    assert float((usb - usb_ref).abs().max()) < CARD_REL * float(
        usb_ref.abs().max())
    usb_agc, usb_sd = TC.usb_exact_split(x, taps, d, tail, ph, ramp, AM_GAIN,
                                         ab, sdt, passes=passes,
                                         chunks=chunks)
    ref_agc, ref_sd = fir_usb_exact_plain(x, taps, d, tail, ph, ramp,
                                          AM_GAIN, ab, sdt)
    assert float((usb_agc - ref_agc).abs().max()) < CARD_AGC
    assert float(((usb_sd - ref_sd) / ref_sd).abs().max()) < CARD_AGC
    if chunks > 1:
        one = TC.fir_exact_split(x, taps, d, tail, passes=passes)
        assert float(max((y.re - one.re).abs().max(),
                         (y.im - one.im).abs().max())) < 1e-6 * scale
        one_agc = TC.am_exact_split(x, taps, d, tail, AM_GAIN, ab, sdt,
                                    passes=passes)[0]
        assert float((agc - one_agc).abs().max()) < 1e-6 * float(
            one_agc.abs().max())
        one_usb = TC.usb_exact_split(x, taps, d, tail, ph, ramp, AM_GAIN, ab,
                                     sdt, passes=passes)[0]
        assert float((usb_agc - one_usb).abs().max()) < 1e-6 * float(
            one_usb.abs().max())


# -- mode usb (K1d) and the v1 any-offset FIR (K5) on the tensor-core route -

USB_THETA = 2 * np.pi * 1500.0 / 960e3   # the NCO's step a sample
USB_A0 = np.exp(0.7j)                    # the carried unit phasor
# (T, D, C, B): the USB bank's taps and stride, and D = 100 with the rx
# chain's order (T = 64 + D - 1), two frames of 128 outputs on 16
# channels (the JAX kernel's gate wants a multiple of 16 with bfloat16
# planes)
USB_CASES = [(143, 80, 16, 2 * 128 * 80), (163, 100, 16, 2 * 128 * 100)]


def _usb_operands(d, n):
    """The port's (a0, ramp (n,)) and the JAX kernel's usb_phasors (fph:
    a0 times each 128-output frame's phasor, rrow: each lane's) for one
    block of n outputs at stride d."""
    th = USB_THETA * d
    ph = cplx.constant(np.complex64(USB_A0), torch.float32)
    ramp = cplx.constant(np.exp(-1j * th * np.arange(n)), torch.float32)
    s = pfm._S
    fr = (USB_A0 * np.exp(-1j * th * s * np.arange(n // s))).astype(
        np.complex64)
    fph = np.zeros((len(fr), 8), np.float32)
    fph[:, 0], fph[:, 1] = fr.real, fr.imag
    row = np.exp(-1j * th * np.arange(s))
    rrow = np.zeros((16, s), np.float32)
    rrow[0], rrow[8] = row.real, row.imag
    return ph, ramp, (jnp.asarray(fph), jnp.asarray(rrow))


@pytest.fixture
def wide_vmem(monkeypatch):
    """Lifts the JAX v2 kernel's VMEM budget for a test: at D >= 40 its
    Toeplitz block alone outgrows the TPU's 13.5 MB, so its gate refuses
    the USB bank's strides, but interpret mode runs the same kernel on the
    CPU at any size."""
    monkeypatch.setattr(pfm, "_VMEM_BUDGET", 1 << 40)


@pytest.mark.parametrize("agc", [False, True])
@pytest.mark.parametrize("precision", ["high", "fast"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,c,b", USB_CASES)
def test_usb_split_matches_jax(t, d, c, b, dtype, precision, agc,
                               jax_precision, wide_vmem):
    """K1d: usb_exact_split (3, 2 or 1 bf16 passes, the exact NCO's a0 *
    ramp[j]) with and without the AGC (from a nonzero sd) against the JAX
    exact-tiling kernel in mode 'usb' in interpret mode (per-frame phasor
    times per-lane phasor, the same rotation rounded otherwise) at the
    same precision, from a nonzero tail: the audio within AUDIO_BOUND x
    max(1, |v|), the exported sd within FIR_REL of its largest."""
    x, tail, g, sd = _k1_mode_case(t, d, c, b, dtype)
    n = b // d
    ph, ramp, phasors = _usb_operands(d, n)
    ab = (LAM, 1 - LAM) if agc else None
    gain = AM_GAIN if agc else 1.0
    jax_precision(precision)
    want, ej = pfm.fir_fm_exact(
        _j(x, dtype), g, d, _j(tail, dtype), jcplx.zeros((c, 1)), 1.0, gain,
        deemph_ab=ab, deemph_lead=jnp.asarray(sd[:, None]) if agc else None,
        mode="usb", usb_phasors=phasors, interpret=True)
    want = np.asarray(want)
    got, sd_got = TC.usb_exact_split(
        x, _taps(g), d, tail, ph, ramp, gain, ab,
        torch.from_numpy(sd) if agc else None,
        passes=TC.passes_for(x.re.dtype, precision == "fast"))
    assert got.shape == want.shape == (c, n)
    assert _worst(got.numpy(), want) < AUDIO_BOUND
    if agc:
        sd_want = np.asarray(ej.re)[:, 0]
        assert np.abs(sd_got.numpy() - sd_want).max() < FIR_REL * np.abs(
            sd_want).max()
    else:
        assert sd_got is None


# (T, D, C, B) of K5 against the JAX v1 kernel: the DDC bank's taps and
# stride (F1's), and the AM bank's taps at a stride its VMEM gate takes
K5_CASES = [(67, 4, 16, 4096), (71, 20, 16, 2 * 128 * 20)]


@pytest.mark.parametrize("precision", ["high", "fast"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", ["0", "1", "D-1", "D"])
@pytest.mark.parametrize("t,d,c,b", K5_CASES)
def test_fir_mxu_split_matches_jax(t, d, c, b, offset, dtype, precision,
                                   jax_precision):
    """K5: fir_mxu_split at window starts 0, 1, D - 1 and D (the JAX
    kernel's _build_mats takes starts up to the stride) with wrap 128*D
    (the last frame's windows clamped into the frame before it) against
    the JAX v1 kernel ``fir_mxu`` in interpret mode at the same precision:
    every output, the clamped ones too, within FIR_REL of max |y|."""
    s0 = {"0": 0, "1": 1, "D-1": d - 1, "D": d}[offset]
    x, _, g, _ = _k1_mode_case(t, d, c, b, dtype)
    assert pfm.mxu_fir_supported(t, d, s0, c, b, dtype=dtype)
    jax_precision(precision)
    jy, nsp = pfm.fir_mxu(_j(x, dtype), g, d, s0, interpret=True)
    want = jcplx.to_numpy(jy)
    got = _np(TC.fir_mxu_split(x, _taps(g), d, s0, b // d, 128 * d,
                               passes=TC.passes_for(x.re.dtype,
                                                    precision == "fast")))
    assert nsp == 128 and got.shape == want.shape == (c, b // d)
    assert np.abs(got - want).max() < FIR_REL * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1])
def test_fir_offset_split_matches_jax(offset, dtype, monkeypatch):
    """K5 as F1 calls it (``fir_overlap_save`` at offsets 0 and 1, the DDC
    bank's T = 67, D = 4): fir_mxu_split from window start offset - (T-1),
    in the (C, T-1) tail, with wrap 0 over the whole block, against the
    JAX package's ``fir_overlap_save`` in kernel_mode('interpret'), whose
    in-block outputs come from its v1 kernel ``fir_mxu`` (64 channels, its
    gate's least; the call is counted) and the outputs whose windows reach
    into the tail or past its frames from its conv: every output within
    FIR_REL of max |y|, at 'high'.  The JAX path runs on float32 planes of
    the same samples (bfloat16 ones are exact in them): with bfloat16
    planes it returns y in bfloat16, where the port returns float32."""
    t, d, c, b = 67, 4, 64, 4096
    x, tail, g, _ = _k1_mode_case(t, d, c, b, dtype)
    calls = []
    fir_mxu = pfm.fir_mxu
    monkeypatch.setattr(pfm, "fir_mxu",
                        lambda *a, **k: calls.append(a[3]) or fir_mxu(*a,
                                                                      **k))
    with jfir.kernel_mode("interpret"):
        jy, _ = jfir.fir_overlap_save(g, _j(x, "float32"),
                                      _j(tail, "float32"), stride=d,
                                      offset=offset)
    want = jcplx.to_numpy(jy)
    n = (b - offset - 1) // d + 1
    got = _np(TC.fir_mxu_split(x, _taps(g), d, offset - (t - 1), n, 0, tail,
                               passes=TC.passes_for(x.re.dtype, False)))
    assert len(calls) == 1 and calls[0] >= 0
    assert got.shape == want.shape == (c, n)
    assert np.abs(got - want).max() < FIR_REL * np.abs(want).max()


@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(67, 4), (143, 80)])
def test_k5_split_chunks_and_plain(t, d, dtype, chunks):
    """K5's split at 'high' over its window forms: starts 1 - T, 2 - T and
    D - T in the tail with wrap 0 and an odd output count (fir_offset at
    offsets 0, 1 and D - 1), 0 with wrap 0 (offset T - 1), and 0, D and
    2D + 1 with wrap 128*D (fir_mxu), cut into K chunks: within the card's
    gate (1e-5 of the largest output) of the plain versions, and the
    offset form within 1e-6 of K = 1 (float32 round-off of the frame
    grid)."""
    c = 3
    b = 2 * 128 * d + 2
    x, tail, g, _ = _k1_mode_case(t, d, c, b, dtype)
    taps = _taps(g)
    passes = TC.passes_for(x.re.dtype, False)
    for off in (0, 1, d - 1, t - 1):
        n = (b - off - 1) // d + 1
        assert off > 1 or n % 2 == 1
        y = TC.fir_mxu_split(x, taps, d, off - (t - 1), n, 0, tail, passes,
                             chunks)
        ref = fir_offset_plain(x, taps, d, off, tail)
        scale = float(torch.maximum(ref.re.abs().max(), ref.im.abs().max()))
        assert y.re.shape == (c, n)
        assert float(max((y.re - ref.re).abs().max(),
                         (y.im - ref.im).abs().max())) < CARD_REL * scale
        one = TC.fir_mxu_split(x, taps, d, off - (t - 1), n, 0, tail, passes)
        assert float(max((y.re - one.re).abs().max(),
                         (y.im - one.im).abs().max())) < 1e-6 * scale
    xb = x[..., :2 * 128 * d]
    for s0 in (0, d, 2 * d + 1):
        y = TC.fir_mxu_split(xb, taps, d, s0, 2 * 128, 128 * d,
                             passes=passes, chunks=chunks)
        ref, _ = fir_mxu_plain(xb, taps, d, s0)
        scale = float(torch.maximum(ref.re.abs().max(), ref.im.abs().max()))
        assert float(max((y.re - ref.re).abs().max(),
                         (y.im - ref.im).abs().max())) < CARD_REL * scale
