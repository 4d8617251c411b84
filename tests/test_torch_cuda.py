"""The CUDA kernels of ``ops/fir_fm.py`` against their plain PyTorch
versions on the card.  Every test carries the ``cuda`` marker and skips
where there is no CUDA device (the kernels have no CPU mode); on the card
run ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
test configuration in tests/conftest.py imports JAX).

Bounds: FM: both versions compute in float32 with a different summation
order and share the atan2 polynomial, so on a constant-envelope FM input the
audio differs by ~1e-6 rad.  FIR, and AM/USB without the AGC: 1e-5 of the
largest output (float32 sums in two orders).  AGC: 1e-4 absolute on outputs
of ~0.1 and relative on the envelope (the envelope recurrence as a chunked
float32 scan against frame matmuls, both with lam's powers taken at full
precision, differ by float32 round-off).  An indexing or carry fault shows
as errors of order 1.
"""

import numpy as np
import pytest
import torch

import libsdr_tpu_torch as P
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops import (FIRFilter, FMDeemph, FMDemod, IQBaseBand,
                                  siggen)
from libsdr_tpu_torch.ops import fir_fm as F
from libsdr_tpu_torch.ops.fir_fm import fir_fm_exact, fir_fm_exact_plain
from libsdr_tpu_torch.tools import window_pack_times as WP

pytestmark = pytest.mark.cuda

FS = 960_000.0
ERR_BOUND = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _op(d, t, c, b, plane_dtype=None):
    rx = P.Pipeline([IQBaseBand(fc=FS / 8, width=min(FS / 4.8, 0.8 * FS / d),
                                order=t - d + 1, decim=d, design="textbook"),
                     FMDemod(), FMDeemph()])
    rx.bind(P.StreamSpec(np.complex64, FS, b, channels=(c,),
                         plane_dtype=plane_dtype))
    return rx.stages[0]


def _fm(c, b, d, k):
    dev = 0.15 * FS / d
    rows = [siggen.fm_modulate(
        FS, siggen.sine(FS, (k + 1) * b, 900.0 + 50 * ch, amps=1.0), dev,
        carrier=FS / 8 + 300.0 * ch)[k * b:] for ch in range(c)]
    return np.stack(rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("deemph", [True, False])
@pytest.mark.parametrize("d,t,c", [(2, 37, 3), (4, 67, 64), (8, 67, 5),
                                   (1, 9, 2), (5, 68, 3), (40, 71, 3),
                                   (100, 131, 3)])
def test_kernel_matches_plain(cuda, dtype, deemph, d, t, c):
    _fm_matches_plain(cuda, dtype, deemph, d, t, c)


@pytest.mark.parametrize("dtype,t", [(torch.float32, 12001),
                                     (torch.bfloat16, 14001)])
def test_staged_kernel_one_output_per_thread_matches_plain(cuda, dtype, t):
    """At D = 16 and these tap counts the staged kernel's segment fits in
    shared memory only at one output per thread (R = 1)."""
    _fm_matches_plain(cuda, dtype, True, 16, t, 3)


def _fm_matches_plain(cuda, dtype, deemph, d, t, c):
    b = d * (5 * 2048 + 777)
    op = _op(d, t, c, b, dtype)
    carry = op.init_carry(cuda)
    # block 0 warms the carry up through the plain version: the zero-history
    # start of the test signal can put the discriminator exactly on its
    # +-pi branch cut, where the two versions may round to opposite sides
    for k in range(4):
        x = _fm(c, b, d, k)
        x = Complex(torch.tensor(x.real, device=cuda).to(dtype),
                    torch.tensor(x.imag, device=cuda).to(dtype))
        args = (x, op._taps(cuda), d, carry[0], carry[1], op._rot, op._gain)
        kw = dict(deemph_ab=op._dab if deemph else None,
                  dstate=carry[2] if deemph else None)
        ref, y_ref = fir_fm_exact_plain(*args, **kw)
        if k == 0:
            out, y_last = ref, y_ref
        else:
            n0 = fir_fm_exact.launches
            out, y_last = fir_fm_exact(*args, **kw)
            assert fir_fm_exact.launches == n0 + 1
        torch.cuda.synchronize()
        assert out.shape == (c, b // d) and bool(torch.isfinite(out).all())
        assert float((out - ref).abs().max()) < ERR_BOUND
        assert float((y_last.re - y_ref.re).abs().max()) < ERR_BOUND
        tail = x[..., b - (t - 1):].map(torch.clone)
        carry = (tail, y_last, out[..., -1] if deemph else carry[2])


def test_kernel_refuses_what_it_does_not_take(cuda):
    op = _op(4, 67, 2, 4096)
    carry = op.init_carry(cuda)
    x = Complex(torch.zeros(2, 8192, device=cuda)[:, ::2],
                torch.zeros(2, 4096, device=cuda))
    with pytest.raises(ValueError):
        fir_fm_exact(x, op._taps(cuda), 4, carry[0], carry[1], op._rot, 1.0)
    x = Complex(torch.zeros(2, 4096, device=cuda, dtype=torch.float64),
                torch.zeros(2, 4096, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        fir_fm_exact(x, op._taps(cuda), 4, carry[0], carry[1], op._rot, 1.0)
    # outside the shared-memory gate: the warp kernel's taps (8*T bytes,
    # D > 40) and the staged kernel's segment (D <= 40) above 227 KB
    for d in (512, 4):
        x = Complex(torch.zeros(2, 4 * d, device=cuda),
                    torch.zeros(2, 4 * d, device=cuda))
        taps = Complex(torch.zeros(40_000, device=cuda),
                       torch.zeros(40_000, device=cuda))
        tail = Complex(torch.zeros(2, 39_999, device=cuda),
                       torch.zeros(2, 39_999, device=cuda))
        with pytest.raises(ValueError, match="gate"):
            fir_fm_exact(x, taps, d, tail, carry[1], op._rot, 1.0)


def test_pipeline_on_card_matches_cpu(cuda):
    rx = P.Pipeline([IQBaseBand(fc=FS / 8, width=FS / 4.8, order=64,
                                decim=4, design="textbook"),
                     FMDemod(), FMDeemph()])
    rx.bind(P.StreamSpec(np.complex64, FS, 16384, channels=(4,)))
    cg, cc = rx.init_carry(cuda), rx.init_carry("cpu")
    for k in range(3):
        x = _fm(4, 16384, 4, k)
        n0 = fir_fm_exact.launches
        cg, yg = rx.apply(cg, Complex(torch.tensor(x.real, device=cuda),
                                      torch.tensor(x.imag, device=cuda)))
        assert fir_fm_exact.launches == n0 + 1
        cc, yc = rx.apply(cc, Complex(torch.tensor(x.real),
                                      torch.tensor(x.imag)))
        assert float((yg.cpu() - yc).abs().max()) < ERR_BOUND


def _noise(gen, shape, dtype, dev):
    return Complex(torch.randn(shape, generator=gen, device=dev).to(dtype),
                   torch.randn(shape, generator=gen, device=dev).to(dtype))


def _mode_err(got, ref, agc):
    """The error under the mode's bound (see the module docstring)."""
    if isinstance(got, Complex):
        scale = float(torch.maximum(ref.re.abs().max(), ref.im.abs().max()))
        return max(float((got.re - ref.re).abs().max()),
                   float((got.im - ref.im).abs().max())) / scale, 1e-5
    (out, sd), (rout, rsd) = got, ref
    assert bool(torch.isfinite(out).all())
    if not agc:
        return float((out - rout).abs().max()) / float(rout.abs().max()), 1e-5
    return max(float((out - rout).abs().max()),
               float(((sd - rsd) / rsd).abs().max())), 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,agc", [("fir", False), ("am", False),
                                      ("am", True), ("usb", False),
                                      ("usb", True)])
@pytest.mark.parametrize("d,t,c", [(2, 37, 3), (4, 67, 64), (40, 71, 1),
                                   (80, 143, 64), (100, 131, 1),
                                   (200, 263, 3), (256, 512, 2)])
def test_mode_kernels_match_plain(cuda, dtype, mode, agc, d, t, c):
    """K1b/K1c/K1d over a warm block and three carry-chained blocks; the
    AGC runs in K > 1 chunks (asserted)."""
    from libsdr_tpu_torch import _build

    gen = torch.Generator(device=cuda)
    gen.manual_seed(1000 * d + t)
    n_out = 3 * 4096 + 333
    b = d * n_out
    if agc:
        assert _build.library().sdr_agc_chunks(c, n_out) > 1
    taps = Complex(torch.randn(t, generator=gen, device=cuda) / t ** 0.5,
                   torch.randn(t, generator=gen, device=cuda) / t ** 0.5)
    th = 0.01 * d * np.arange(n_out)
    ramp = Complex(torch.tensor(np.cos(th), dtype=torch.float32, device=cuda),
                   torch.tensor(-np.sin(th), dtype=torch.float32,
                                device=cuda))
    ph = Complex(torch.tensor(0.6, device=cuda), torch.tensor(0.8,
                                                              device=cuda))
    lam = float(np.exp(-1.0 / (0.1 * FS / d)))
    ab, gain = ((lam, 1 - lam), 0.125) if agc else (None, 1.0)
    sd = torch.full((c,), 0.5, device=cuda)
    tail = _noise(gen, (c, t - 1), dtype, cuda)
    entry = {"fir": F.fir_exact, "am": F.fir_am_exact,
             "usb": F.fir_usb_exact}[mode]
    plain = getattr(F, entry.__name__ + "_plain")
    for k in range(4):
        x = _noise(gen, (c, b), dtype, cuda)
        args = {"fir": (x, taps, d, tail),
                "am": (x, taps, d, tail, gain, ab, sd),
                "usb": (x, taps, d, tail, ph, ramp, gain, ab, sd)}[mode]
        n0 = entry.launches
        got = entry(*args)
        assert entry.launches == n0 + 1
        ref = plain(*args)
        torch.cuda.synchronize()
        if k:  # block 0 warms the carries up
            err, bound = _mode_err(got, ref, agc)
            assert err < bound, (k, err)
        if agc:
            sd = ref[1]
        tail = x[..., b - (t - 1):].map(torch.clone)


def test_mode_kernels_refuse_what_they_do_not_take(cuda):
    """A shape outside the gate raises ValueError and launches nothing: the
    warp kernel's taps (8*T bytes) above the card's shared memory, and the
    staged kernel's segment likewise."""
    for d, t in ((64, 40_000), (4, 40_000)):
        x = Complex(torch.zeros(2, 4 * d, device=cuda),
                    torch.zeros(2, 4 * d, device=cuda))
        taps = Complex(torch.zeros(t, device=cuda),
                       torch.zeros(t, device=cuda))
        tail = Complex(torch.zeros(2, t - 1, device=cuda),
                       torch.zeros(2, t - 1, device=cuda))
        for entry, extra in ((F.fir_exact, ()), (F.fir_am_exact, (1.0,))):
            n0 = entry.launches
            with pytest.raises(ValueError, match="gate"):
                entry(x, taps, d, tail, *extra)
            assert entry.launches == n0
    x = Complex(torch.zeros(2, 4096, device=cuda, dtype=torch.float64),
                torch.zeros(2, 4096, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        F.fir_exact(x, taps, 4, tail)


@pytest.mark.parametrize("mode", ["AM", "USB", "LSB"])
def test_fused_ops_one_launch_per_block_match_cpu(cuda, mode):
    """The rx chains' fused ops on the card: exactly one kernel call per
    block, and the CPU's plain result within the AGC bound."""
    from libsdr_tpu_torch.apps.chains import rx_stages

    rx = P.Pipeline(rx_stages(mode, 960e3, 120e3))
    rx.bind(P.StreamSpec(np.complex64, 960e3, 96_000, channels=(3,)))
    op = rx.stages[0]
    entry = F.fir_am_exact if mode == "AM" else F.fir_usb_exact
    cg, cc = rx.init_carry(cuda), rx.init_carry("cpu")
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = (rng.normal(size=(3, 96_000))
             + 1j * rng.normal(size=(3, 96_000))).astype(np.complex64)
        n0 = entry.launches
        cg, yg = rx.apply(cg, Complex(torch.tensor(x.real, device=cuda),
                                      torch.tensor(x.imag, device=cuda)))
        assert entry.launches == n0 + 1
        cc, yc = rx.apply(cc, Complex(torch.tensor(x.real),
                                      torch.tensor(x.imag)))
        assert float((yg.cpu() - yc).abs().max()) < 1e-4
    assert type(op).__name__ in ("AMBasebandFused", "USBBasebandFused")


@pytest.mark.parametrize("decim", [4, 1])
def test_real_fir_filter_on_card_matches_cpu(cuda, decim):
    """A real FIRFilter (the FM chains' audio decimator) on a real stream:
    its taps live on the card and the block runs the plain correlation."""
    f = FIRFilter(order=33, kind="lowpass", fu=4000.0, decim=decim)
    f.bind(P.StreamSpec(np.float32, 48_000.0, 4800, channels=(2,)))
    cg, cc = f.init_carry(cuda), f.init_carry("cpu")
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = rng.normal(size=(2, 4800)).astype(np.float32)
        cg, yg = f.apply(cg, torch.tensor(x, device=cuda))
        cc, yc = f.apply(cc, torch.tensor(x))
        assert float((yg.cpu() - yc).abs().max()) < 1e-5


def test_fir_overlap_save_one_launch_per_block(cuda):
    """The DDC chain (an unfused IQBaseBand): fir_overlap_save sends each
    block to fir_exact once, and matches the CPU's plain result."""
    rx = P.Pipeline([IQBaseBand(fc=FS / 8, width=FS / 4.8, order=64,
                                decim=4, design="textbook")])
    rx.bind(P.StreamSpec(np.complex64, FS, 16384, channels=(4,)))
    cg, cc = rx.init_carry(cuda), rx.init_carry("cpu")
    rng = np.random.default_rng(6)
    for _ in range(3):
        x = (rng.normal(size=(4, 16384))
             + 1j * rng.normal(size=(4, 16384))).astype(np.complex64)
        n0 = F.fir_exact.launches
        cg, yg = rx.apply(cg, Complex(torch.tensor(x.real, device=cuda),
                                      torch.tensor(x.imag, device=cuda)))
        assert F.fir_exact.launches == n0 + 1
        cc, yc = rx.apply(cc, Complex(torch.tensor(x.real),
                                      torch.tensor(x.imag)))
        scale = float(yc.abs().max())
        assert float((yg.re.cpu() - yc.re).abs().max()) / scale < 1e-5
        assert float((yg.im.cpu() - yc.im).abs().max()) / scale < 1e-5


# -- the digital receive path: K1e (mode afsk) and the bit-sync PLL --------
#
# K1e against its plain version: disc within 1e-4 of each channel's largest
# |disc| (float32 FIR sums in two orders move y by ~1e-6 relative, the
# discriminator by ~1e-6 rad, and both sum each window oldest first); the
# symbols equal wherever |disc| is above that bound; the carried products
# (audio times a unit template) within the discriminator's bound ERR_BOUND.
# The PLL is bit-exact.

def _afsk_op(d, ell, c, b, plane_dtype=None):
    """The fused AFSK op at stride d with window ell: the tone rate is
    chosen so that int(audio_fs / baud) == ell."""
    from libsdr_tpu_torch.ops import FSKDetector
    from libsdr_tpu_torch.ops.afsk_fused import AFSKFrontendFused

    audio_fs = FS / d
    rx = P.Pipeline([IQBaseBand(fc=FS / 8, width=min(FS / 4.8, 0.8 * FS / d),
                                order=48, decim=d, design="textbook"),
                     FMDemod(), FSKDetector(audio_fs / (ell + 0.5),
                                            0.05 * audio_fs,
                                            0.09 * audio_fs)])
    rx.bind(P.StreamSpec(np.complex64, FS, b, channels=(c,),
                         plane_dtype=plane_dtype))
    op = rx.stages[0]
    assert isinstance(op, AFSKFrontendFused) and op.corr_len == ell
    return op


def _afsk_args(op, x, carry):
    tail, prev, n0, um, us = carry
    dev = x.re.device
    return (x, op._taps(dev), op._decim, tail, prev, op._rot, op._gain,
            op._on("mark", op._tones[0], dev),
            op._on("space", op._tones[1], dev), n0, um, us)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,ell,c", [(4, 40, 64), (2, 2, 3), (5, 20, 1),
                                     (10, 20, 3), (40, 128, 3),
                                     (100, 40, 3), (4, 256, 2), (1, 20, 2),
                                     (1, 2, 3), (16, 40, 3), (24, 40, 3)])
def test_afsk_kernel_matches_plain(cuda, dtype, d, ell, c):
    """K1e over a warm block and three carry-chained blocks, each long
    enough for several chunks per channel, on each side of the
    tensor-core route's cut (csrc/fir_common.cuh: strides 2-16, 2-40 with
    bfloat16 planes; D = 1, 24 and 40 with float32 planes on the staged
    kernel, 100 on the warp kernel)."""
    n_out = 3 * 4096 + 333
    b = d * n_out
    op = _afsk_op(d, ell, c, b, dtype)
    carry = op.init_carry(cuda)
    t = op._t
    for k in range(4):
        x = _fm(c, b, d, k)
        x = Complex(torch.tensor(x.real, device=cuda).to(dtype),
                    torch.tensor(x.imag, device=cuda).to(dtype))
        args = _afsk_args(op, x, carry)
        ref = F.fir_afsk_exact_plain(*args)
        n0 = F.fir_afsk_exact.launches
        got = F.fir_afsk_exact(*args)
        assert F.fir_afsk_exact.launches == n0 + 1
        torch.cuda.synchronize()
        disc, y_last, um, us = got
        rdisc, ry, rum, rus = ref
        assert disc.shape == (c, n_out) and bool(torch.isfinite(disc).all())
        if k:  # block 0 warms the carry up
            bound = 1e-4 * rdisc.abs().amax(dim=1, keepdim=True)
            assert bool(((disc - rdisc).abs() <= bound).all()), k
            clear = rdisc.abs() > bound
            assert bool(((disc > 0) == (rdisc > 0))[clear].all())
            for a, r in ((um, rum), (us, rus)):
                for pa, pr in ((a.re, r.re), (a.im, r.im)):
                    assert float((pa - pr).abs().max()) < ERR_BOUND
            assert float((y_last.re - ry.re).abs().max()) < 1e-4
        carry = (x[..., b - (t - 1):].map(torch.clone), ry,
                 (carry[2] + n_out) % ell, rum, rus)


def _pll_inputs(rng, m, t, run):
    """Symbols in runs of about ``run`` steps (bit-like) with flips."""
    sym = np.repeat(rng.integers(0, 2, (m, t // run + 2)), run, axis=1)
    flips = rng.random((m, sym.shape[1])) < 0.02
    return (sym ^ flips)[:, :t].astype(np.uint8)


@pytest.mark.parametrize("mode", ["normal", "transition"])
@pytest.mark.parametrize("ell", [2, 20, 40, 264, 512, 896])
@pytest.mark.parametrize("m", [1, 33, 64, 256, 528, 1000, 4096, 16384])
def test_pll_kernel_matches_plain(cuda, mode, ell, m):
    """K2 bit-exact against its plain version over chained blocks, with the
    real +-0.5% bounds and with bounds widened to 0.5-2x omega0 (where a
    nudge rounded twice would show); block lengths 2048, 2056, 1, 31 and 33
    (whole and part mask words), then a block with no emit (omega started
    at 2% of omega0, bounds 1-200%) and one with omega started at 3x
    omega0, above its bound (the clamp of the block's first step).  M on both sides of the lane cut
    (csrc/bitsync.cu's lanes per warp: 1 up to 1,056 lanes, 4 at 4,096, 16
    at 16,384); one launch a call, counted under its layout."""
    from libsdr_tpu_torch.ops.pll import lanes_per_warp, pll, pll_plain

    rng = np.random.default_rng(ell * 1000 + m)
    om0 = 1.0 / ell
    lanes = lanes_per_warp(m)
    for lo, hi, ts, start in ((0.995, 1.005, (2048, 1, 31, 33), 1.0),
                              (0.5, 2.0, (2056, 2056), 1.0),
                              (0.01, 2.0, (33,), 0.02),
                              (0.995, 1.005, (96,), 3.0)):
        kw = dict(omega_min=om0 * lo, omega_max=om0 * hi, gain=0.0005,
                  transition=mode == "transition")
        st = [torch.zeros(m, ell - 1, dtype=torch.int32),
              torch.zeros(m, dtype=torch.int32), torch.zeros(m),
              torch.full((m,), om0 * start),
              torch.from_numpy(rng.integers(0, 1 << 16, m, dtype=np.int32))]
        sg = [v.to(cuda) for v in st]
        for t in ts:
            sym = torch.from_numpy(_pll_inputs(rng, m, t, max(1, ell)))
            n0, r0 = pll.launches, pll.routes[lanes]
            got = pll(sym.to(cuda), *sg, **kw)
            assert pll.launches == n0 + 1 and pll.routes[lanes] == r0 + 1
            ref = pll_plain(sym, *st, **kw)
            torch.cuda.synchronize()
            for a, r in zip(got, ref):
                assert torch.equal(a.cpu(), r), (lo, t)
            if start < 1:
                assert int((ref[0] >> 1).sum()) == 0, "a block with no emit"
            st, sg = list(ref[1:]), list(got[1:])


@pytest.mark.parametrize("lanes", [1, 2, 8, 32])
def test_pll_bank_mixes_three_configurations(cuda, lanes):
    """K3 bit-exact against its plain version on a bank of the mode bank's
    three BitStream configurations (L = 20 normal, 20 transition, 264
    normal) over two chained blocks, and lane by lane equal to K2 run with
    each configuration; the bank's size (128, 2,000, 8,000 and 17,000
    lanes) puts the serial pass at 1, 2, 8 and 32 lanes a warp."""
    from libsdr_tpu_torch.ops.pll import (lanes_per_warp, pll, pll_bank,
                                          pll_bank_plain)

    rng = np.random.default_rng(3)
    n = {1: 40, 2: 664, 8: 2664, 32: 5664}[lanes]    # lanes of the last two
    cfg = [(20, 0, n + 8), (20, 1, n), (264, 0, n)]   # (L, transition, lanes)
    ells = np.concatenate([np.full(n, e, np.int32) for e, _, n in cfg])
    trans = np.concatenate([np.full(n, tr, np.int32) for _, tr, n in cfg])
    om0 = (1.0 / ells).astype(np.float32)
    kw = dict(omega_min=om0 * 0.995, omega_max=om0 * 1.005,
              gain=np.full(len(ells), 0.0005, np.float32), transition=trans,
              ell=ells)
    m, r, t = len(ells), 263, 4096
    st = [torch.zeros(m, r, dtype=torch.int32),
          torch.zeros(m, dtype=torch.int32), torch.zeros(m),
          torch.from_numpy(om0), torch.zeros(m, dtype=torch.int32)]
    sg = [v.to(cuda) for v in st]
    syms = [torch.from_numpy(_pll_inputs(rng, m, t, 20)) for _ in range(2)]
    want = lanes_per_warp(m)
    assert want == lanes, (m, want)
    for sym in syms:
        n0, r0 = pll_bank.launches, pll_bank.routes[want]
        got = pll_bank(sym.to(cuda), *sg, **kw)
        assert pll_bank.launches == n0 + 1
        assert pll_bank.routes[want] == r0 + 1
        ref = pll_bank_plain(sym, *st, **kw)
        torch.cuda.synchronize()
        for a, b_ in zip(got, ref):
            assert torch.equal(a.cpu(), b_)
        st, sg = list(ref[1:]), list(got[1:])
    # lane by lane: each group through K2 with its own configuration
    off = 0
    for ell, tr, n in cfg:
        sl = slice(off, off + n)
        g = [torch.zeros(n, ell - 1, dtype=torch.int32, device=cuda),
             torch.zeros(n, dtype=torch.int32, device=cuda),
             torch.zeros(n, device=cuda),
             torch.full((n,), float(om0[off]), device=cuda),
             torch.zeros(n, dtype=torch.int32, device=cuda)]
        for sym in syms:
            out, *g = pll(sym[sl].to(cuda), *g,
                          omega_min=float(kw["omega_min"][off]),
                          omega_max=float(kw["omega_max"][off]),
                          gain=0.0005, transition=bool(tr))
        assert torch.equal(out.cpu(), got[0][sl].cpu())
        assert torch.equal(g[0].cpu(), got[1][sl, r - (ell - 1):].cpu())
        off += n


def test_afsk_bank_decodes_on_card(cuda):
    """An FM-modulated AX.25 frame on 64 channels through the fused AFSK
    front end and the BitStream on the card: every channel decodes the
    frame that the CPU's plain versions decode."""
    from libsdr_tpu_torch.core.ragged import Ragged, compact
    from libsdr_tpu_torch.decode import AX25Decoder, ax25_frame_bits
    from libsdr_tpu_torch.ops import BitStream, FSKDetector
    from libsdr_tpu_torch.ops import fir_fm
    from libsdr_tpu_torch.ops.pll import pll

    fs, nch, blk = 96_000.0, 64, 8192
    info = b"!4903.50N/07201.75W-card"
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
    x = np.broadcast_to(iq, (nch, len(iq)))
    payloads = {}
    for dev in (cuda, torch.device("cpu")):
        p = P.Pipeline([IQBaseBand(fc=24e3, width=12.5e3, order=48,
                                   out_rate=48e3, design="textbook"),
                        FMDemod(), FSKDetector(1200.0, 1200.0, 2200.0),
                        BitStream(1200.0, mode="transition")])
        p.bind(P.StreamSpec(np.complex64, fs, blk, channels=(nch,)))
        c = p.init_carry(dev)
        n_fir, n_pll = fir_fm.fir_afsk_exact.launches, pll.launches
        ds, vs = [], []
        for i in range(x.shape[1] // blk):
            c, y = p.apply(c, Complex(
                torch.tensor(x[:, i * blk:(i + 1) * blk].real, device=dev),
                torch.tensor(x[:, i * blk:(i + 1) * blk].imag, device=dev)))
            ds.append(y.data.cpu().numpy())
            vs.append(y.valid.cpu().numpy())
        if dev.type == "cuda":
            k = x.shape[1] // blk
            assert fir_fm.fir_afsk_exact.launches == n_fir + k
            assert pll.launches == n_pll + k
        bits = compact(Ragged(np.concatenate(ds, -1), np.concatenate(vs, -1)))
        got = []
        for ch_bits in bits:
            dec = AX25Decoder()
            dec.process(ch_bits)
            got.append([m.payload for m in dec.messages])
        payloads[dev.type] = got
    assert all(g and g[0].endswith(info) for g in payloads["cuda"])
    assert payloads["cuda"] == payloads["cpu"]


def test_digital_kernels_refuse_what_they_do_not_take(cuda):
    """K1e's window outside 2..256 and the PLL's above 896 (the prefix sums
    its majority pass keeps) raise ValueError and launch nothing."""
    from libsdr_tpu_torch.ops.pll import MAX_WINDOW, pll, pll_bank

    op = _afsk_op(4, 40, 2, 4 * 8192)
    for ell in (1, 257):
        tone = Complex(torch.ones(ell, device=cuda),
                       torch.zeros(ell, device=cuda))
        tails = Complex(torch.zeros(2, max(ell - 1, 0), device=cuda),
                        torch.zeros(2, max(ell - 1, 0), device=cuda))
        tail, prev, n0, _, _ = op.init_carry(cuda)
        x = Complex(torch.zeros(2, 4 * 8192, device=cuda),
                    torch.zeros(2, 4 * 8192, device=cuda))
        n_before = F.fir_afsk_exact.launches
        with pytest.raises(ValueError, match="gate"):
            F.fir_afsk_exact(x, op._taps(cuda), 4, tail, prev, op._rot, 1.0,
                             tone, tone, n0, tails, tails)
        assert F.fir_afsk_exact.launches == n_before
    m, ell = 4, MAX_WINDOW + 1
    sym = torch.zeros((m, 64), dtype=torch.uint8, device=cuda)
    st = (torch.zeros((m, ell - 1), dtype=torch.int32, device=cuda),
          torch.zeros(m, dtype=torch.int32, device=cuda),
          torch.zeros(m, device=cuda), torch.full((m,), 1.0 / ell,
                                                   device=cuda),
          torch.zeros(m, dtype=torch.int32, device=cuda))
    n_before = pll.launches, pll_bank.launches
    with pytest.raises(ValueError, match="gate"):
        pll(sym, *st, omega_min=0.001, omega_max=0.002, gain=5e-4,
            transition=False)
    with pytest.raises(ValueError, match="windows"):
        pll_bank(sym, *st, omega_min=np.full(m, 0.001, np.float32),
                 omega_max=np.full(m, 0.002, np.float32),
                 gain=np.full(m, 5e-4, np.float32),
                 transition=np.zeros(m, np.int32),
                 ell=np.full(m, ell, np.int32))
    assert (pll.launches, pll_bank.launches) == n_before


# -- K4, the polyphase channelizer (ops/pfb.py, csrc/pfb.cu) -----------------
#
# Bounds, as the JAX package's own tests hold its kernel: Y within 2e-5 of
# the largest |Y| (float32 MAC and DFT in two orders: the kernel's FFT or
# direct sum against torch.fft); the demod's error median < 5e-5 and 99th
# percentile < 1e-3 rad (the angle of z = Y[t] conj(Y[t-1]) is amplified
# where |z| is near 0 on random data), the exports within 2e-5 of max |Y|.

# M 16, 64, 256 and 1024 at P = 8 take the stream route, every other case
# the generic one (ops/pfb.py::stream_route)
PFB_MS = (8, 16, 64, 128, 256, 384, 1000, 1024, 4096)


def _pfb_inputs(gen, c, f, m, p, dtype, dev):
    from libsdr_tpu_torch.ops.channelizer import (fold_commutator,
                                                  prototype_lowpass)

    def cn(*shape):
        return Complex(torch.randn(shape, generator=gen, device=dev),
                       torch.randn(shape, generator=gen, device=dev))
    x = cn(c, f, m).to(dtype)
    hist = cn(c, p, m).to(dtype)
    prev = cn(c, 1, m)
    taps = torch.from_numpy(fold_commutator(prototype_lowpass(m, p), m,
                                            p)).to(dev)
    return x, hist, prev, taps


def _pfb_errs(got, ref, demod, gain):
    """(Y or exports error of max |Y|, demod median, 99th pct, max)."""
    if not demod:
        scale = float(torch.maximum(ref.re.abs().max(), ref.im.abs().max()))
        return (max(float((got.re - ref.re).abs().max()),
                    float((got.im - ref.im).abs().max())) / scale,
                0.0, 0.0, 0.0)
    (a, yl, y0), (ra, ryl, ry0) = got, ref
    scale = max(float(ryl.re.abs().max()), float(ryl.im.abs().max()),
                float(ry0.re.abs().max()), float(ry0.im.abs().max()))
    ex = max(float((u - v).abs().max()) for u, v in (
        (yl.re, ryl.re), (yl.im, ryl.im), (y0.re, ry0.re), (y0.im, ry0.im)))
    half = np.pi * gain
    d = torch.remainder(a - ra + half, 2 * half) - half
    d = d.abs().flatten().double().cpu()
    return (ex / scale, float(d.median()), float(torch.quantile(
        d[:min(len(d), 1 << 24)], 0.99)), float(d.max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 8, 32])
@pytest.mark.parametrize("m", PFB_MS)
def test_pfb_kernel_matches_plain(cuda, m, p, dtype):
    """Both variants over F in {1, P-1, P, 33, 4096} and C in {1, 3}, each
    launch on the route its shape gives."""
    from libsdr_tpu_torch.ops.pfb import pfb_mxu, pfb_plain, stream_route

    route = "stream" if stream_route(m, p) else "generic"

    gen = torch.Generator(device=cuda)
    gen.manual_seed(m * 100 + p)
    for f in sorted({1, max(1, p - 1), p, 33, 4096}):
        for c in (1, 3):
            x, hist, prev, taps = _pfb_inputs(gen, c, f, m, p, dtype, cuda)
            for demod in (False, True):
                n0, r0 = pfb_mxu.launches, pfb_mxu.routes[route]
                got = pfb_mxu(x, hist, taps, m, gain=1.7, prev=prev,
                              demod=demod)
                assert pfb_mxu.launches == n0 + 1
                assert pfb_mxu.routes[route] == r0 + 1
                ref = pfb_plain(x, hist, taps, m, gain=1.7, prev=prev,
                                demod=demod)
                torch.cuda.synchronize()
                e, med, p99, _ = _pfb_errs(got, ref, demod, 1.7)
                assert e < 2e-5, (m, p, f, c, demod, e)
                assert med < 5e-5 and p99 < 1e-3, (m, p, f, c, med, p99)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [16, 256, 384, 1024])
def test_pfb_kernel_chained_blocks_equal_one_block(cuda, m, dtype):
    """Three carry-chained blocks (hist = the last P frames, prev = the
    y_last export) give what one block of all their frames gives."""
    from libsdr_tpu_torch.ops.pfb import pfb_mxu

    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    p, f = 8, 48
    x, hist, prev, taps = _pfb_inputs(gen, 2, 3 * f, m, p, dtype, cuda)
    one, _, _ = pfb_mxu(x, hist, taps, m, prev=prev, demod=True)
    y_one = pfb_mxu(x, hist, taps, m)
    outs, ys, h, pv = [], [], hist, prev
    for i in range(3):
        blk = x[:, i * f:(i + 1) * f, :]
        a, pv2, _ = pfb_mxu(blk, h, taps, m, prev=pv, demod=True)
        ys.append(pfb_mxu(blk, h, taps, m))
        outs.append(a)
        h, pv = blk[:, f - p:, :], pv2
    assert float((torch.cat(outs, 1) - one).abs().max()) < 1e-6
    assert float((torch.cat([y.re for y in ys], 1) - y_one.re).abs().max()
                 + (torch.cat([y.im for y in ys], 1)
                    - y_one.im).abs().max()) < 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [16, 64, 256, 1024])
def test_pfb_stream_route_matches_its_emulation(cuda, m, dtype):
    """The stream route against pfb_split (ops/pfb.py, the route's
    decomposition on the CPU) on the same inputs, both variants."""
    from libsdr_tpu_torch.ops.pfb import pfb_mxu, pfb_split

    gen = torch.Generator(device=cuda)
    gen.manual_seed(m)
    for f, c in ((5, 1), (300, 2)):
        x, hist, prev, taps = _pfb_inputs(gen, c, f, m, 8, dtype, cuda)
        for demod in (False, True):
            r0 = pfb_mxu.routes["stream"]
            got = pfb_mxu(x, hist, taps, m, gain=1.7, prev=prev, demod=demod)
            assert pfb_mxu.routes["stream"] == r0 + 1
            cpu = [v.to("cpu") for v in (x, hist, prev)]
            emu = pfb_split(cpu[0], cpu[1], taps.cpu(), m, gain=1.7,
                            prev=cpu[2], demod=demod, tt=37)
            if demod:
                got = (got[0].cpu(), got[1].to("cpu"), got[2].to("cpu"))
            else:
                got = got.to("cpu")
            e, med, p99, _ = _pfb_errs(got, emu, demod, 1.7)
            assert e < 2e-5, (m, f, c, demod, e)
            assert med < 5e-5 and p99 < 1e-3, (m, f, c, med, p99)


def test_pfb_route_is_the_shape_gate(cuda):
    """The C gate (sdr_pfb_route) and its Python mirror agree."""
    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.ops.pfb import stream_route

    lib = _build.library()
    for m in (1, 4, 8, 16, 32, 64, 128, 256, 384, 512, 1000, 1024, 2048,
              4096, 8192):
        for p in (1, 7, 8, 9, 32):
            assert bool(lib.sdr_pfb_route(m, p)) == stream_route(m, p), (m, p)


def test_pfb_kernel_refuses_what_it_does_not_take(cuda):
    from libsdr_tpu_torch.ops.pfb import pfb_mxu

    for m, p in ((8193, 8), (64, 33)):
        x = Complex(torch.zeros(4, m, device=cuda),
                    torch.zeros(4, m, device=cuda))
        hist = Complex(torch.zeros(p, m, device=cuda),
                       torch.zeros(p, m, device=cuda))
        n0 = pfb_mxu.launches
        with pytest.raises(ValueError, match="gate"):
            pfb_mxu(x, hist, np.zeros((p + 1, m), np.float32), m)
        assert pfb_mxu.launches == n0


@pytest.mark.parametrize("layout", ["lane", "channel"])
def test_wideband_ops_on_card_match_cpu(cuda, layout):
    """WidebandFM (one K4 launch a block) and the Channelizer over three
    blocks on the card against the same ops on the CPU."""
    from libsdr_tpu_torch.ops import Channelizer, WidebandFM
    from libsdr_tpu_torch.ops.pfb import pfb_mxu

    m, blk = 256, 256 * 40
    rng = np.random.default_rng(5)
    for op in (WidebandFM(m, 8, gain=0.7, layout=layout), Channelizer(m)):
        op.bind(P.StreamSpec(np.complex64, 1e6, blk))
        cg, cc = op.init_carry(cuda), op.init_carry("cpu")
        for _ in range(3):
            x = (rng.normal(size=blk) + 1j * rng.normal(size=blk)).astype(
                np.complex64)
            n0 = pfb_mxu.launches
            cg, yg = op.apply(cg, Complex(torch.tensor(x.real, device=cuda),
                                          torch.tensor(x.imag, device=cuda)))
            assert pfb_mxu.launches == n0 + 1
            cc, yc = op.apply(cc, Complex(torch.tensor(x.real),
                                          torch.tensor(x.imag)))
            if isinstance(yc, Complex):
                scale = float(yc.re.abs().max())
                err = max(float((yg.re.cpu() - yc.re).abs().max()),
                          float((yg.im.cpu() - yc.im).abs().max())) / scale
                assert err < 2e-5
            else:
                half = np.pi * 0.7
                d = (torch.remainder(yg.cpu() - yc + half, 2 * half)
                     - half).abs()
                assert float(d.median()) < 5e-5
                assert float(torch.quantile(d.flatten(), 0.99)) < 1e-3


@pytest.mark.parametrize("m,p,frames,kernel", [
    (16384, 8, 12, False), (64, 40, 48, False), (64, 40, 20, False),
    (8192, 8, 12, True), (64, 32, 48, True)])
def test_channelizer_outside_k4_gate_on_card(cuda, m, p, frames, kernel):
    """Channelizer and the sharded path's channelize_local outside K4's
    gate (M > 8192, P > 32) run channelize_segment on the card, with no K4
    launch, within 2e-5 of max |Y| of the CPU over three carried blocks;
    inside it (M = 8192, P = 32) one launch a block.  WidebandFM alike
    where a block holds P frames (its bind wants them)."""
    from libsdr_tpu_torch.ops import Channelizer, WidebandFM
    from libsdr_tpu_torch.ops.pfb import pfb_mxu
    from libsdr_tpu_torch.parallel import wideband as W

    blk = m * frames
    rng = np.random.default_rng(m + p + frames)
    ops = [Channelizer(m, p)]
    if frames >= p:     # WidebandFM's carry is a block's last P frames
        ops.append(WidebandFM(m, p, layout="channel"))
    for op in ops:
        op.bind(P.StreamSpec(np.complex64, 1e6, blk))
        cg, cc = op.init_carry(cuda), op.init_carry("cpu")
        for _ in range(3):
            x = (rng.normal(size=blk) + 1j * rng.normal(size=blk)).astype(
                np.complex64)
            xg = Complex(torch.tensor(x.real, device=cuda),
                         torch.tensor(x.imag, device=cuda))
            assert W.channelize_kernel_ok(xg, m, p) == kernel
            n0 = pfb_mxu.launches
            cg, yg = op.apply(cg, xg)
            torch.cuda.synchronize()
            assert pfb_mxu.launches == n0 + int(kernel)
            cc, yc = op.apply(cc, Complex(torch.tensor(x.real),
                                          torch.tensor(x.imag)))
            if isinstance(yc, Complex):
                assert yg.re.device.type == "cuda"
                scale = float(max(yc.re.abs().max(), yc.im.abs().max()))
                err = max(float((yg.re.cpu() - yc.re).abs().max()),
                          float((yg.im.cpu() - yc.im).abs().max())) / scale
                assert err < 2e-5, err
            else:
                d = (torch.remainder(yg.cpu() - yc + np.pi, 2 * np.pi)
                     - np.pi).abs()
                assert float(d.median()) < 5e-5
                assert float(torch.quantile(d.flatten(), 0.99)) < 1e-3


def test_wideband_apps_on_card_match_cpu(cuda):
    """The scanner and the multimode bank on the card decode what they
    decode on the CPU, launching K4 (and K2, or K3 and, through the PSK31
    group's IQBaseBand on its strided channel rows, K1b) once a block."""
    from libsdr_tpu_torch.apps import multimode, scanner
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops.pfb import pfb_mxu
    from libsdr_tpu_torch.ops.pll import pll, pll_bank
    from libsdr_tpu_torch.tools import wideband_signals as W

    m = 16
    plan = [(ch, W.page_iq(25_000.0, 300 + ch, f"CARD {ch}"), 50 * ch)
            for ch in (1, 6, 11)]
    band = cplx.to_numpy(W.upmix(plan, m, m * 30_000, "cpu"))
    n0 = pfb_mxu.launches, pll.launches
    got = scanner.scan(band, m * 25_000.0, m, device=cuda)
    assert pfb_mxu.launches - n0[0] == pll.launches - n0[1] > 0
    want = scanner.scan(band, m * 25_000.0, m, device="cpu")
    summary = [{ch: [(x.address, x.as_text()) for x in v]
                for ch, v in f.items()} for f in (got, want)]
    assert summary[0] == summary[1]
    for ch, _, _ in plan:
        assert summary[0][ch][0][0] == 300 + ch
    active = {2: "pocsag", 3: "ax25", 5: "rtty", 6: "psk31"}
    wide = cplx.to_numpy(W.mixed_band(active, 8, "cpu"))
    n0 = pfb_mxu.launches, pll_bank.launches, F.fir_exact.launches
    got = multimode.scan_multimode(wide, 8 * 24_000.0, 8, active,
                                   device=cuda)
    k = pfb_mxu.launches - n0[0]
    assert k > 0 and pll_bank.launches - n0[1] == k
    assert F.fir_exact.launches - n0[2] == k
    want = multimode.scan_multimode(wide, 8 * 24_000.0, 8, active,
                                    device="cpu")
    assert {ch: (mo, str(d)) for ch, (mo, d) in got.items()} == \
        {ch: (mo, str(d)) for ch, (mo, d) in want.items()}
    assert set(got) == set(active)


# -- the scanner's windowed compaction (csrc/window_pack.cu) ---------------

@pytest.mark.parametrize("case", WP.PARITY, ids=lambda c: c[0])
def test_window_pack_kernel_matches_plain(cuda, case):
    """The kernel bit for bit its plain version on PLL bytes with 2-3 valid
    items in a window (tools/window_pack_times.PARITY: the pager cell's
    shape, the scanner app's, T not a multiple of 16, every window of the
    vector route, a window of 3, sums past 255, an input off 16-byte
    alignment), on the route its shape takes, one launch a call."""
    from libsdr_tpu_torch.ops.pll import window_pack, window_pack_plain

    label, m, t, w, rows = case
    x, raw, r = WP.operands(m, t, rows, m * t + w, cuda)
    route = WP.route_of(t, w, rows != "offset")
    n, k = window_pack.launches, window_pack.routes[route]
    got = window_pack(x, w, rows=None if r is None else r.to(cuda))
    torch.cuda.synchronize()
    assert window_pack.launches == n + 1
    assert window_pack.routes[route] == k + 1
    assert torch.equal(got.cpu(), window_pack_plain(raw, w, r))


def test_scanner_step_compacts_in_one_launch(cuda, monkeypatch):
    """At the pager cell's shape (1024 channels, 2^26-sample blocks, w =
    16) one step launches window_pack once, on the vector route; at a
    small shape the step's packed and Ragged outputs are, byte for byte,
    the CPU's plain path on the PLL bytes the step made."""
    from libsdr_tpu_torch.ops.pll import window_pack, window_pack_plain
    from libsdr_tpu_torch.parallel import wideband as pwb

    def band(n, seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return Complex(torch.randn(n, generator=g, device=cuda),
                       torch.randn(n, generator=g, device=cuda))

    m, b = 1024, 1 << 26
    step, init, place = pwb.build_scanner_step(
        m, b, m * 25_000.0, compact_window=16, packed=True, device=cuda)
    c = init()
    x = place(band(b, 7))
    n, v = window_pack.launches, window_pack.routes["vector"]
    c, y = step(c, x)
    torch.cuda.synchronize()
    assert window_pack.launches == n + 1
    assert window_pack.routes["vector"] == v + 1
    assert tuple(y.shape) == (m, b // m // 16)
    del step, c, x, y
    torch.cuda.empty_cache()

    calls = []

    def spy(raw, w, rows=None):
        calls.append((raw.clone(), w, rows))
        return window_pack(raw, w, rows=rows)
    monkeypatch.setattr(pwb, "window_pack", spy)
    m, b = 256, 256 * 14_000
    x = band(b, 8)
    for packed in (True, False):
        step, init, place = pwb.build_scanner_step(
            m, b, m * 24_000.0, compact_window=16, packed=packed,
            device=cuda)
        _, y = step(init(), place(x))
        raw, w, rows = calls.pop()
        want = window_pack_plain(raw.cpu(), w, rows.cpu())
        if packed:
            assert torch.equal(y.cpu(), want)
        else:
            assert torch.equal(y.data.cpu(), want & 1)
            assert torch.equal(y.valid.cpu(), want >= 2)


# -- slice 5: the v1 FIR (K5) and its FM/AM epilogues (K6) -----------------

def _fm_bank(gen, c, b, d, t, dtype, dev):
    """(c, b) FM tones near FS/8 with noise, generated on the card, and a
    T-tap band-pass around them with the rotation that takes their carrier
    out of the discriminator: a constant envelope inside the pass band
    keeps y away from 0 and the audio well inside (-pi, pi), where the two
    versions' float32 round-off would turn into angle."""
    from libsdr_tpu_torch.ops import firdesign

    n = torch.arange(b, dtype=torch.float64, device=dev)
    ch = torch.arange(c, dtype=torch.float64, device=dev)[:, None]
    fc = FS / 8 + (ch % 7 - 3) * 0.01 * FS / d
    fm = 1000.0 + 100.0 * (ch % 5)
    ph = torch.remainder(2 * np.pi * fc / FS * n - 0.15 * FS / d / fm
                         * torch.cos(2 * np.pi * fm / FS * n), 2 * np.pi)
    x = Complex(torch.cos(ph).float(), torch.sin(ph).float())
    x = x + _noise(gen, (c, b), torch.float32, dev) * 0.05
    g = firdesign.complex_bandpass(t, FS / 8, min(FS / 4.8, 0.8 * FS / d), FS)
    taps = Complex(torch.tensor(g.real, dtype=torch.float32, device=dev),
                   torch.tensor(g.imag, dtype=torch.float32, device=dev))
    return x.to(dtype), taps, np.exp(-2j * np.pi * d / 8)


# (D, T): the staged kernel's strides in every mode, the warp kernel's in
# modes fir/am (D > 16) and fm (D > 40), the rx app's 100 and 200
MXU_SHAPES = [(2, 37), (4, 67), (16, 67), (40, 71), (100, 131), (200, 263)]


def _mxu_cases():
    for dtype in (torch.float32, torch.bfloat16):
        for i, (d, t) in enumerate(MXU_SHAPES):
            for j, s0 in enumerate(sorted({0, 1, max(0, d - 2), d - 1, d,
                                           2 * d + 1})):
                yield dtype, d, t, s0, (1, 3, 64)[(i + j) % 3]


@pytest.mark.parametrize("dtype,d,t,s0,c", list(_mxu_cases()))
def test_mxu_kernels_match_plain(cuda, dtype, d, t, s0, c):
    """K5 and K6 (fm +- de-emphasis, am +- the AGC, with (lam, 1 - lam) and
    with a b of its own) against their plain versions: every output, the
    clamped last frame included, and the AGC's exported state; nonzero
    y[-1] and IIR states; chunks K > 1 at every stride."""
    from libsdr_tpu_torch.ops import fir_mxu as M

    gen = torch.Generator(device=cuda)
    gen.manual_seed(100 * d + s0)
    b = 80 * 128 * d   # 10,240 outputs a channel
    assert M.mxu_fir_supported(t, d, s0, c, b, dtype)
    taps = Complex(torch.randn(t, generator=gen, device=cuda) / t ** 0.5,
                   torch.randn(t, generator=gen, device=cuda) / t ** 0.5)
    x = _noise(gen, (c, b), dtype, cuda)
    n0 = M.fir_mxu.launches
    (y, nsp), (ry, rnsp) = (M.fir_mxu(x, taps, d, s0),
                            M.fir_mxu_plain(x, taps, d, s0))
    assert M.fir_mxu.launches == n0 + 1 and nsp == rnsp == 128
    err, bound = _mode_err(y, ry, False)
    assert y.re.shape == (c, b // d) and err < bound, err
    lead = Complex(torch.full((c, 1), 0.6, device=cuda),
                   torch.full((c, 1), -0.8, device=cuda))
    state = torch.full((c, 1), 0.4, device=cuda)
    lam = float(np.exp(-1.0 / (0.1 * FS / d)))
    fm, fm_taps, rot = _fm_bank(gen, c, b, d, t, dtype, cuda)
    for mode, xin, g, ab, gain in (("fm", fm, fm_taps, None, 1.3),
                                   ("fm", fm, fm_taps, (0.95, 0.05), 1.3),
                                   ("am", x, taps, None, 1.0),
                                   ("am", x, taps, (lam, 1 - lam), 0.125),
                                   ("am", x, taps, (0.9, 0.2), 0.125)):
        args = (xin, g, d, s0, lead, rot, gain, ab,
                None if ab is None else state, mode)
        n0 = M.fir_fm_mxu.launches
        got, ref = M.fir_fm_mxu(*args), M.fir_fm_mxu_plain(*args)
        torch.cuda.synchronize()
        assert M.fir_fm_mxu.launches == n0 + 1 and len(got) == len(ref)
        out, rout = got[0], ref[0]
        assert out.shape == (c, b // d) and bool(torch.isfinite(out).all())
        if mode == "fm":
            assert float((out - rout).abs().max()) < ERR_BOUND, (mode, ab)
        elif ab is None:
            assert float((out - rout).abs().max()) / float(
                rout.abs().max()) < 1e-5
        else:
            assert float((out - rout).abs().max()) < 1e-4, (mode, ab)
            assert float(((got[1] - ref[1]) / ref[1]).abs().max()) < 1e-4


# K5 at K1b's window start: (D, T) where both stay off the tensor-core
# route with either plane dtype (D = 1, below every cut; D = 200, above
# mode fir's; T = 3,228 at the DDC bank's D = 4, where no tensor-core plan
# fits), and where both take it (D = 2, 4, 40; K5 has mode fir's cut)
K5_AT_K1B_OFF_TC = [(1, 33), (4, 3228), (200, 263)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,t", [(2, 37), (4, 67), (40, 71), (200, 263),
                                 (1, 33), (4, 3228)])
def test_k5_at_k1b_window_start_is_k1b(cuda, dtype, d, t):
    """K5 in its overlap-save form at offset stride - 1 starts K1b's windows
    and takes K1b's route at every shape (K1b's own cut, its chunks and,
    on the tensor-core route, its passes), so it gives K1b's output bit
    for bit: on the tensor-core route at K1b's cut, on the staged or warp
    kernel at K5_AT_K1B_OFF_TC.  Both within the FIR gate of the module
    docstring of K1b's plain version."""
    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.ops import fir_mxu as M

    gen = torch.Generator(device=cuda)
    gen.manual_seed(d + t)
    taps = Complex(torch.randn(t, generator=gen, device=cuda),
                   torch.randn(t, generator=gen, device=cuda))
    x = _noise(gen, (3, d * 9000), dtype, cuda)
    tail = _noise(gen, (3, t - 1), dtype, cuda)
    _, route = F._chunks("K1b", _build.library(), F._MODE_FIR, 3, 9000, t, d,
                         0, x.re)
    assert (route == "tc") == ((d, t) not in K5_AT_K1B_OFF_TC), route
    n0, m0 = dict(F.fir_exact.routes), dict(M.fir_mxu.routes)
    a, b = M.fir_offset(x, taps, d, d - 1, tail), F.fir_exact(x, taps, d,
                                                               tail)
    assert F.fir_exact.routes[route] == n0[route] + 1
    assert M.fir_mxu.routes[route] == m0[route] + 1
    assert torch.equal(a.re, b.re) and torch.equal(a.im, b.im)
    err, bound = _mode_err(b, F.fir_exact_plain(x, taps, d, tail), False)
    assert err < bound, err


@pytest.mark.parametrize("offset", [0, 1, 4, 9, 100])
def test_fir_overlap_save_any_offset_launches_k5(cuda, offset, monkeypatch):
    """On the card fir_overlap_save with offset != stride - 1 launches K5
    once a block and no conv1d over the block, carry-chained over three
    blocks; it matches the CPU's plain result."""
    from libsdr_tpu_torch.ops import fir_mxu as M
    from libsdr_tpu_torch.ops.fir import fir_overlap_save

    convs = []
    real_conv = torch.nn.functional.conv1d

    def counted(*a, **kw):
        convs.append(a[0].shape)
        return real_conv(*a, **kw)

    rng = np.random.default_rng(offset)
    c, d, t, b = 64, 4, 67, 16384
    g = rng.normal(size=t) + 1j * rng.normal(size=t)
    tg = Complex(torch.zeros(c, t - 1, device=cuda),
                 torch.zeros(c, t - 1, device=cuda))
    tc = Complex(torch.zeros(c, t - 1), torch.zeros(c, t - 1))
    for _ in range(3):
        x = (rng.normal(size=(c, b)) + 1j * rng.normal(size=(c, b))
             ).astype(np.complex64)
        n0 = M.fir_mxu.launches
        monkeypatch.setattr(torch.nn.functional, "conv1d", counted)
        yg, tg = fir_overlap_save(g, Complex(torch.tensor(x.real, device=cuda),
                                             torch.tensor(x.imag,
                                                          device=cuda)),
                                  tg, stride=d, offset=offset)
        monkeypatch.setattr(torch.nn.functional, "conv1d", real_conv)
        assert M.fir_mxu.launches == n0 + 1 and not convs
        yc, tc = fir_overlap_save(g, Complex(torch.tensor(x.real),
                                             torch.tensor(x.imag)),
                                  tc, stride=d, offset=offset)
        assert yg.re.shape == yc.re.shape == (c, (b - offset - 1) // d + 1)
        scale = float(yc.abs().max())
        assert float((yg.re.cpu() - yc.re).abs().max()) / scale < 1e-5
        assert float((yg.im.cpu() - yc.im).abs().max()) / scale < 1e-5
        assert torch.equal(tg.re.cpu(), tc.re)


def test_mxu_entries_refuse_what_they_do_not_take(cuda):
    """fir_mxu and fir_fm_mxu raise ValueError naming the gate outside it
    and launch nothing: stride 1, a block that is not whole 128-output
    frames, windows reaching past one frame, more taps than shared memory
    holds, an unknown mode."""
    from libsdr_tpu_torch.ops import fir_mxu as M

    def planes(c, b):
        return Complex(torch.zeros(c, b, device=cuda),
                       torch.zeros(c, b, device=cuda))

    def taps(t):
        return Complex(torch.ones(t, device=cuda), torch.zeros(t, device=cuda))

    lead = Complex(torch.ones(2, 1, device=cuda), torch.zeros(2, 1,
                                                              device=cuda))
    n0 = M.fir_mxu.launches, M.fir_fm_mxu.launches
    for x, g, d, s0 in ((planes(2, 1024), taps(9), 1, 0),
                        (planes(2, 1000), taps(9), 4, 0),
                        (planes(2, 2048), taps(9), 4, 510),
                        (planes(2, 128 * 64 * 2), taps(4000), 64, 0)):
        with pytest.raises(ValueError, match="gate"):
            M.fir_mxu(x, g, d, s0)
        with pytest.raises(ValueError, match="gate"):
            M.fir_fm_mxu(x, g, d, s0, lead, 1.0, 1.0)
    with pytest.raises(ValueError, match="mode"):
        M.fir_fm_mxu(planes(2, 1024), taps(9), 4, 0, lead, 1.0, 1.0,
                     mode="usb")
    assert (M.fir_mxu.launches, M.fir_fm_mxu.launches) == n0


# The tensor-core route (csrc/fir_tc.cu): mode fm of K1a and modes fm and am
# of K6 at strides up to the cut, held against the split emulation of
# ops/fir_tc.py in the same passes (3 on float32 planes, 2 on bfloat16, 1
# after set_mxu_precision('fast')): the same bf16 products summed in
# another order, ~1e-6 apart, so an indexing or carry fault shows as an
# error of order 1; FM within SPLIT_FM rad, the rest within SPLIT_REL of
# the largest output.  At 'high' they are also held against the float32
# plain versions under the gates above.
SPLIT_FM = 1e-5
SPLIT_REL = 2e-6


def _precision(fast):
    from libsdr_tpu_torch.ops.fir import set_mxu_precision
    set_mxu_precision("fast" if fast else "high")


# the route's strides (csrc/fir_common.cuh::tc_stride): 4-16 with
# float32 planes, 4-40 with bfloat16
TC_K1A = [(dt, d, t, c) for dt in (torch.float32, torch.bfloat16)
          for d, t, c in ((4, 67, 64), (5, 68, 3), (8, 67, 5), (10, 41, 3),
                          (16, 47, 3))] + [
    (torch.bfloat16, 24, 55, 3), (torch.bfloat16, 40, 71, 3)]
TC_K6 = [(dt, d, t, s0, c) for dt in (torch.float32, torch.bfloat16)
         for d, t, s0, c in ((4, 67, 1, 64), (4, 67, 0, 3), (4, 67, 4, 1),
                             (8, 67, 9, 3), (16, 67, 9, 3))] + [
    (torch.bfloat16, 40, 71, 1, 3)]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("deemph", [True, False])
@pytest.mark.parametrize("dtype,d,t,c", TC_K1A)
def test_tc_kernel_matches_split_and_plain(cuda, dtype, deemph, fast, d, t,
                                           c):
    """K1a on the tensor-core route over a warm block and three
    carry-chained blocks of 11,017 outputs a channel (chunks K > 1, a
    ragged last tile): every output and y_last against the split
    emulation, and at 'high' against the plain version."""
    from libsdr_tpu_torch.ops import fir_tc as TC

    b = d * (5 * 2048 + 777)
    op = _op(d, t, c, b, dtype)
    carry = op.init_carry(cuda)
    passes = TC.passes_for(dtype, fast)
    try:
        _precision(fast)
        for k in range(4):
            x = _fm(c, b, d, k)
            x = Complex(torch.tensor(x.real, device=cuda).to(dtype),
                        torch.tensor(x.imag, device=cuda).to(dtype))
            args = (x, op._taps(cuda), d, carry[0], carry[1], op._rot,
                    op._gain)
            kw = dict(deemph_ab=op._dab if deemph else None,
                      dstate=carry[2] if deemph else None)
            emu, y_emu = TC.fm_exact_split(*args, **kw, passes=passes)
            if k == 0:
                out, y_last = emu, y_emu
            else:
                n0 = fir_fm_exact.routes["tc"]
                out, y_last = fir_fm_exact(*args, **kw)
                assert fir_fm_exact.routes["tc"] == n0 + 1
                torch.cuda.synchronize()
                assert bool(torch.isfinite(out).all())
                assert float((out - emu).abs().max()) < SPLIT_FM
                scale = float(y_emu.abs().max())
                assert float((y_last.re - y_emu.re).abs().max()) < \
                    SPLIT_REL * scale
                if not fast:
                    ref, y_ref = fir_fm_exact_plain(*args, **kw)
                    assert float((out - ref).abs().max()) < ERR_BOUND
                    assert float((y_last.re - y_ref.re).abs().max()) < \
                        ERR_BOUND
            tail = x[..., b - (t - 1):].map(torch.clone)
            carry = (tail, y_last, out[..., -1] if deemph else carry[2])
    finally:
        _precision(False)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype,d,t,s0,c", TC_K6)
def test_tc_k6_matches_split_and_plain(cuda, dtype, fast, d, t, s0, c):
    """K6 on the tensor-core route, fm +- de-emphasis and am +- the AGC
    ((lam, 1 - lam) and a b of its own), 80 frames of 128 outputs (K > 1,
    the clamped last frame): every output and the AGC's state against the
    split emulation, and at 'high' against the plain version."""
    from libsdr_tpu_torch.ops import fir_mxu as M
    from libsdr_tpu_torch.ops import fir_tc as TC

    gen = torch.Generator(device=cuda)
    gen.manual_seed(7 * d + s0)
    b = 80 * 128 * d
    taps = Complex(torch.randn(t, generator=gen, device=cuda) / t ** 0.5,
                   torch.randn(t, generator=gen, device=cuda) / t ** 0.5)
    x = _noise(gen, (c, b), dtype, cuda)
    fm, fm_taps, rot = _fm_bank(gen, c, b, d, t, dtype, cuda)
    lead = Complex(torch.full((c, 1), 0.6, device=cuda),
                   torch.full((c, 1), -0.8, device=cuda))
    state = torch.full((c, 1), 0.4, device=cuda)
    lam = float(np.exp(-1.0 / (0.1 * FS / d)))
    passes = TC.passes_for(dtype, fast)
    try:
        _precision(fast)
        for mode, xin, g, ab, gain in (("fm", fm, fm_taps, None, 1.3),
                                       ("fm", fm, fm_taps, (0.95, 0.05), 1.3),
                                       ("am", x, taps, None, 1.0),
                                       ("am", x, taps, (lam, 1 - lam), 0.125),
                                       ("am", x, taps, (0.9, 0.2), 0.125)):
            args = (xin, g, d, s0, lead, rot, gain, ab,
                    None if ab is None else state, mode)
            n0 = M.fir_fm_mxu.routes["tc"]
            got = M.fir_fm_mxu(*args)
            emu = TC.fm_mxu_split(*args, passes=passes)
            torch.cuda.synchronize()
            assert M.fir_fm_mxu.routes["tc"] == n0 + 1
            out, eout = got[0], emu[0]
            assert out.shape == (c, b // d) and bool(torch.isfinite(out).all())
            if mode == "fm":
                assert float((out - eout).abs().max()) < SPLIT_FM, ab
            else:
                assert float((out - eout).abs().max()) < \
                    SPLIT_REL * float(eout.abs().max()), ab
            if ab is not None and mode == "am":
                assert float(((got[1] - emu[1]) / emu[1]).abs().max()) < \
                    SPLIT_REL
            if fast:
                continue
            ref = M.fir_fm_mxu_plain(*args)
            if mode == "fm":
                assert float((out - ref[0]).abs().max()) < ERR_BOUND
            elif ab is None:
                assert float((out - ref[0]).abs().max()) / float(
                    ref[0].abs().max()) < 1e-5
            else:
                assert float((out - ref[0]).abs().max()) < 1e-4
    finally:
        _precision(False)


# K1b (mode fir), K1c (mode am, +- the AGC) and K1d (mode usb, +- the AGC)
# on the tensor-core route, at strides on both ends of their cuts
# (csrc/fir_common.cuh::tc_stride: with float32 planes fir 2-40, am 13-40
# and usb 4-33, each with gaps; 2-40 with bfloat16, usb to 61 and the
# multiples of 4 to 120 but 84 and 108) and the banks' shapes (the DDC bank's T = 67, D =
# 4; the AM bank's T = 71, D = 40; the USB bank's T = 143, D = 80 with
# bfloat16 planes): (mode, agc, dtype, D, T, C)
TC_K1BC = [("fir", False, dt, d, t, c)
           for dt, shapes in ((torch.float32, ((4, 67, 64), (5, 68, 3),
                                               (20, 83, 1), (2, 65, 3),
                                               (40, 103, 1))),
                              (torch.bfloat16, ((2, 65, 3), (4, 67, 64),
                                                (40, 103, 1))))
           for d, t, c in shapes] + [
    ("am", agc, dt, d, t, c) for agc in (False, True)
    for dt, shapes in ((torch.float32, ((16, 47, 3), (40, 71, 64),
                                        (40, 71, 1), (13, 44, 3),
                                        (33, 64, 1))),
                       (torch.bfloat16, ((2, 33, 3), (24, 55, 1),
                                         (40, 71, 64))))
    for d, t, c in shapes] + [
    ("usb", agc, dt, d, t, c) for agc in (False, True)
    for dt, shapes in ((torch.float32, ((4, 67, 3), (13, 76, 1),
                                        (33, 96, 3), (31, 94, 64))),
                       (torch.bfloat16, ((2, 65, 3), (40, 103, 1),
                                         (60, 123, 3), (80, 143, 64),
                                         (100, 163, 3), (120, 183, 1))))
    for d, t, c in shapes]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("mode,agc,dtype,d,t,c", TC_K1BC)
def test_tc_k1_modes_match_split_and_plain(cuda, mode, agc, dtype, d, t, c,
                                           fast):
    """K1b and K1c on the tensor-core route over a warm block and three
    carry-chained blocks of 12,621 outputs a channel (chunks K > 1, the
    AGC's K_agc > 1, a ragged last tile), from a nonzero tail and AGC
    state: y, or the audio and the AGC's exported state, against the split
    emulation (ops/fir_tc.py, cut into the launch's chunks) within
    SPLIT_REL of the largest, and at 'high' against the plain version
    under the gates of the module docstring (tools/k1_parity.py)."""
    from libsdr_tpu_torch.tools import k1_parity

    assert k1_parity.SPLIT_REL == SPLIT_REL
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1000 * d + t + 7 * agc)
    try:
        _precision(fast)
        k1_parity.tc_case(gen, mode, agc, dtype, d, t, c, device=cuda)
    finally:
        _precision(False)


@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
@pytest.mark.parametrize("dtype,d,t", [(torch.float32, 33, 96),
                                       (torch.bfloat16, 80, 143),
                                       (torch.bfloat16, 100, 163)])
def test_tc_k1d_chunks_match_split_and_plain(cuda, d, t, dtype, chunks):
    """K1d with the AGC on the tensor-core route at the USB bank's stride
    and at D = 100 with bfloat16 planes (with float32 planes both take the
    warp kernel), and at D = 33 with float32 planes (the largest stride of
    its float32 cut), its launches cut into
    1, 2, 3 and 7 chunks a channel (3 channels of chunks * 4096 + 333
    outputs): as test_tc_k1_modes_match_split_and_plain, at 'high'."""
    from libsdr_tpu_torch.tools import k1_parity

    gen = torch.Generator(device=cuda)
    gen.manual_seed(100 * d + chunks)
    k1_parity.tc_case(gen, "usb", True, dtype, d, t, 3, device=cuda,
                      chunks=chunks)


# K5 on the tensor-core route (mode fir's cut): (dtype, D, T, C), F1's
# D = 4, T = 67 on 64 channels among them
TC_K5 = [(dt, d, t, c) for dt in (torch.float32, torch.bfloat16)
         for d, t, c in ((2, 37, 3), (4, 67, 64), (5, 68, 3), (20, 83, 1),
                         (40, 71, 3))]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype,d,t,c", TC_K5)
def test_tc_k5_matches_split_and_plain(cuda, dtype, fast, d, t, c):
    """K5 on the tensor-core route at every window form of its callers
    (tools/k1_parity.py's k5_case): fir_offset from window starts 1 - T,
    2 - T, D - T (in the tail) and 0 with wrap 0 and odd output counts,
    fir_mxu from 0, D and 2D + 1 with wrap 128*D, chunks K > 1: y against
    the split emulation within SPLIT_REL of the largest, and at 'high'
    against the plain version within 1e-5."""
    from libsdr_tpu_torch.tools import k1_parity

    gen = torch.Generator(device=cuda)
    gen.manual_seed(10 * d + t)
    try:
        _precision(fast)
        k1_parity.k5_case(gen, dtype, d, t, c, device=cuda)
    finally:
        _precision(False)


@pytest.mark.parametrize("t", [1, 17, 41, 51, 67, 71, 143, 263, 12001])
def test_tc_plan_is_the_python_rule(cuda, t):
    """The kernel's plan (sdr_fir_tc_plan) is ops/fir_tc.tc_plan's on this
    card's shared memory, at every stride up to 40 and mode usb's larger
    ones, both plane dtypes and both precisions, without mode afsk's
    correlator and with its windows 2, 40 and 256; both say when no plan
    fits."""
    import ctypes

    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.ops import fir_tc as TC

    lib = _build.library()
    prop = torch.cuda.get_device_properties(cuda)
    smem_block = getattr(prop, "shared_memory_per_block_optin",
                         TC.SMEM_BLOCK)
    smem_sm = getattr(prop, "shared_memory_per_multiprocessor", TC.SMEM_SM)
    for d in list(range(1, 41)) + [48, 63, 64, 80, 90, 100, 120, 200]:
        for bf16 in (0, 1):
            for fast in (0, 1):
                for ell in (0, 2, 40, 256):
                    out = (ctypes.c_int * 8)()
                    rc = lib.sdr_fir_tc_plan(t, d, ell, bf16, fast, out)
                    want = TC.tc_plan(t, d, 2 if bf16 else 4,
                                      TC.passes_for(torch.bfloat16 if bf16
                                                    else torch.float32,
                                                    fast),
                                      smem_block, smem_sm, ell=ell)
                    if want is None:
                        assert rc == -1, (t, d, ell, bf16, fast)
                        continue
                    assert rc == 0 and list(out) == list(want), (
                        t, d, ell, bf16, fast)


def test_paths_take_their_routes(cuda):
    """The main path's K1a launches take the tensor-core route, and so do
    the DDC bank's K1b, the AM bank's K1c at D = 40, the USB bank's K1d at
    D = 80 (with bfloat16 planes; float32 ones by the cut, USB_BANK_F32)
    and F1's K5 (fir_overlap_save at offsets 0 and 1, D = 4, T = 67, both
    plane dtypes); K1a at T = 12,001
    (no tensor-core plan fits) the staged, and at the cut's edges: D = 2
    and 24 the staged kernel with float32 planes, D = 24 the tensor-core
    kernel with bfloat16 planes; K1b and K1c at the edges of theirs and
    of their gaps (csrc/fir_common.cuh::tc_stride: with float32 planes fir
    2-40 but 3, 6, 8, 9, 12, 24, 32 and 34-39, am 13-40 but 32 and 34-39;
    2-40 with bfloat16), and K1d at the edges of its (with float32 planes
    4, 13-16, 23, 25-31 and 33; with bfloat16 2-61 and the multiples of 4
    to 120 but 84 and 108)."""
    from libsdr_tpu_torch.apps.chains import rx_stages

    def step(stages, b, c=4):
        rx = P.Pipeline(stages)
        rx.bind(P.StreamSpec(np.complex64, FS, b, channels=(c,)))
        carry = rx.init_carry(cuda)
        x = Complex(torch.randn(c, b, device=cuda),
                    torch.randn(c, b, device=cuda))
        rx.compile()(carry, x)
        torch.cuda.synchronize()

    for e in (F.fir_fm_exact, F.fir_exact, F.fir_am_exact):
        F.reset_counts(e)
    step([IQBaseBand(fc=FS / 8, width=FS / 4.8, order=64, decim=4,
                     design="textbook"), FMDemod(), FMDeemph()], 1 << 16)
    step([IQBaseBand(fc=FS / 8, width=FS / 4.8, order=64, decim=4,
                     design="textbook")], 1 << 16)
    step(rx_stages("AM", FS, FS / 8), 40 * 4096)
    assert F.fir_fm_exact.routes == {"staged": 0, "warp": 0, "tc": 1}
    assert F.fir_exact.routes == {"staged": 0, "warp": 0, "tc": 1}
    assert F.fir_am_exact.routes == {"staged": 0, "warp": 0, "tc": 1}
    _usb_bank_and_f1_routes(cuda)
    op = _op(16, 12001, 3, 16 * 4096)
    carry = op.init_carry(cuda)
    x = Complex(torch.randn(3, 16 * 4096, device=cuda),
                torch.randn(3, 16 * 4096, device=cuda))
    fir_fm_exact(x, op._taps(cuda), 16, carry[0], carry[1], op._rot, 1.0)
    assert F.fir_fm_exact.routes == {"staged": 1, "warp": 0, "tc": 1}
    for d, dtype, route in ((2, torch.float32, "staged"),
                            (24, torch.float32, "staged"),
                            (24, torch.bfloat16, "tc")):
        op = _op(d, 31 + d, 3, d * 4096, dtype)
        carry = op.init_carry(cuda)
        x = Complex(torch.randn(3, d * 4096, device=cuda),
                    torch.randn(3, d * 4096, device=cuda)).to(dtype)
        n0 = dict(F.fir_fm_exact.routes)
        fir_fm_exact(x, op._taps(cuda), d, carry[0], carry[1], op._rot, 1.0)
        assert F.fir_fm_exact.routes[route] == n0[route] + 1, (d, dtype)
    taps = Complex(torch.randn(71, device=cuda), torch.randn(71, device=cuda))
    th = 0.01 * np.arange(4096)   # mode usb's ramp: 4096 outputs each case
    usb = (Complex(torch.tensor(0.6, device=cuda),
                   torch.tensor(0.8, device=cuda)),
           Complex(torch.tensor(np.cos(th), dtype=torch.float32, device=cuda),
                   torch.tensor(-np.sin(th), dtype=torch.float32,
                                device=cuda)), 1.0)
    for entry, extra, d, dtype, route in (
            (F.fir_exact, (), 2, torch.float32, "tc"),
            (F.fir_exact, (), 3, torch.float32, "staged"),
            (F.fir_exact, (), 4, torch.float32, "tc"),
            (F.fir_exact, (), 8, torch.float32, "staged"),
            (F.fir_exact, (), 20, torch.float32, "tc"),
            (F.fir_exact, (), 24, torch.float32, "warp"),
            (F.fir_exact, (), 33, torch.float32, "tc"),
            (F.fir_exact, (), 34, torch.float32, "warp"),
            (F.fir_exact, (), 40, torch.float32, "tc"),
            (F.fir_exact, (), 2, torch.bfloat16, "tc"),
            (F.fir_exact, (), 40, torch.bfloat16, "tc"),
            (F.fir_am_exact, (1.0,), 10, torch.float32, "staged"),
            (F.fir_am_exact, (1.0,), 12, torch.float32, "staged"),
            (F.fir_am_exact, (1.0,), 13, torch.float32, "tc"),
            (F.fir_am_exact, (1.0,), 16, torch.float32, "tc"),
            (F.fir_am_exact, (1.0,), 32, torch.float32, "warp"),
            (F.fir_am_exact, (1.0,), 40, torch.float32, "tc"),
            (F.fir_am_exact, (1.0,), 80, torch.float32, "warp"),
            (F.fir_am_exact, (1.0,), 2, torch.bfloat16, "tc"),
            (F.fir_am_exact, (1.0,), 40, torch.bfloat16, "tc"),
            (F.fir_usb_exact, usb, 4, torch.float32, "tc"),
            (F.fir_usb_exact, usb, 5, torch.float32, "staged"),
            (F.fir_usb_exact, usb, 20, torch.float32, "staged"),
            (F.fir_usb_exact, usb, 33, torch.float32, "tc"),
            (F.fir_usb_exact, usb, 40, torch.float32, "staged"),
            (F.fir_usb_exact, usb, 41, torch.float32, "warp"),
            (F.fir_usb_exact, usb, 80, torch.float32, "warp"),
            (F.fir_usb_exact, usb, 61, torch.bfloat16, "tc"),
            (F.fir_usb_exact, usb, 62, torch.bfloat16, "warp"),
            (F.fir_usb_exact, usb, 63, torch.bfloat16, "warp"),
            (F.fir_usb_exact, usb, 84, torch.bfloat16, "warp"),
            (F.fir_usb_exact, usb, 88, torch.bfloat16, "tc"),
            (F.fir_usb_exact, usb, 108, torch.bfloat16, "warp"),
            (F.fir_usb_exact, usb, 120, torch.bfloat16, "tc"),
            (F.fir_usb_exact, usb, 122, torch.bfloat16, "warp"),
            (F.fir_usb_exact, usb, 124, torch.bfloat16, "warp")):
        x = Complex(torch.randn(3, d * 4096, device=cuda),
                    torch.randn(3, d * 4096, device=cuda)).to(dtype)
        tail = Complex(torch.zeros(3, 70, device=cuda),
                       torch.zeros(3, 70, device=cuda)).to(dtype)
        n0 = dict(entry.routes)
        entry(x, taps, d, tail, *extra)
        assert entry.routes[route] == n0[route] + 1, (entry.__name__, d,
                                                      dtype)


# K1e (mode afsk) on the tensor-core route: against the split emulation
# (ops/fir_tc.afsk_exact_split, cut into the kernel's chunks) within
# SPLIT_AFSK of each channel's largest |s_m|^2 + |s_s|^2 at 'high' and
# 'fast' (the same bf16 FIR products and the same float32 window sums, in
# another order: ~1e-7 of the powers, which disc, their difference, can
# cancel to 1% of at a window of 2), the exported products within
# SPLIT_FM; at 'high' also against the plain version under K1e's own
# bound.
SPLIT_AFSK = 1e-5
# (dtype, D, L, C) on the route: P1's shape, the shortest and longest
# windows, strides at both ends of the route (2-16, 2-40 with bfloat16
# planes) and windows longer than a tile's outputs at D = 40
TC_AFSK = [(dt, d, ell, c) for dt in (torch.float32, torch.bfloat16)
           for d, ell, c in ((4, 40, 64), (2, 2, 3), (5, 20, 1),
                             (8, 256, 3), (16, 40, 3))] + [
    (torch.bfloat16, 24, 40, 3), (torch.bfloat16, 40, 128, 3),
    (torch.bfloat16, 40, 256, 2)]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype,d,ell,c", TC_AFSK)
def test_tc_afsk_matches_split_and_plain(cuda, dtype, fast, d, ell, c):
    """K1e on the tensor-core route over a warm block and three
    carry-chained blocks of 12,621 outputs a channel (chunks K > 1, a
    ragged last tile), from a template phase of 7 and nonzero carried
    products: disc, y_last and the exported products against the split
    emulation, and at 'high' against the plain version."""
    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.ops import fir_tc as TC

    n_out = 3 * 4096 + 333
    b = d * n_out
    op = _afsk_op(d, ell, c, b, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11 * d + ell)
    tail, prev, _, _, _ = op.init_carry(cuda)
    carry = (tail, prev, torch.tensor(7 % ell, dtype=torch.int32,
                                      device=cuda),
             _noise(gen, (c, ell - 1), torch.float32, cuda),
             _noise(gen, (c, ell - 1), torch.float32, cuda))
    passes = TC.passes_for(dtype, fast)
    t = op._t
    try:
        _precision(fast)
        for k in range(4):
            x = _fm(c, b, d, k)
            x = Complex(torch.tensor(x.real, device=cuda).to(dtype),
                        torch.tensor(x.imag, device=cuda).to(dtype))
            args = _afsk_args(op, x, carry)
            kk, route = F._chunks("K1e", _build.library(), F._MODE_AFSK, c,
                                  n_out, t, d, ell, x.re,
                                  cut_mode=F._MODE_AFSK)
            assert route == "tc", (d, ell, dtype)
            emu = TC.afsk_exact_split(*args, passes=passes, chunks=kk,
                                      with_power=True)
            n0 = F.fir_afsk_exact.routes["tc"]
            got = F.fir_afsk_exact(*args)
            torch.cuda.synchronize()
            assert F.fir_afsk_exact.routes["tc"] == n0 + 1
            disc, y_last, um, us = got
            assert disc.shape == (c, n_out) and bool(
                torch.isfinite(disc).all())
            if k:  # block 0 warms the carry up
                scale = emu[4].amax(dim=1, keepdim=True)
                assert bool(((disc - emu[0]).abs()
                             <= SPLIT_AFSK * scale).all()), k
                for a, r in ((um, emu[2]), (us, emu[3])):
                    for pa, pr in ((a.re, r.re), (a.im, r.im)):
                        assert float((pa - pr).abs().max()) < SPLIT_FM
                assert float((y_last.re - emu[1].re).abs().max()) < \
                    SPLIT_REL * float(emu[1].abs().max()) + 1e-6
                if not fast:
                    ref = F.fir_afsk_exact_plain(*args)
                    rscale = ref[0].abs().amax(dim=1, keepdim=True)
                    assert bool(((disc - ref[0]).abs()
                                 <= 1e-4 * rscale).all()), k
                    for a, r in ((um, ref[2]), (us, ref[3])):
                        for pa, pr in ((a.re, r.re), (a.im, r.im)):
                            assert float((pa - pr).abs().max()) < ERR_BOUND
            carry = (x[..., b - (t - 1):].map(torch.clone), emu[1],
                     (carry[2] + n_out) % ell, emu[2], emu[3])
    finally:
        _precision(False)


def test_tc_afsk_short_block_exports_carried_products(cuda):
    """A block of fewer than L - 1 outputs (one chunk): the exported
    products are the last L - 1 of the carried ones and the block's, as
    the plain version's."""
    d, ell, c = 4, 128, 3
    b = d * 100
    op = _afsk_op(d, ell, c, b)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    tail, prev, _, _, _ = op.init_carry(cuda)
    carry = (tail, prev, torch.tensor(3, dtype=torch.int32, device=cuda),
             _noise(gen, (c, ell - 1), torch.float32, cuda),
             _noise(gen, (c, ell - 1), torch.float32, cuda))
    x = _noise(gen, (c, b), torch.float32, cuda)
    args = _afsk_args(op, x, carry)
    n0 = F.fir_afsk_exact.routes["tc"]
    got = F.fir_afsk_exact(*args)
    ref = F.fir_afsk_exact_plain(*args)
    torch.cuda.synchronize()
    assert F.fir_afsk_exact.routes["tc"] == n0 + 1
    for a, r in ((got[2], ref[2]), (got[3], ref[3])):
        assert torch.equal(a.re[:, :ell - 1 - 100], r.re[:, :ell - 1 - 100])
        assert float((a.re - r.re).abs().max()) < 1e-3
        assert float((a.im - r.im).abs().max()) < 1e-3


def test_p1_afsk_takes_the_tc_route(cuda):
    """P1's K1e launch (64 ch x 2^21 at 192 kHz, T = 51, D = 4, L = 40)
    takes the tensor-core route in both plane dtypes."""
    from libsdr_tpu_torch.ops import FSKDetector

    for dtype in (torch.float32, torch.bfloat16):
        p = P.Pipeline([IQBaseBand(fc=24e3, width=12.5e3, order=48,
                                   out_rate=48e3, design="textbook"),
                        FMDemod(), FSKDetector(1200.0, 1200.0, 2200.0)])
        p.bind(P.StreamSpec(np.complex64, 192_000.0, 1 << 21,
                            channels=(64,), plane_dtype=dtype))
        op = p.stages[0]
        assert (op._t, op._decim, op.corr_len) == (51, 4, 40)
        x = Complex(torch.randn(64, 1 << 21, device=cuda),
                    torch.randn(64, 1 << 21, device=cuda)).to(dtype)
        n0 = dict(F.fir_afsk_exact.routes)
        op.apply(op.init_carry(cuda), x)
        torch.cuda.synchronize()
        assert F.fir_afsk_exact.routes["tc"] == n0["tc"] + 1, dtype


def test_fast_precision_keeps_70_db(cuda):
    """set_mxu_precision('fast') (one bf16 pass on the tensor-core route)
    against 'high' on the FM signal of the JAX package's own gate
    (tests/test_tpu_smoke.py::test_fast_precision_mode_on_chip): 64
    channels of a 900 Hz tone at 75 kHz deviation through the main path,
    audio SNR above 70 dB; 'fast' must differ from 'high'.  Then K1b, K1c
    and K1d on the tc route, the DDC, AM and USB banks' chains, and K5,
    F1's fir_overlap_save at offset 0 on the FM signal, at 'fast' against
    'high' (tools/fast_precision.py's cases): above an 8-bit source's 49.9
    dB."""
    from libsdr_tpu_torch.tools import fast_precision as FP

    fs, n_ch, block = FP.FS, 64, 1 << 17
    x = FP.fm_tone(n_ch, block, cuda)

    def run():
        rx = P.Pipeline([IQBaseBand(fc=120_000, width=200_000, order=64,
                                    decim=4, design="textbook"),
                         FMDemod(), FMDeemph()])
        rx.bind(P.StreamSpec(np.complex64, fs, block, channels=(n_ch,)))
        _, y = rx.compile()(rx.init_carry(cuda), x)
        return y.double().cpu().numpy()

    try:
        y_hi = run()
        _precision(True)
        n0 = F.fir_fm_exact.routes["tc"]
        y_fast = run()
        assert F.fir_fm_exact.routes["tc"] == n0 + 1
    finally:
        _precision(False)
    err = y_hi - y_fast
    snr = 10 * np.log10(np.mean(y_hi[0] ** 2) / np.mean(err[0] ** 2))
    assert 70.0 < snr < 200.0, snr
    # K1b, K1c, K1d (in bfloat16 planes, its route there; with float32
    # planes the USB bank takes the warp kernel, USB_BANK_F32) and K5: one
    # bf16 pass keeps an 8-bit source's fidelity (6.02 * 8 + 1.76 dB), as
    # the JAX kernel describes 'fast' (pallas_fir_mxu.py::_make_mm); there
    # is no discriminator to gain from as FM does.
    for name, entry, bank in FP.flat_cases(n_ch, torch.bfloat16, block,
                                           cuda):
        snr = float(FP.fast_snr_db(bank, entry)[0])
        assert FP.FAST_8BIT_DB < snr < 200.0, (name, snr)


# The route of the USB bank's K1d (T = 143, D = 80) with float32 planes, by
# the measured cut of mode usb (csrc/fir_common.cuh::tc_stride)
USB_BANK_F32 = "warp"


def _usb_bank_and_f1_routes(cuda):
    """The USB bank's chain (rx_stages("USB"), D = 80) and F1's call
    (fir_overlap_save at offsets 0 and 1 with the DDC bank's taps, D = 4)
    in both plane dtypes: K1d and K5 on their routes, one launch a
    block."""
    from libsdr_tpu_torch.apps.chains import rx_stages
    from libsdr_tpu_torch.ops import fir_mxu as M
    from libsdr_tpu_torch.ops.fir import fir_overlap_save

    for dtype, route in ((torch.float32, USB_BANK_F32),
                         (torch.bfloat16, "tc")):
        rx = P.Pipeline(rx_stages("USB", FS, FS / 8))
        b = 80 * 4096
        rx.bind(P.StreamSpec(np.complex64, FS, b, channels=(4,),
                             plane_dtype=dtype))
        assert (rx.stages[0]._t, rx.stages[0]._decim) == (143, 80)
        x = Complex(torch.randn(4, b, device=cuda),
                    torch.randn(4, b, device=cuda)).to(dtype)
        n0 = dict(F.fir_usb_exact.routes)
        rx.compile()(rx.init_carry(cuda), x)
        torch.cuda.synchronize()
        assert F.fir_usb_exact.routes[route] == n0[route] + 1, dtype
        rng = np.random.default_rng(67)
        g = rng.normal(size=67) + 1j * rng.normal(size=67)
        for offset in (0, 1):
            x = Complex(torch.randn(4, 4 * 4096, device=cuda),
                        torch.randn(4, 4 * 4096, device=cuda)).to(dtype)
            tail = Complex(torch.zeros(4, 66, device=cuda),
                           torch.zeros(4, 66, device=cuda)).to(dtype)
            m0 = dict(M.fir_mxu.routes)
            fir_overlap_save(g, x, tail, stride=4, offset=offset)
            assert M.fir_mxu.routes["tc"] == m0["tc"] + 1, (dtype, offset)


# -- slice 11: chunked dispatch as one CUDA graph, checkpoint, Q14 ----------

def _main_path(c, b, plane_dtype=None):
    rx = P.Pipeline([IQBaseBand(fc=FS / 8, width=200e3, order=64, decim=4,
                                design="textbook"), FMDemod(), FMDeemph()])
    rx.bind(P.StreamSpec(np.complex64, FS, b, channels=(c,),
                         plane_dtype=plane_dtype))
    return rx


def _blocks(cuda, c, b, n, dtype, seed=11):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    return [Complex(torch.randn((c, b), generator=g, device=cuda).to(dtype),
                    torch.randn((c, b), generator=g, device=cuda).to(dtype))
            for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_dispatch_graph_matches_eager(cuda, dtype):
    """run_pipeline at K = 3 over 7 blocks (two graph replays and a trailing
    block through the single step) bit for bit equal to K = 1 on the card;
    the kernel launched once a block in all (launches per capture times
    replays), 'scan' equal to 'unroll', and the graph's outputs cloned
    before the next replay."""
    from libsdr_tpu_torch.core import run_pipeline
    from libsdr_tpu_torch.core.graph import _leaves

    c, b = 8, 4 * 4096
    xs = _blocks(cuda, c, b, 7, dtype)
    rx = _main_path(c, b, dtype)
    c1, y1 = run_pipeline(rx, xs, device=cuda)
    F.reset_counts(F.fir_fm_exact)
    c3, y3 = run_pipeline(rx, xs, device=cuda, chunks_per_dispatch=3)
    np.testing.assert_array_equal(y3, y1)
    for a, r in zip(_leaves(c3)[0], _leaves(c1)[0]):
        assert torch.equal(a, r)
    step = rx.compile_chunked("unroll")
    # the two groups' blocks lie at two addresses: two in-place graphs
    assert len(step.graphs) == 2
    for g in step.graphs.values():
        assert g.in_place and g.launches == {"fir_fm_exact": 3}
        assert g.replays == 1
    assert step.graph_launches() == {"fir_fm_exact": 6}
    # eager launches: the trailing block's
    assert F.fir_fm_exact.launches == 3 * len(step.graphs) + 1
    carry = rx.init_carry(cuda)
    cu, yu = step(carry, tuple(xs[:3]))
    cs, ys = rx.compile_chunked("scan")(
        carry, Complex(torch.stack([x.re for x in xs[:3]]),
                       torch.stack([x.im for x in xs[:3]])))
    cu2, yu2 = step(cu, tuple(xs[3:6]))      # a new graph for new addresses
    for i in range(3):
        assert torch.equal(yu[i], ys[i])
    np.testing.assert_array_equal(
        torch.cat(list(yu) + list(yu2), -1).cpu().numpy(), y1[:, :6 * b // 4])
    # host blocks are copied into one graph's own inputs; past
    # IN_PLACE_GRAPHS addresses, device blocks are too
    host = [Complex(x.re.cpu(), x.im.cpu()) for x in xs]
    _, yh = run_pipeline(rx, host, device=cuda, chunks_per_dispatch=3)
    np.testing.assert_array_equal(yh, y1)
    copying = [g for g in step.graphs.values() if not g.in_place]
    assert len(copying) == 1 and copying[0].replays == 2


def test_compile_chunked_refuses_a_step_that_reads_the_host(cuda):
    """A step that reads the host cannot be captured: compile_chunked raises
    ConfigError naming the pipeline, runs nothing eagerly in its place,
    and the card works afterwards."""
    from libsdr_tpu_torch.core import ConfigError, Lambda

    p = P.Pipeline([Lambda(lambda v: v * float(v.abs().max()))],
                   name="reads-host")
    p.bind(P.StreamSpec(np.float32, 8000, 256))
    x = torch.ones(256, device=cuda)
    with pytest.raises(ConfigError, match="reads-host"):
        p.compile_chunked("unroll")(p.init_carry(cuda), (x, x))
    assert float((x + 1).sum()) == 512.0


def test_checkpoint_resume_on_card_bf16(cuda, tmp_path):
    """The main path with bfloat16 planes checkpointed after block 4 of 8
    and resumed into a fresh pipeline with load_checkpoint: the resumed
    outputs equal the full run's bit for bit, each leaf back in its dtype
    on the card."""
    from libsdr_tpu_torch.core.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    from libsdr_tpu_torch.core.graph import _leaves

    c, b = 8, 4 * 4096
    xs = _blocks(cuda, c, b, 8, torch.bfloat16, seed=12)
    rx = _main_path(c, b, torch.bfloat16)
    carry, outs = rx.init_carry(cuda), []
    for i, x in enumerate(xs):
        carry, y = rx.apply(carry, x)
        outs.append(y)
        if i == 3:
            save_checkpoint(str(tmp_path / "ck.npz"), carry, i + 1)
    rx2 = _main_path(c, b, torch.bfloat16)
    c2, pos, _ = load_checkpoint(str(tmp_path / "ck.npz"),
                                 rx2.init_carry(cuda))
    assert pos == 4
    dts = {v.dtype for v in _leaves(c2)[0]}
    assert torch.bfloat16 in dts
    assert all(v.device.type == "cuda" for v in _leaves(c2)[0])
    for i in range(4, 8):
        c2, y = rx2.apply(c2, xs[i])
        assert torch.equal(y, outs[i])


def test_q14_chain_card_matches_cpu(cuda):
    """IQBaseBandInt -> FMDemodInt(ref_block_quirk) -> FMDeemphInt over
    three blocks of 4 channels: the card's audio equals the CPU's bit for
    bit."""
    from libsdr_tpu_torch.ops import FMDeemphInt, FMDemodInt, IQBaseBandInt

    fs, b, c = 240_000.0, 2400, 4
    rng = np.random.default_rng(14)
    iq = np.round(rng.normal(size=(c, 3 * b)) * 6000) + 1j * np.round(
        rng.normal(size=(c, 3 * b)) * 6000)
    outs = {}
    for dev in ("cpu", cuda):
        bb = IQBaseBandInt(fc=3000.0, width=12.5e3, order=21, decim=10)
        dm = FMDemodInt(ref_block_quirk=True)
        de = FMDeemphInt()
        bb.bind(P.StreamSpec(np.complex64, fs, b, channels=(c,)))
        dm.bind(P.StreamSpec(np.complex64, fs / 10, b // 10, channels=(c,)))
        de.bind(P.StreamSpec(np.float32, fs / 10, b // 10, channels=(c,)))
        cs = [s.init_carry(dev) for s in (bb, dm, de)]
        ys = []
        for k in range(3):
            blk = iq[:, k * b:(k + 1) * b]
            y = Complex(torch.tensor(blk.real, dtype=torch.int32, device=dev),
                        torch.tensor(blk.imag, dtype=torch.int32, device=dev))
            for i, stage in enumerate((bb, dm, de)):
                cs[i], y = stage.apply(cs[i], y)
            ys.append(y.cpu().numpy())
        outs[str(dev)] = np.concatenate(ys, -1)
    np.testing.assert_array_equal(outs["cuda"], outs["cpu"])


def _deemph_blocks(rng, c, t, k):
    """k blocks of (c, t) int16-range samples (uniform, so ``x - avg``
    wraps often) with runs at the edges -32768 and 32767 and jumps from
    one edge to the other (tests/test_torch_fixedpoint.py's)."""
    x = rng.integers(-32768, 32768, size=(c, k * t)).astype(np.int32)
    edges = np.array([-32768, 32767, -32768, -32768, 32767, 32767, 0,
                      -32768], np.int32)
    for ch in range(c):
        at = int(rng.integers(0, max(1, k * t - len(edges))))
        x[ch, at:at + len(edges)] = edges[:k * t - at]
    return [torch.from_numpy(x[:, i * t:(i + 1) * t]) for i in range(k)]


def _deemph_chain(cuda, blocks, alpha, avg0):
    """The kernel over chained blocks, the carry made on the CPU and moved
    to the card, against the plain version on the CPU: equal bit for bit,
    one launch a block."""
    from libsdr_tpu_torch.ops.fixedpoint import deemph_int, deemph_int_plain

    n0 = deemph_int.launches
    ka, pa = avg0.to(cuda), avg0
    for i, x in enumerate(blocks):
        ka, ky = deemph_int(x.to(cuda), ka, alpha)
        pa, py = deemph_int_plain(x, pa, alpha)
        torch.cuda.synchronize()
        assert ky.device.type == "cuda" and ky.dtype == torch.int32
        assert torch.equal(ky.cpu(), py), f"block {i}"
        assert torch.equal(ka.cpu(), pa), f"carry after block {i}"
    assert deemph_int.launches == n0 + len(blocks)


@pytest.mark.parametrize("t", [1, 2, 15, 16, 17, 31, 33, 1000, 2401])
@pytest.mark.parametrize("c", [1, 3, 64, 1000])
def test_deemph_int_kernel_matches_plain(cuda, c, t):
    """FMDeemphInt's kernel (csrc/fixedpoint.cu) bit for bit against its
    plain version over three chained blocks at alpha 2 (24 kHz, the Q14
    chain's output rate): T 1 to 2,401 (below, at and past the kernel's
    16-sample chunks), C 1 to 1,000, inputs at the int16 edges, a random
    int16 carry from the CPU."""
    rng = np.random.default_rng(1000 * c + t)
    avg0 = torch.from_numpy(rng.integers(-32768, 32768, c).astype(np.int32))
    _deemph_chain(cuda, _deemph_blocks(rng, c, t, 3), 2, avg0)


@pytest.mark.parametrize("alpha", [1, 2, 3, 4, 19, 100, 32767, 32768,
                                   1 << 20])
def test_deemph_int_kernel_alphas(cuda, alpha):
    """alpha from 1 upward (half = alpha // 2 from 0), and the carry at
    the edges: 64 channels x 3 blocks of 257."""
    rng = np.random.default_rng(alpha)
    avg0 = torch.tensor(([-32768, 32767, 0, -1] * 16), dtype=torch.int32)
    _deemph_chain(cuda, _deemph_blocks(rng, 64, 257, 3), alpha, avg0)


def test_deemph_int_kernel_leading_axes_and_empty(cuda):
    """Leading stream axes pass through; a block of no samples returns the
    carry."""
    from libsdr_tpu_torch.ops.fixedpoint import deemph_int, deemph_int_plain

    rng = np.random.default_rng(5)
    x = _deemph_blocks(rng, 6, 40, 1)[0].reshape(2, 3, 40)
    avg = torch.from_numpy(rng.integers(-300, 300, (2, 3)).astype(np.int32))
    ka, ky = deemph_int(x.to(cuda), avg.to(cuda), 4)
    pa, py = deemph_int_plain(x, avg, 4)
    assert torch.equal(ky.cpu(), py) and torch.equal(ka.cpu(), pa)
    ka, ky = deemph_int(x[..., :0].to(cuda), avg.to(cuda), 4)
    assert ky.shape == (2, 3, 0) and torch.equal(ka.cpu(), avg)
    with pytest.raises(ValueError, match="carry shape"):
        deemph_int(x.to(cuda), avg[0].to(cuda), 4)


def test_q14_pipeline_compile_chunked_matches_eager(cuda):
    """The Q14 chain (64 channels x 24,000 at 240 kHz, decim 10; bound as
    two pipelines, IQBaseBandInt and FMDemodInt -> FMDeemphInt, since
    FMDemodInt takes a complex spec) through ``compile_chunked`` at K = 4:
    both capture, bit for bit their eager steps over 8 blocks, one
    FMDeemphInt launch a block."""
    from libsdr_tpu_torch.core.graph import _leaves
    from libsdr_tpu_torch.ops import FMDeemphInt, FMDemodInt, IQBaseBandInt

    c, b, fs = 64, 24_000, 240_000.0
    front = P.Pipeline([IQBaseBandInt(fc=3000.0, width=12.5e3, order=21,
                                      decim=10)])
    front.bind(P.StreamSpec(np.complex64, fs, b, channels=(c,)))
    back = P.Pipeline([FMDemodInt(ref_block_quirk=True), FMDeemphInt()])
    back.bind(P.StreamSpec(np.complex64, fs / 10, b // 10, channels=(c,)))
    rng = np.random.default_rng(17)
    xs = [Complex(*(torch.tensor(np.round(rng.normal(size=(c, b)) * 6000),
                                 dtype=torch.int32, device=cuda)
                    for _ in range(2))) for _ in range(8)]
    cf, cb, ys = front.init_carry(cuda), back.init_carry(cuda), []
    for x in xs:
        cf, z = front.apply(cf, x)
        cb, y = back.apply(cb, z)
        ys.append(y)
    sf, sb = front.compile_chunked("unroll"), back.compile_chunked("unroll")
    cf2, cb2, ys2 = front.init_carry(cuda), back.init_carry(cuda), []
    for k in (0, 4):
        cf2, zs = sf(cf2, tuple(xs[k:k + 4]))
        cb2, y4 = sb(cb2, zs)
        ys2.extend(y4)
    torch.cuda.synchronize()
    for a, b_ in zip(ys2, ys):
        assert torch.equal(a, b_)
    for a, b_ in zip(_leaves(cb2)[0], _leaves(cb)[0]):
        assert torch.equal(a, b_)
    assert sb.graphs and all(g.launches["deemph_int"] == 4
                             for g in sb.graphs.values())


def test_resamplers_card_match_cpu(cuda):
    """Resampler(3:2) and InpolSubSampler(2.5) on a complex bank: the card
    within 1e-6 of the CPU over three chained blocks."""
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.ops import InpolSubSampler, Resampler

    rng = np.random.default_rng(15)
    x = (rng.normal(size=(4, 3 * 1200)) + 1j * rng.normal(size=(4, 3 * 1200))
         ).astype(np.complex64)
    for make in (lambda: Resampler(p=3, q=2), lambda: InpolSubSampler(2.5)):
        outs = {}
        for dev in ("cpu", cuda):
            op = make()
            op.bind(P.StreamSpec(np.complex64, 48000, 1200, channels=(4,)))
            c, ys = op.init_carry(dev), []
            for k in range(3):
                c, y = op.apply(c, cplx.as_block(x[:, k * 1200:(k + 1) * 1200],
                                                 torch.float32, dev))
                ys.append(cplx.to_numpy(y))
            outs[str(dev)] = np.concatenate(ys, -1)
        np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=1e-6)


def test_u8_wire_to_planes_on_card_equals_host_lut(cuda):
    """The u8 wire converted on the card (f32 and bf16 planes) equals the
    native host converters bit for bit, every u8 value."""
    from libsdr_tpu_torch import native
    from libsdr_tpu_torch.io.ingest import u8_wire_to_planes

    src = np.arange(512, dtype=np.uint8)
    re16, im16 = native.u8_iq_to_planar_bf16(src)
    re32, im32 = native.u8_iq_to_planar(src)
    got16 = u8_wire_to_planes(torch.from_numpy(src).to(cuda), torch.bfloat16)
    got32 = u8_wire_to_planes(torch.from_numpy(src).to(cuda))
    assert got16.re.view(torch.int16).cpu().numpy().tobytes() == \
        re16.tobytes()
    assert got16.im.view(torch.int16).cpu().numpy().tobytes() == \
        im16.tobytes()
    assert got32.re.cpu().numpy().tobytes() == re32.tobytes()
    assert got32.im.cpu().numpy().tobytes() == im32.tobytes()


@pytest.mark.parametrize("plane", [None, torch.bfloat16])
def test_pump_fed_pocsag_bank_on_card(cuda, tmp_path, plane):
    """P2's chain on 16 channels fed by the native file pump (the raw u8
    uploaded, converted on the card): every channel decodes its page, and
    the bits equal the same chain fed the same bytes already on the card."""
    from libsdr_tpu_torch.decode import POCSAGDecoder, pocsag_decode_bits
    from libsdr_tpu_torch.tools import ingest_bank as IB
    from libsdr_tpu_torch.tools.digital_signals import (POCSAG_ADDRESS,
                                                        pocsag_blocks)

    fs, c, blk, nb = 240e3, 16, 117_760, 4
    gen = torch.Generator(device=cuda)
    gen.manual_seed(14)
    blocks = pocsag_blocks(c, blk, nb, gen, fs)
    steps = [IB.quantize_u8(b, IB.unclipped_scale(blocks)) for b in blocks]
    path = tmp_path / "wire.u8"
    IB.write_wire_file(path, steps)
    fed = IB.run_steps(IB.pump_steps(path, c, blk),
                       IB.pocsag_bank(fs, blk, c, plane), fs, blk, plane, cuda)
    mem = IB.run_steps(steps, IB.pocsag_bank(fs, blk, c, plane), fs, blk,
                       plane, cuda)
    for a, b in zip(fed[0] + fed[1], mem[0] + mem[1]):
        assert torch.equal(a, b)
    for bits in IB.channel_bits(fed[0], fed[1]):
        msgs = pocsag_decode_bits(bits)
        assert any(m.address == POCSAG_ADDRESS for m in msgs)
        assert [(m.address, m.payload) for m in msgs] == [
            (m.address, m.payload) for m in POCSAGDecoder().process(bits)]


@pytest.mark.parametrize("bf16", [False, True])
def test_live_scanner_on_loopback_equals_file_fed(cuda, tmp_path, bf16):
    """The scanner on a loopback TCP wire (16 channels, two blocks) decodes
    what it decodes from a file of the same bytes, with no drops."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.tools import ingest_bank as IB
    from libsdr_tpu_torch.tools import wideband_signals as W

    m, b = 16, 16 * 16384
    gen = torch.Generator(device=cuda)
    gen.manual_seed(14)
    blocks, pages = W.pager_band(m, 2, b, cuda, gen=gen,
                                 channels=[3, 6, 10, 13])
    x = [Complex(p.re[None], p.im[None]) for p in blocks]
    scale = IB.unclipped_scale(x, 0.9)
    data = b"".join(IB.quantize_u8(p, scale).cpu().numpy().tobytes()
                    for p in x)
    path = tmp_path / "band.u8"
    path.write_bytes(data)
    fs = m * 24_000.0
    found, stats, _ = IB.scan_live(data, fs, m, b, bf16, cuda, rate=None,
                                   timeout=30.0)
    assert stats.bytes_dropped == 0 and stats.bytes_in == len(data)
    assert IB.pages_of(found) == IB.pages_of(
        IB.scan_file(path, fs, m, b, bf16, cuda))
    assert IB.decoded_pages(found, pages) == sorted(pages)
    assert not IB.misplaced(found, pages)


# -- BPSK31 (csrc/psk31.cu) ------------------------------------------------------
# The kernel repeats the plain version's step operation for operation (the
# phasor in float64 rounded on both sides), so it is held bit for bit:
# bits, valid flags and every carried value.

def _psk31_same(got, ref):
    from libsdr_tpu_torch.core.graph import _leaves

    a, b = _leaves(got)[0], _leaves(ref)[0]
    return len(a) == len(b) and all(
        u.dtype == v.dtype and torch.equal(u.cpu(), v.cpu())
        for u, v in zip(a, b))


def _psk31_chain(blocks, rate, cuda):
    """The kernel and the plain version over chained blocks: every block
    bit for bit; returns the kernel's (bits, valid) a block."""
    from libsdr_tpu_torch.ops.psk31 import bpsk31_scan, bpsk31_scan_plain
    from libsdr_tpu_torch.tools.psk31_times import bound_op

    c, t = blocks[0].re.shape
    op = bound_op(rate, c, t)
    k = op.constants()
    kc, pc = op.init_carry(cuda), op.init_carry("cpu")
    outs = []
    n0 = bpsk31_scan.launches
    for i, x in enumerate(blocks):
        kc, bits, emits = got = bpsk31_scan(x, kc, **k)
        pc, *ref = bpsk31_scan_plain(x.to("cpu"), pc, **k)
        assert bits.device.type == "cuda" and bits.dtype == torch.uint8
        assert emits.dtype == torch.bool and bits.shape == (c, t)
        assert _psk31_same(got, (pc, *ref)), f"block {i}"
        outs.append((bits.cpu(), emits.cpu()))
    assert bpsk31_scan.launches == n0 + len(blocks)
    return outs


def test_bpsk31_kernel_matches_plain_at_w2(cuda):
    """W2's PSK31 group (64 channels x 1,024 samples, the Channelizer and
    K1b on W2's band, 8 blocks): the kernel bit for bit the plain version,
    block after block; every active channel decodes its own message."""
    from libsdr_tpu_torch.decode import VaricodeDecoder
    from libsdr_tpu_torch.tools import psk31_times as PT
    from libsdr_tpu_torch.tools.multimode_times import PATTERN

    blocks, active, rate = PT.w2_inputs()
    assert blocks[0].re.shape == (64, 1024) and active.sum() == 12
    assert rate == 2000.0
    outs = _psk31_chain(blocks, rate, cuda)
    data = torch.cat([b for b, _ in outs], 1).numpy()
    valid = torch.cat([v for _, v in outs], 1).numpy()
    rows = [ch for ch in range(PT.M) if PATTERN[ch % 4] == "psk31"]
    for i in np.flatnonzero(active):
        text = VaricodeDecoder().process(data[i][valid[i]])
        assert f"cq {rows[i]:03d}" in text, (rows[i], text)


def test_bpsk31_kernel_matches_plain_at_psk31_rx(cuda):
    """psk31_rx's shape (one channel of 2,000 samples a block, the app's
    IQBaseBand on a 20 kHz capture): bit for bit the plain version, and the
    text decodes."""
    from libsdr_tpu_torch.decode import VaricodeDecoder
    from libsdr_tpu_torch.tools import psk31_times as PT

    blocks, rate = PT.rx_inputs(cuda)
    assert blocks[0].re.shape == (1, 2000) and rate == 2000.0
    outs = _psk31_chain(blocks, rate, cuda)
    bits = np.concatenate([b[0][v[0]].numpy() for b, v in outs])
    assert "cq de tpu" in VaricodeDecoder().process(bits)


def _psk31_noise(c, t, seed):
    rng = np.random.default_rng(seed)
    x = (np.exp(1j * (0.02 * np.arange(t) + rng.uniform(0, 6, (c, 1))))
         + 0.3 * (rng.normal(size=(c, t)) + 1j * rng.normal(size=(c, t))))
    return Complex(torch.from_numpy(x.real.astype(np.float32)),
                   torch.from_numpy(x.imag.astype(np.float32)))


@pytest.mark.parametrize("t", [1, 5, 8, 13, 1003])
@pytest.mark.parametrize("start", range(8))
def test_bpsk31_kernel_every_ring_start(cuda, start, t):
    """From a warm carry with the ring index at each start 0-7, blocks of
    1 to 1,003 samples (the head, whole turns of the ring and the tail):
    bit for bit the plain version, the new index start + T mod 8."""
    from libsdr_tpu_torch.ops.psk31 import bpsk31_scan, bpsk31_scan_plain
    from libsdr_tpu_torch.tools.psk31_times import bound_op

    op = bound_op(2000.0, 3, t)
    k = op.constants()
    warm, _, _ = bpsk31_scan_plain(_psk31_noise(3, 997, start), op.init_carry(
        "cpu"), **k)
    warm["dl_idx"] = torch.tensor(start, dtype=torch.int32)
    x = _psk31_noise(3, t, 100 + start)
    ref = bpsk31_scan_plain(x, warm, **k)
    got = bpsk31_scan(x.to(cuda), {key: v.to(cuda) for key, v in
                                   warm.items()}, **k)
    assert _psk31_same(got, ref)
    assert int(got[0]["dl_idx"]) == (start + t) % 8


def test_bpsk31_carry_round_trip_cpu_card(cuda):
    """A carry made on the CPU and moved to the card (interop), and back,
    gives the next block the same bits and carry as staying put."""
    from libsdr_tpu_torch import interop
    from libsdr_tpu_torch.ops.psk31 import bpsk31_scan
    from libsdr_tpu_torch.tools.psk31_times import bound_op

    op = bound_op(2000.0, 4, 1003)
    k = op.constants()
    xs = [_psk31_noise(4, 1003, s) for s in range(3)]
    c1, _, _ = bpsk31_scan(xs[0], op.init_carry("cpu"), **k)
    on_card = interop.state_from_numpy(interop.state_to_numpy(c1), cuda)
    got2 = bpsk31_scan(xs[1].to(cuda), on_card, **k)
    ref2 = bpsk31_scan(xs[1], c1, **k)
    assert _psk31_same(got2, ref2)
    back = interop.state_from_numpy(interop.state_to_numpy(got2[0]), "cpu")
    assert _psk31_same(bpsk31_scan(xs[2], back, **k),
                       bpsk31_scan(xs[2].to(cuda), got2[0], **k))
    with pytest.raises(ValueError, match="carry leaf"):
        bpsk31_scan(xs[1].to(cuda), c1, **k)


def test_bpsk31_pipeline_compile_chunked_at_k8(cuda):
    """psk31_rx's pipeline (IQBaseBand to ~2 kHz, BPSK31) through
    compile_chunked at K = 8 on the card: it captures, its outputs and
    carry bit for bit 8 eager steps, one BPSK31 launch a block."""
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.core.graph import _leaves
    from libsdr_tpu_torch.core.ragged import Ragged
    from libsdr_tpu_torch.ops import BPSK31

    rng = np.random.default_rng(16)
    n = 8 * 20_000
    ph = np.repeat(np.cumsum(np.where(rng.random(n // 640 + 1) < 0.5,
                                      np.pi, 0.0)), 640)[:n]
    sig = (0.8 * np.exp(1j * ph) + 0.05 * (rng.normal(size=n) + 1j
                                           * rng.normal(size=n)))
    xs = [cplx.as_block(sig[i * 20_000:(i + 1) * 20_000].astype(
        np.complex64), torch.float32, cuda) for i in range(8)]
    p = P.Pipeline([IQBaseBand(fc=0.0, width=200.0, order=64,
                               out_rate=2000.0, design="textbook"),
                    BPSK31()], name="psk31_rx")
    p.bind(P.StreamSpec(np.complex64, 20_000, 20_000))
    carry, ys = p.init_carry(cuda), []
    for x in xs:
        carry, y = p.apply(carry, x)
        ys.append(y)
    step = p.compile_chunked("unroll")
    c2, ys2 = step(p.init_carry(cuda), tuple(xs))
    torch.cuda.synchronize()
    for a, b in zip(ys2, ys):
        assert isinstance(a, Ragged)
        assert torch.equal(a.data, b.data) and torch.equal(a.valid, b.valid)
    for a, b in zip(_leaves(c2)[0], _leaves(carry)[0]):
        assert torch.equal(a, b)
    (g,) = step.graphs.values()
    assert g.launches["bpsk31_scan"] == 8


def test_bpsk31_float32_phasor_would_part_card_and_host(cuda, monkeypatch):
    """Why both sides take the phasor in float64 rounded to float32: the
    card's float32 cos and sin and numpy's round differently on a share of
    2^22 phases in [-2 pi, 2 pi], and the plain version over W2's PSK31
    group (8 blocks) with numpy's float32 phasor moves bits on channels of
    noise alone and none on the active ones.  Prints the shares and
    counts (``-s``)."""
    from libsdr_tpu_torch.ops import psk31 as ps
    from libsdr_tpu_torch.tools import psk31_times as PT

    rng = np.random.default_rng(16)
    p = rng.uniform(-2 * np.pi, 2 * np.pi, 1 << 22).astype(np.float32)
    pc = torch.from_numpy(p).to(cuda)
    shares = {}
    for name, f_np, f_t in (("cos", np.cos, torch.cos),
                            ("sin", np.sin, torch.sin)):
        card, host = f_t(pc).cpu().numpy(), f_np(p)
        f64 = f_np(p.astype(np.float64)).astype(np.float32)
        shares[name] = dict(card_vs_numpy=float(np.mean(card != host)),
                            card_vs_f64=float(np.mean(card != f64)),
                            numpy_vs_f64=float(np.mean(host != f64)))
    assert all(v["card_vs_numpy"] > 0 for v in shares.values()), shares

    blocks, active, rate = PT.w2_inputs()
    op = PT.bound_op(rate, *blocks[0].re.shape)
    k = op.constants()
    runs = []
    for phasor in (ps._phasor, lambda q: (np.cos(q), np.sin(q))):
        monkeypatch.setattr(ps, "_phasor", phasor)
        carry, outs = op.init_carry("cpu"), []
        for x in blocks:
            carry, bits, emits = ps.bpsk31_scan_plain(x.to("cpu"), carry, **k)
            outs.append((bits.numpy() * emits.numpy(), emits.numpy()))
        runs.append(outs)
    diff = sum(((b64 != b32) | (v64 != v32)).sum(axis=1)
               for (b64, v64), (b32, v32) in zip(*runs))
    print(f"phasor shares apart on 2^22 phases {shares}; W2 with numpy's "
          f"float32 phasor: bits apart on the {int(active.sum())} active "
          f"channels {int(diff[active].sum())}, on the "
          f"{int((~active).sum())} noise channels {int(diff[~active].sum())} "
          f"({int((diff[~active] > 0).sum())} channels)")
    assert diff[active].sum() == 0
    assert diff[~active].sum() > 0


def test_bpsk31_kernel_refuses_what_it_does_not_take(cuda):
    from libsdr_tpu_torch.ops.psk31 import bpsk31_scan
    from libsdr_tpu_torch.tools.psk31_times import bound_op

    op = bound_op(2000.0, 2, 16)
    k = op.constants()
    carry = op.init_carry(cuda)
    z = torch.zeros((2, 16), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bpsk31_scan(Complex(z.half(), z.half()), carry, **k)
    with pytest.raises(ValueError, match=r"\(C, T\)"):
        bpsk31_scan(Complex(z[None], z[None]), carry, **k)
    with pytest.raises(ValueError, match="operand shape"):
        bpsk31_scan(Complex(z[:1], z[:1]), carry, **k)
    # bf16 planes are widened: the float32 block's results
    zb = _psk31_noise(2, 16, 3).to(cuda)
    half = Complex(zb.re.bfloat16(), zb.im.bfloat16())
    assert _psk31_same(bpsk31_scan(half, carry, **k),
                       bpsk31_scan(half.map(lambda a: a.float()), carry, **k))
