"""Slice 5 of the port against the JAX package on the CPU: the v1 FIR (K5,
``ops/fir_mxu.fir_mxu``) and its FM/AM epilogues (K6, ``fir_fm_mxu``)
against the JAX kernels in interpret mode, ``fir_overlap_save`` at offsets
other than stride - 1 (K5's route on the card), ``FIRFilter.set_freq`` /
``set_order``, the real-input ``BaseBand`` through the fold rule, and the
stages' ``init_carry`` default.

On CPU tensors the entries run their plain PyTorch versions; the CUDA
kernels are held to those on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Bounds, each at or inside the JAX tests' own
(tests/test_pallas.py: 1e-4 of the largest output for the FIR, 5e-3 x
max(1, |v|) for the FM and AM+AGC audio):

* FIR, every output: 1e-5 of the largest (float32 sums against the JAX
  kernel's 3-pass bf16 split, ~5e-6 measured);
* FM audio: 5e-3 x max(1, |v|) rad (the JAX bound; an output where |y| is
  near 0 amplifies the two FIRs' difference into its angle, ~1.5e-3 at
  worst here);
* AM audio, with or without the AGC: 1e-4 x max(1, |v|) (~2e-5 measured);
  the AGC's exported state 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libsdr_tpu as J
import libsdr_tpu_torch as P
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu.ops import pallas_fir_mxu as pfm
from libsdr_tpu.ops.fir import fir_overlap_save as jax_fir_overlap_save
from libsdr_tpu.ops.fir import kernel_mode
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import ConfigError, RuntimeSDRError
from libsdr_tpu_torch.ops import fir_mxu as M
from libsdr_tpu_torch.ops.fir import fir_overlap_save

FIR_REL = 1e-5
FM_BOUND = 5e-3
AM_BOUND = 1e-4
SD_REL = 1e-5


def _pair(x):
    """numpy complex (C, B) -> (JAX Complex, torch Complex), same planes."""
    return jcplx.as_block(x), Complex(torch.from_numpy(x.real.copy()),
                                      torch.from_numpy(x.imag.copy()))


def _bank(rng, c, b):
    return (rng.normal(size=(c, b)) + 1j * rng.normal(size=(c, b))
            ).astype(np.complex64)


def _np(y):
    return y.re.numpy() + 1j * y.im.numpy()


@pytest.mark.parametrize("c,s0,dtype", [(8, 1, "float32"), (8, 0, "float32"),
                                        (8, 2, "float32"),
                                        (64, 1, "bfloat16")])
def test_fir_mxu_matches_jax_kernel(c, s0, dtype):
    """K5's plain version against the JAX kernel (interpret mode) at the
    JAX tests' shapes (C = 8, D = 2, T = 37, s0 = 1; C = 64 bf16 planes)
    and window starts 0 and D: every output, the last 128 included, whose
    windows read the block's last frame again."""
    rng = np.random.default_rng(100 + c + s0)
    d, t = 2, 37
    b = 2 * pfm._ft_for(d, c, 16 * 256, 2 if dtype == "bfloat16" else 4) \
        * pfm._S * d
    assert pfm.mxu_fir_supported(t, d, s0, c, b, dtype=jnp.dtype(dtype))
    assert M.mxu_fir_supported(t, d, s0, c, b)
    x = _bank(rng, c, b)
    g = rng.normal(size=t) + 1j * rng.normal(size=t)
    jx, tx = _pair(x)
    if dtype == "bfloat16":
        jx = jcplx.Complex(jx.re.astype(jnp.bfloat16),
                           jx.im.astype(jnp.bfloat16))
        tx = tx.to(torch.bfloat16)
    jy, jnsp = pfm.fir_mxu(jx, g, d, s0, interpret=True)
    n0 = M.fir_mxu.launches
    ty, tnsp = M.fir_mxu(tx, g, d, s0)
    want = jcplx.to_numpy(jy)
    got = _np(ty)
    assert tnsp == jnsp == 128 and got.shape == want.shape == (c, b // d)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < FIR_REL, err
    assert M.fir_mxu.launches == n0   # the CPU takes the plain version


def _k6_inputs(seed):
    rng = np.random.default_rng(seed)
    c, d, t, s0 = 8, 2, 37, 1
    b = 2 * pfm._FT * pfm._S * d
    x = _bank(rng, c, b)
    g = rng.normal(size=t) + 1j * rng.normal(size=t)
    lead = (rng.normal(size=(c, 1)) + 1j * rng.normal(size=(c, 1))
            ).astype(np.complex64)
    state = rng.uniform(0.3, 1.0, size=(c, 1)).astype(np.float32)
    return x, g, d, s0, lead, state


@pytest.mark.parametrize("deemph", [False, True])
def test_fir_fm_mxu_fm_matches_jax_kernel(deemph):
    """K6 mode 'fm' (+- de-emphasis) against the JAX kernel: nonzero y[-1]
    and de-emphasis state, every output (the clamped last frame too)."""
    x, g, d, s0, lead, state = _k6_inputs(7)
    rot, gain, ab = np.exp(-0.37j), 1.7, (0.93, 0.07)
    jx, tx = _pair(x)
    jl, tl = _pair(lead)
    kw_j = dict(deemph_ab=ab, deemph_lead=jnp.asarray(state)) if deemph \
        else {}
    kw_t = dict(deemph_ab=ab, deemph_lead=torch.from_numpy(state)) \
        if deemph else {}
    want, jnsp = pfm.fir_fm_mxu(jx, g, d, s0, jl, rot, gain, interpret=True,
                                **kw_j)
    got, tnsp = M.fir_fm_mxu(tx, g, d, s0, tl, rot, gain, **kw_t)
    want = np.asarray(want)
    assert tnsp == jnsp and got.shape == want.shape
    err = (np.abs(got.numpy() - want) / np.maximum(1.0, np.abs(want))).max()
    assert err < FM_BOUND, err


@pytest.mark.parametrize("ab", [None, (0.97, 0.03), (0.9, 0.2)])
def test_fir_fm_mxu_am_matches_jax_kernel(ab):
    """K6 mode 'am' against the JAX kernel: the envelope alone, and the AGC
    with (a, 1 - a) and with a b of its own, from a nonzero state; every
    output and the exported state (taken after the invalid last frame)."""
    x, g, d, s0, _, state = _k6_inputs(11)
    gain = 0.125
    jx, tx = _pair(x)
    jr = pfm.fir_fm_mxu(jx, g, d, s0, jcplx.zeros((x.shape[0], 1)), 1.0,
                        gain, deemph_ab=ab,
                        deemph_lead=None if ab is None else jnp.asarray(state),
                        mode="am", interpret=True)
    tr = M.fir_fm_mxu(tx, g, d, s0, None, 1.0, gain, ab,
                      None if ab is None else torch.from_numpy(state),
                      mode="am")
    assert len(tr) == len(jr) == (2 if ab is None else 3)
    want, got = np.asarray(jr[0]), tr[0].numpy()
    err = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()
    assert err < AM_BOUND, err
    if ab is not None:
        sd_want, sd_got = np.asarray(jr[1]), tr[1].numpy()
        assert sd_got.shape == sd_want.shape == (x.shape[0], 1)
        assert np.abs(sd_got - sd_want).max() / np.abs(sd_want).max() \
            < SD_REL


@pytest.mark.parametrize("offset", [0, 1, 4, 9])
def test_fir_overlap_save_offsets_match_jax(offset, monkeypatch):
    """fir_overlap_save at offsets 0, 1, D and 2D+1 (D = 4, T = 67, 64
    channels), 3 carry-chained blocks: the port (and K5's overlap-save
    plain version, fir_offset) against JAX in interpret mode, where it
    takes K5 through _try_pallas_mxu, and against JAX's default path."""
    rng = np.random.default_rng(40 + offset)
    c, d, t, b = 64, 4, 67, 4096
    x = _bank(rng, c, 3 * b)
    g = rng.normal(size=t) + 1j * rng.normal(size=t)
    k5_calls = []
    real_fir_mxu = pfm.fir_mxu

    def counted(*a, **kw):
        k5_calls.append(a[3])
        return real_fir_mxu(*a, **kw)

    monkeypatch.setattr(pfm, "fir_mxu", counted)
    jtails = {"interpret": jcplx.zeros((c, t - 1)),
              "auto": jcplx.zeros((c, t - 1))}
    tail = Complex(torch.zeros(c, t - 1), torch.zeros(c, t - 1))
    for k in range(3):
        jx, tx = _pair(x[:, k * b:(k + 1) * b])
        ys = {}
        for mode in jtails:
            with kernel_mode(mode):
                y, jtails[mode] = jax_fir_overlap_save(g, jx, jtails[mode],
                                                       stride=d,
                                                       offset=offset)
            ys[mode] = jcplx.to_numpy(y)
        y_off = _np(M.fir_offset(tx, g, d, offset, tail))
        ty, tail = fir_overlap_save(g, tx, tail, stride=d, offset=offset)
        got = _np(ty)
        assert got.shape == ys["auto"].shape == (c,
                                                 (b - offset - 1) // d + 1)
        scale = np.abs(ys["auto"]).max()
        for want in (ys["interpret"], ys["auto"], y_off):
            assert np.abs(got - want).max() / scale < FIR_REL
        np.testing.assert_array_equal(_np(tail), jcplx.to_numpy(
            jtails["auto"]))
    # the JAX package took K5 at the in-block window start of the offset
    assert len(k5_calls) == 3 and set(k5_calls) == {
        offset + (-(-(t - 1 - offset) // d)) * d - (t - 1)}


def test_fir_filter_set_freq_and_set_order_match_jax():
    """FIRFilter retuned mid-stream (set_freq, same carry) and re-ordered
    (set_order, fresh carry) gives JAX's blocks."""
    rng = np.random.default_rng(5)
    fs, blk = 48_000.0, 2048
    x = _bank(rng, 2, 4 * blk)
    outs = {}
    for pkg, dev in ((J, None), (P, "cpu")):
        f = pkg.ops.FIRFilter(33, kind="bandpass", fl=2000.0, fu=6000.0,
                              decim=2)
        f.bind(pkg.StreamSpec(np.complex64, fs, blk, channels=(2,)))
        c = f.init_carry() if dev is None else f.init_carry(dev)
        ys = []
        for k in range(4):
            if k == 1:
                f.set_freq(fl=1000.0, fu=9000.0)
            if k == 2:
                f.set_order(45)
                c = f.init_carry() if dev is None else f.init_carry(dev)
            xb = x[:, k * blk:(k + 1) * blk]
            c, y = f.apply(c, jcplx.as_block(xb) if pkg is J
                           else _pair(xb)[1])
            ys.append(jcplx.to_numpy(y) if pkg is J else _np(y))
        outs[pkg.__name__] = np.concatenate(ys, -1)
        assert f.taps.shape == (45,)
    want, got = outs["libsdr_tpu"], outs["libsdr_tpu_torch"]
    assert np.abs(got - want).max() / np.abs(want).max() < FIR_REL
    with pytest.raises(ConfigError):
        P.ops.FIRFilter(3, kind="custom", taps=[1, 2, 3]).set_freq(fu=1.0)


@pytest.mark.parametrize("demod", ["fm", "am"])
def test_baseband_real_input_fold_rule_matches_jax(demod):
    """BaseBand (real input) -> FMDemod / AMDemod: the fold rule leaves the
    baseband's NCO out (FMDemod folds the rotation in), as the JAX package
    does; three blocks of a real FM (or AM) carrier match JAX's."""
    fs, blk, fc, n = 96_000.0, 9600, 12_000.0, 3
    t = np.arange(n * blk) / fs
    if demod == "fm":
        sig = np.cos(2 * np.pi * fc * t + 3.0 * np.sin(2 * np.pi * 700 * t))
    else:
        sig = (1 + 0.5 * np.sin(2 * np.pi * 700 * t)) * np.cos(
            2 * np.pi * fc * t)
    sig = sig.astype(np.float32)
    outs = {}
    for pkg, dev in ((J, None), (P, "cpu")):
        dm = pkg.ops.FMDemod() if demod == "fm" else pkg.ops.AMDemod()
        bb = pkg.ops.BaseBand(fc=fc, width=8000.0, order=48, decim=4,
                              design="textbook")
        p = pkg.Pipeline([bb, dm])
        p.bind(pkg.StreamSpec(np.float32, fs, blk))
        assert p.stages[0] is bb and bb.fold_nco
        assert [type(s).__name__ for s in bb._inner.stages] == [
            "ToComplex", "FIRFilter"]
        c = p.init_carry() if dev is None else p.init_carry(dev)
        ys = []
        for k in range(n):
            xb = sig[k * blk:(k + 1) * blk]
            c, y = p.apply(c, jnp.asarray(xb) if pkg is J
                           else torch.from_numpy(xb))
            ys.append(np.asarray(y) if pkg is J else y.numpy())
        outs[pkg.__name__] = np.concatenate(ys)
    want, got = outs["libsdr_tpu"], outs["libsdr_tpu_torch"]
    assert got.shape == want.shape == (n * blk // 4,)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def _stages():
    ops = P.ops
    spec_c = P.StreamSpec(np.complex64, 96_000.0, 960, channels=(2,))
    spec_r = P.StreamSpec(np.float32, 96_000.0, 960, channels=(2,))
    return {
        "FIRFilter": (ops.FIRFilter(16, fu=8000.0), spec_c),
        "IQBaseBand": (ops.IQBaseBand(12e3, 8e3, 32, decim=4), spec_c),
        "BaseBand": (ops.BaseBand(12e3, 8e3, 32, decim=4), spec_r),
        "FMDemod": (ops.FMDemod(), spec_c),
        "FMDeemph": (ops.FMDeemph(), spec_r),
        "AGC": (ops.AGC(), spec_r),
        "FreqShift": (ops.FreqShift(1000.0), spec_c),
        "FMBasebandFused": (P.Pipeline([ops.IQBaseBand(12e3, 8e3, 32,
                                                       decim=4),
                                        ops.FMDemod()]), spec_c),
    }


@pytest.mark.parametrize("name", sorted(_stages()))
def test_stage_init_carry_defaults_to_the_card(name):
    """A stage's init_carry() without a device takes the card, as
    Pipeline.init_carry does: without one it raises RuntimeSDRError;
    device='cpu' puts every leaf on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    stage, spec = _stages()[name]
    stage.bind(spec)
    with pytest.raises(RuntimeSDRError, match="no CUDA device"):
        stage.init_carry()
    from libsdr_tpu_torch.core.graph import _leaves
    leaves, _ = _leaves(stage.init_carry("cpu"))
    assert all(v.device.type == "cpu" for v in leaves
               if isinstance(v, torch.Tensor))
