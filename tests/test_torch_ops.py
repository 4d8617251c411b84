"""The port's modules one by one against their JAX counterparts, on the
same numpy inputs: planar complex, stream specs, the first-order IIR, the
streaming FIR, the NCO, FM demodulation and de-emphasis, baseband selection
and the fusion pass.  Tolerances are float32 round-off unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libsdr_tpu as J
import libsdr_tpu_torch as P
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu.ops import FMDemod as JFMDemod
from libsdr_tpu.ops import FreqShift as JFreqShift
from libsdr_tpu.ops.fir import FIRFilter as JFIRFilter
from libsdr_tpu.ops.iir import iir_first_order as j_iir
from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.stream import (ConfigError, StreamSpec,
                                          real_dtype_of, result_dtype)
from libsdr_tpu_torch.ops import (FIRFilter, FMDeemph, FMDemod, FreqShift,
                                  IQBaseBand, firdesign, iir_first_order,
                                  set_mxu_precision, siggen)


def _cx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def _stream(jp, pp, blocks):
    """Run the same numpy blocks through a JAX and a port processor."""
    jc, pc = jp.init_carry(), pp.init_carry("cpu")
    jo, po = [], []
    for blk in blocks:
        jc, jy = jp.apply(jc, jcplx.as_block(blk))
        pc, py = pp.apply(pc, cplx.as_block(blk))
        jo.append(jcplx.to_numpy(jy))
        po.append(cplx.to_numpy(py))
    return np.concatenate(jo, -1), np.concatenate(po, -1)


def test_stream_spec_dtypes_and_rates():
    s = StreamSpec(np.complex64, 960_000.0, 4096, channels=(3,))
    assert s.dtype == torch.complex64 and s.is_complex
    assert s.real_dtype == torch.float32
    assert s.shape == (3, 4096)
    assert s.sample_rate / 4 == 240_000
    s16 = s.with_(plane_dtype=torch.bfloat16)
    assert s16.real_dtype == torch.bfloat16 and s16.dtype == torch.complex64
    assert real_dtype_of(torch.complex128) == torch.float64
    assert result_dtype(np.float32, torch.complex64) == torch.complex64
    with pytest.raises(ConfigError):
        s.require_block_multiple("x", 3)
    with pytest.raises(ConfigError):
        s.require_real("x")


def test_complex_planes_round_trip(rng):
    x = _cx(rng, (2, 5))
    c = cplx.as_block(x)
    np.testing.assert_array_equal(cplx.to_numpy(c), x)
    y = _cx(rng, (2, 5))
    got = cplx.to_numpy(c * cplx.as_block(y).conj() + 0.5j)
    np.testing.assert_allclose(got, x * np.conj(y) + 0.5j, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(c.abs().numpy(), np.abs(x), rtol=1e-6)
    cat = cplx.concatenate([c, cplx.zeros((2, 3))])
    assert tuple(cat.shape) == (2, 8)
    bf = cplx.as_block(x, torch.bfloat16)
    assert bf.re.dtype == torch.bfloat16 and bf.dtype == torch.complex64


@pytest.mark.parametrize("n", [100, 128, 384, 1000, 40_000])
def test_iir_first_order_matches_jax(rng, n):
    x = rng.normal(size=(3, n)).astype(np.float32)
    y0 = rng.normal(size=3).astype(np.float32)
    a, b = 0.947, 0.053
    yj, lj = j_iir(jnp.asarray(x), a, b, jnp.asarray(y0))
    yt, lt = iir_first_order(torch.from_numpy(x), a, b, torch.from_numpy(y0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind,decim", [("lowpass", 1), ("bandpass", 4),
                                        ("complex", 4), ("complex", 1)])
def test_fir_filter_streams_like_jax(rng, kind, decim):
    fs, block = 48_000.0, 1024
    if kind == "complex":
        taps = firdesign.complex_bandpass(31, 6000.0, 4000.0, fs)
        mk = dict(order=31, kind="custom", taps=taps, decim=decim)
    else:
        mk = dict(order=33, kind=kind, fl=2000.0, fu=6000.0, decim=decim)
    jf, pf = JFIRFilter(**mk), FIRFilter(**mk)
    jf.bind(J.StreamSpec(jnp.complex64, fs, block, channels=(2,)))
    pf.bind(P.StreamSpec(np.complex64, fs, block, channels=(2,)))
    x = _cx(rng, (2, 3 * block))
    yj, yp = _stream(jf, pf, np.split(x, 3, axis=-1))
    assert yp.shape == yj.shape
    np.testing.assert_allclose(yp, yj, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode,freq", [("exact", 3000.0), ("lut", 3000.0),
                                       ("lut", -4500.0)])
def test_freq_shift_matches_jax(rng, mode, freq):
    fs, block = 48_000.0, 1000
    jn, pn = JFreqShift(freq, mode), FreqShift(freq, mode)
    jn.bind(J.StreamSpec(jnp.complex64, fs, block))
    pn.bind(P.StreamSpec(np.complex64, fs, block))
    x = _cx(rng, (3 * block,))
    yj, yp = _stream(jn, pn, np.split(x, 3))
    np.testing.assert_allclose(yp, yj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["quadrature", "ref"])
def test_fm_demod_matches_jax(rng, mode):
    fs, block = 48_000.0, 512
    audio = siggen.sine(fs, 3 * block, 700.0, amps=0.7)
    x = siggen.fm_modulate(fs, audio, deviation=5000.0, carrier=1000.0)
    jd, pd = JFMDemod(mode, gain=1.7), FMDemod(mode, gain=1.7)
    jd.bind(J.StreamSpec(jnp.complex64, fs, block))
    pd.bind(P.StreamSpec(np.complex64, fs, block))
    yj, yp = _stream(jd, pd, np.split(x, 3))
    np.testing.assert_allclose(yp, yj, rtol=1e-5, atol=1e-5)


def test_freq_shift_folds_into_fm_demod_like_jax(rng):
    """Fusion rule 1: FreqShift -> FMDemod drops the mixer; the JAX package
    applies the same rule on every backend."""
    fs, block = 48_000.0, 512
    x = _cx(rng, (3 * block,))
    jp = J.Pipeline([JFreqShift(2500.0), JFMDemod()])
    jp.bind(J.StreamSpec(jnp.complex64, fs, block))
    pp = P.Pipeline([FreqShift(2500.0), FMDemod()])
    pp.bind(P.StreamSpec(np.complex64, fs, block))
    assert [type(s) for s in pp.stages] == [FMDemod]
    yj, yp = _stream(jp, pp, np.split(x, 3))
    np.testing.assert_allclose(yp, yj, rtol=1e-5, atol=1e-5)
    # and it equals the unfused chain
    pu = P.Pipeline([FreqShift(2500.0), FMDemod()], optimize=False)
    pu.bind(P.StreamSpec(np.complex64, fs, block))
    _, yu = _stream(jp, pu, np.split(x, 3))
    np.testing.assert_allclose(yp, yu, rtol=1e-4, atol=1e-4)


def test_pipeline_binds_unfused_when_fused_op_refuses(monkeypatch, rng):
    """Pipeline._bind restores the original stages, with the fusion state
    cleared, when a fused op raises ConfigError."""
    from libsdr_tpu_torch.ops.fm_fused import FMBasebandFused

    def refuse(self, spec):
        raise ConfigError("refused")

    monkeypatch.setattr(FMBasebandFused, "_bind", refuse)
    rx = P.Pipeline([IQBaseBand(fc=12000, width=9000, order=32, decim=4,
                                design="textbook"), FMDemod(), FMDeemph()])
    rx.bind(P.StreamSpec(np.complex64, 96_000.0, 2048, channels=(2,)))
    assert [type(s) for s in rx.stages] == [IQBaseBand, FMDemod, FMDeemph]
    assert rx.stages[1]._pending_rot_freqs == []
    carry, y = rx.apply(rx.init_carry("cpu"),
                        cplx.as_block(_cx(rng, (2, 2048))))
    assert tuple(y.shape) == (2, 512)


def test_set_mxu_precision_accepts_jax_modes():
    set_mxu_precision("fast")
    set_mxu_precision("high")
    with pytest.raises(ConfigError):
        set_mxu_precision("turbo")
