"""The port's rate converters (``ops/resample.py``) against the JAX package
on the same numpy inputs, on the CPU: ``SubSample``, ``Resampler`` (3:2 and
1:2, real and complex, carry-chained over blocks) and ``InpolSubSampler``
within 1e-6, with the tone-fidelity checks of tests/test_ops.py (SNR > 45
dB against the ideal resampled tone), and ``FracSubSample``'s reference
quirk (2.5 acts as /3).
"""

import numpy as np
import pytest
import torch

import libsdr_tpu as J
import libsdr_tpu.ops.resample as jrs
import libsdr_tpu_torch as P
import libsdr_tpu_torch.ops.resample as prs
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu_torch.core import ConfigError, cplx
from libsdr_tpu_torch.ops import siggen

from tests.conftest import snr_db


def _run(pkg, op, x, fs, block, dtype=np.float32, channels=()):
    """Blocks of ``x`` through ``op`` from its initial carry."""
    op.bind(pkg.StreamSpec(dtype, fs, block, channels=channels))
    carry = op.init_carry() if pkg is J else op.init_carry("cpu")
    outs = []
    for i in range(x.shape[-1] // block):
        xb = x[..., i * block:(i + 1) * block]
        if pkg is J:
            carry, y = op.apply(carry, jcplx.as_block(xb))
            outs.append(jcplx.to_numpy(y))
        else:
            carry, y = op.apply(carry, cplx.as_block(xb, torch.float32,
                                                     "cpu"))
            outs.append(cplx.to_numpy(y))
    return np.concatenate(outs, -1)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_subsample_matches_jax(rng, kind):
    """SubSample(n=4) and SubSample(out_rate) (tests/test_ops.py::
    test_subsample_matches_reference)."""
    x = rng.normal(size=(2, 1024)).astype(np.float32)
    dt = np.float32
    if kind == "complex":
        x = (x + 1j * rng.normal(size=(2, 1024))).astype(np.complex64)
        dt = np.complex64
    want = _run(J, jrs.SubSample(n=4), x, 48000, 256, dt, (2,))
    got = _run(P, prs.SubSample(n=4), x, 48000, 256, dt, (2,))
    np.testing.assert_allclose(got, want, atol=1e-6)
    ref = x.reshape(2, -1, 4).mean(-1)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    got2 = _run(P, prs.SubSample(out_rate=12000), x, 48000, 256, dt, (2,))
    np.testing.assert_array_equal(got2, got)
    with pytest.raises(ValueError):
        prs.SubSample()


def test_fracsubsample_reference_quirk():
    """FracSubSample(2.5) acts as /3 (the reference resets its phase
    accumulator on emit, src/subsample.hh:168-175)."""
    assert prs.FracSubSample(2.5).n == jrs.FracSubSample(2.5).n == 3
    assert prs.FracSubSample(2.0).n == 2
    with pytest.raises(ConfigError):
        prs.FracSubSample(0.5)


@pytest.mark.parametrize("p,q,fs,n,block,tone,kind", [
    (3, 2, 48000, 9600, 1200, 1000.0, "real"),     # 3:2, out 32 kHz
    (1, 2, 8000, 4000, 1000, 440.0, "real"),       # 2x upsample
    (3, 2, 48000, 9600, 1200, 1000.0, "complex"),
])
def test_resampler_matches_jax_and_tone(p, q, fs, n, block, tone, kind):
    """Resampler against JAX's within 1e-6 over carry-chained blocks, and
    the tone after the polyphase interpolator at SNR > 45 dB against the
    ideal tone at the output times (tests/test_ops.py::
    test_resampler_tone_fidelity, test_resampler_upsample)."""
    x = siggen.sine(fs, n, tone).astype(np.float32)
    dt = np.float32
    if kind == "complex":
        x = np.exp(2j * np.pi * tone * np.arange(n) / fs).astype(np.complex64)
        dt = np.complex64
    want = _run(J, jrs.Resampler(p=p, q=q), x, fs, block, dt)
    rs = prs.Resampler(p=p, q=q)
    got = _run(P, rs, x, fs, block, dt)
    assert rs.out_spec.block_size == block * q // p
    assert float(rs.out_spec.sample_rate) == fs * q / p
    np.testing.assert_allclose(got, want, atol=1e-6)
    # output o lands at input time o*p/q - 4 (a constant 4-sample latency)
    t_out = (np.arange(len(got)) * p / q - 4) / fs
    ideal = (np.exp(2j * np.pi * tone * t_out) if kind == "complex"
             else np.sin(2 * np.pi * tone * t_out))
    assert snr_db(ideal[50:-50], got[50:-50]) > 45


def test_inpol_subsampler_matches_jax(rng):
    """InpolSubSampler(frac) = Resampler(p/q of frac): 1.5 and 2 against
    JAX's on a two-channel complex bank; a block that does not divide
    raises ConfigError."""
    x = (rng.normal(size=(2, 4800)) + 1j * rng.normal(size=(2, 4800))
         ).astype(np.complex64)
    for frac in (1.5, 2.0):
        want = _run(J, jrs.InpolSubSampler(frac), x, 48000, 1200,
                    np.complex64, (2,))
        got = _run(P, prs.InpolSubSampler(frac), x, 48000, 1200,
                   np.complex64, (2,))
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert (prs.Resampler(frac=1.5).p, prs.Resampler(frac=1.5).q) == (3, 2)
    with pytest.raises(ConfigError):
        prs.InpolSubSampler(0)
    with pytest.raises(ConfigError):
        prs.Resampler(p=3, q=2).bind(P.StreamSpec(np.float32, 48000, 1000))


def test_resampler_constants_follow_the_block():
    """The gather indices and tap rows are made at bind and placed on the
    block's device at first use (on the CPU here), once."""
    rs = prs.Resampler(p=3, q=2)
    rs.bind(P.StreamSpec(np.float32, 48000, 1200))
    assert rs._consts == {}
    c = rs.init_carry("cpu")
    rs.apply(c, torch.zeros(1200))
    idx, w = rs._consts["cpu"]
    assert idx.shape == (800, 8) and w.shape == (800, 8)
    rs.apply(c, torch.zeros(1200))
    assert list(rs._consts) == ["cpu"]
