"""The port's Q14 fixed-point chain (``ops/fixedpoint.py``) bit for bit
against the JAX package and against the Python re-statements of the
reference's C++ in tests/test_fixedpoint.py, on the CPU:
``fast_atan2_i16``, ``IQBaseBandInt`` (NCO on and off, decim 1 and 4,
three carry-chained blocks, the first-group quirk), ``FMDemodInt`` (float
and integer planes, with and without ``ref_block_quirk``) and
``FMDeemphInt``.  The same chain on the card is held against this one in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libsdr_tpu as J
import libsdr_tpu.ops.fixedpoint as jfx
import libsdr_tpu_torch as P
import libsdr_tpu_torch.ops.fixedpoint as pfx
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu_torch.core import ConfigError, cplx

from tests.test_fixedpoint import _fast_atan2_py, _iqbaseband_int_oracle


def _pcx(re, im):
    return cplx.Complex(torch.as_tensor(np.asarray(re, np.int32)),
                        torch.as_tensor(np.asarray(im, np.int32)))


def _jcx(re, im):
    return jcplx.Complex(jnp.asarray(np.asarray(re, np.int32)),
                         jnp.asarray(np.asarray(im, np.int32)))


def test_fast_atan2_matches_jax_and_reference(rng):
    a = rng.integers(-32768, 32768, 5000).astype(np.int32)
    b = rng.integers(-32768, 32768, 5000).astype(np.int32)
    cases = np.array([(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1),
                      (32767, -32768), (-32768, -32768), (-32768, 32767),
                      (5, 5), (-5, 5), (5, -5), (7, -7)], np.int32)
    a = np.concatenate([a, cases[:, 0]])
    b = np.concatenate([b, cases[:, 1]])
    got = pfx.fast_atan2_i16(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    want = np.asarray(jfx.fast_atan2_i16(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = [_fast_atan2_py(int(x), int(y)) for x, y in zip(a, b)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(pfx.fast_atan2_i16(torch.tensor([1000]),
                                  torch.tensor([0]))[0]) == 1 << 13


@pytest.mark.parametrize("fc,decim", [(12000.0, 4), (0.0, 4), (-12000.0, 4),
                                      (12000.0, 1), (0.0, 1)])
def test_iqbaseband_int_matches_jax_and_cpp_loop(rng, fc, decim):
    """Three chained blocks with the NCO on (both signs) and off, at decim 4
    (the first-group quirk and first_block_pad) and 1: the port's planes
    equal JAX's, and the emitted stream the per-sample C++-faithful loop's
    (tests/test_fixedpoint.py)."""
    fs, width, order, B, n_blocks = 96000.0, 11000.0, 21, 480, 3
    x = (rng.integers(-12000, 12000, size=n_blocks * B)
         + 1j * rng.integers(-12000, 12000, size=n_blocks * B))
    outs = {}
    for pkg, mod in ((J, jfx), (P, pfx)):
        bb = mod.IQBaseBandInt(fc=fc, width=width, order=order, decim=decim)
        bb.bind(pkg.StreamSpec(np.complex64, fs, B))
        carry = bb.init_carry() if pkg is J else bb.init_carry("cpu")
        ys = []
        for k in range(n_blocks):
            blk = x[k * B:(k + 1) * B]
            xb = (_jcx(blk.real, blk.imag) if pkg is J
                  else _pcx(blk.real, blk.imag))
            carry, y = bb.apply(carry, xb)
            ys.append(np.asarray(y.re) + 1j * np.asarray(y.im))
        outs[pkg.__name__] = ys
        if pkg is P:
            assert y.re.dtype == torch.int32
            assert bb.out_spec.dtype == torch.int32
            assert bb.first_block_pad == 1
    for got, want in zip(outs["libsdr_tpu_torch"], outs["libsdr_tpu"]):
        np.testing.assert_array_equal(got, want)
    if decim > 1:
        got = np.concatenate([outs["libsdr_tpu_torch"][0][:-1]]
                             + outs["libsdr_tpu_torch"][1:])
        ref = _iqbaseband_int_oracle(x, fc, fc, width, order, decim, fs)
        assert len(got) == len(ref)
        np.testing.assert_array_equal(got.real, ref[:, 0])
        np.testing.assert_array_equal(got.imag, ref[:, 1])


def test_iqbaseband_int_needs_two_groups():
    bb = pfx.IQBaseBandInt(fc=0, width=1e3, order=5, decim=8)
    bb.bind(P.StreamSpec(np.complex64, 48000, 8))
    with pytest.raises(ConfigError):
        bb.apply(bb.init_carry("cpu"), _pcx(np.zeros(8), np.zeros(8)))


def _demod_loop(re, im, last=0):
    """tests/test_fixedpoint.py's Python loop of src/demod.hh:242-254."""
    out = []
    for k in range(len(re)):
        phi = int(_fast_atan2_py(int(re[k]), int(im[k])) / 2)   # trunc
        d = last - phi
        out.append(((d + (1 << 15)) & 0xFFFF) - (1 << 15))      # int16 wrap
        last = phi
    return np.asarray(out)


@pytest.mark.parametrize("planes", ["float", "int"])
@pytest.mark.parametrize("quirk", [False, True])
def test_fm_demod_int_matches_jax(rng, planes, quirk):
    """Three chained blocks of float planes (scaled onto the int16 grid) or
    integer planes, with and without ref_block_quirk, against JAX's; without
    the quirk also against the Python loop."""
    n, blocks = 512, 3
    re = rng.integers(-32768, 32768, n * blocks).astype(np.int32)
    im = rng.integers(-32768, 32768, n * blocks).astype(np.int32)
    outs = {}
    for pkg, mod in ((J, jfx), (P, pfx)):
        dm = mod.FMDemodInt(ref_block_quirk=quirk)
        dm.bind(pkg.StreamSpec(np.complex64, 24000, n))
        carry = dm.init_carry() if pkg is J else dm.init_carry("cpu")
        ys = []
        for k in range(blocks):
            r, i = re[k * n:(k + 1) * n], im[k * n:(k + 1) * n]
            if planes == "float":
                xf = ((r + 1j * i) / 32767.0).astype(np.complex64)
                xb = (jcplx.as_block(xf) if pkg is J
                      else cplx.as_block(xf, torch.float32, "cpu"))
            else:
                xb = _jcx(r, i) if pkg is J else _pcx(r, i)
            carry, y = dm.apply(carry, xb)
            ys.append(np.asarray(y))
        outs[pkg.__name__] = np.concatenate(ys)
    got = outs["libsdr_tpu_torch"]
    np.testing.assert_array_equal(got, outs["libsdr_tpu"])
    if not quirk:
        np.testing.assert_array_equal(got, _demod_loop(re, im))


def _deemph_loop(x, fs):
    alpha = int(round(1.0 / (1.0 - math.exp(-1.0 / (fs * 75e-6)))))

    def w16(a):
        return ((int(a) + (1 << 15)) & 0xFFFF) - (1 << 15)

    avg, ref = 0, []
    for v in x:
        diff = w16(int(v) - avg)
        if diff > 0:
            avg = w16(avg + (diff + alpha // 2) // alpha)
        else:
            avg = w16(avg + -((-(diff - alpha // 2)) // alpha))
        ref.append(avg)
    return np.array(ref)


def test_fm_deemph_int_matches_jax_and_cpp_loop(rng):
    """Two chained blocks on three channels against JAX's lax.scan and, per
    channel, the C++-faithful loop (tests/test_fixedpoint.py)."""
    fs = 22050.0
    x = rng.integers(-30000, 30000, size=(3, 400)).astype(np.int32)
    outs = {}
    for pkg, mod in ((J, jfx), (P, pfx)):
        de = mod.FMDeemphInt()
        de.bind(pkg.StreamSpec(np.float32, fs, 200, channels=(3,)))
        carry = de.init_carry() if pkg is J else de.init_carry("cpu")
        ys = []
        for k in range(2):
            xb = x[:, k * 200:(k + 1) * 200]
            xb = jnp.asarray(xb) if pkg is J else torch.from_numpy(xb)
            carry, y = de.apply(carry, xb)
            ys.append(np.asarray(y))
        outs[pkg.__name__] = np.concatenate(ys, -1)
    got = outs["libsdr_tpu_torch"]
    np.testing.assert_array_equal(got, outs["libsdr_tpu"])
    for ch in range(3):
        np.testing.assert_array_equal(got[ch], _deemph_loop(x[ch], fs))


def test_q14_chain_matches_jax(rng):
    """IQBaseBandInt -> FMDemodInt(ref_block_quirk) -> FMDeemphInt, each
    stage bound on its own spec as the JAX package's golden chain does
    (tests/test_golden_cpp.py::_int_chain_audio), over three blocks of a
    two-channel int16 FM capture: the audio equals JAX's bit for bit."""
    fs, b = 240_000.0, 2400
    t = np.arange(3 * b) / fs
    audio = np.sin(2 * np.pi * 700 * t)
    iq = []
    for ch in range(2):
        ph = 2 * np.pi * (3000.0 * ch * t) + 4.0 * np.cumsum(audio) / fs * 2e3
        sig = 9000 * np.exp(1j * ph) + rng.normal(size=t.shape) * 200
        iq.append(np.round(sig.real) + 1j * np.round(sig.imag))
    iq = np.stack(iq)
    outs = {}
    for pkg, mod in ((J, jfx), (P, pfx)):
        bb = mod.IQBaseBandInt(fc=3000.0, width=12.5e3, order=21, decim=10)
        dm = mod.FMDemodInt(ref_block_quirk=True)
        de = mod.FMDeemphInt()
        bb.bind(pkg.StreamSpec(np.complex64, fs, b, channels=(2,)))
        dm.bind(pkg.StreamSpec(np.complex64, fs / 10, b // 10,
                               channels=(2,)))
        de.bind(pkg.StreamSpec(np.float32, fs / 10, b // 10, channels=(2,)))
        if pkg is J:
            cs = [bb.init_carry(), dm.init_carry(), de.init_carry()]
        else:
            cs = [s.init_carry("cpu") for s in (bb, dm, de)]
        ys = []
        for k in range(3):
            blk = iq[:, k * b:(k + 1) * b]
            y = _jcx(blk.real, blk.imag) if pkg is J else _pcx(blk.real,
                                                               blk.imag)
            for i, stage in enumerate((bb, dm, de)):
                cs[i], y = stage.apply(cs[i], y)
            ys.append(np.asarray(y))
        outs[pkg.__name__] = np.concatenate(ys, -1)
    np.testing.assert_array_equal(outs["libsdr_tpu_torch"],
                                  outs["libsdr_tpu"])
    assert np.abs(outs["libsdr_tpu_torch"]).max() > 100


def deemph_blocks(rng, c, t, k=3):
    """k blocks of (c, t) int16-range samples for FMDeemphInt: uniform over
    the whole int16 range (so ``x - avg`` wraps often), with runs at the
    edges -32768 and 32767 and jumps from one edge to the other."""
    x = rng.integers(-32768, 32768, size=(c, k * t)).astype(np.int32)
    edges = np.array([-32768, 32767, -32768, -32768, 32767, 32767, 0,
                      -32768], np.int32)
    for ch in range(c):
        at = int(rng.integers(0, max(1, k * t - len(edges))))
        x[ch, at:at + len(edges)] = edges[:k * t - at]
    return [x[:, i * t:(i + 1) * t] for i in range(k)]


@pytest.mark.parametrize("fs,c,t", [
    (fs, c, t) for fs in (24_000.0, 48_000.0, 240_000.0)
    for c, t in ((1, 1), (64, 7), (1, 2401), (64, 2401))]
    + [(1000.0, 64, 7)])
def test_deemph_int_plain_matches_jax(fs, c, t):
    """FMDeemphInt's plain path (``deemph_int_plain``, what a CPU block
    runs) bit for bit against JAX's lax.scan, with the carry across three
    blocks, on inputs at the int16 edges; alpha 1 (1 kHz), 2 (24 kHz, the
    Q14 chain's output rate: 240 kHz after decim 10), 4 and 19
    (240 kHz)."""
    blocks = deemph_blocks(np.random.default_rng(int(fs) + 7 * c + t), c, t)
    outs = {}
    for pkg, mod in ((J, jfx), (P, pfx)):
        de = mod.FMDeemphInt()
        de.bind(pkg.StreamSpec(np.float32, fs, t, channels=(c,)))
        carry = de.init_carry() if pkg is J else de.init_carry("cpu")
        ys = []
        for xb in blocks:
            xb = jnp.asarray(xb) if pkg is J else torch.from_numpy(xb)
            carry, y = de.apply(carry, xb)
            ys.append(np.asarray(y))
        outs[pkg.__name__] = (np.concatenate(ys, -1), np.asarray(carry))
        alpha = de._alpha
    assert alpha == {1000.0: 1, 24_000.0: 2, 48_000.0: 4,
                     240_000.0: 19}[fs]
    for got, want in zip(outs["libsdr_tpu_torch"], outs["libsdr_tpu"]):
        np.testing.assert_array_equal(got, want)


def test_deemph_int_dispatch_and_launch_count():
    """A CPU block takes the plain version and launches nothing; a carry on
    another device than the block's is refused; leading stream axes pass
    through."""
    x = torch.from_numpy(deemph_blocks(np.random.default_rng(3), 6, 33,
                                       k=1)[0]).reshape(2, 3, 33)
    avg = torch.zeros((2, 3), dtype=torch.int32)
    n = pfx.deemph_int.launches
    a1, y1 = pfx.deemph_int(x, avg, 19)
    a2, y2 = pfx.deemph_int_plain(x.reshape(6, 33), avg.reshape(6), 19)
    assert pfx.deemph_int.launches == n
    assert torch.equal(y1.reshape(6, 33), y2) and torch.equal(
        a1.reshape(6), a2)
    with pytest.raises(ValueError, match="alpha must be >= 1"):
        pfx.deemph_int(x, avg, 0)
    with pytest.raises(ValueError, match="carry on"):
        pfx.deemph_int(x, avg.to("meta"), 19)
