"""The stream route of the channelizer kernel K4 (``csrc/pfb.cu``), emulated
on the CPU by ``ops/pfb.py::pfb_split``: the N x N register FFT with the
kernel's W_32 literals and twiddle table, the tile split with its P-frame
halo and the demod's recomputed frame before a tile, and the
lane-permuted store.  Held against ``pfb_plain`` and against the JAX
kernel in interpret mode (as ``tests/test_pallas_pfb.py`` runs it).

Bounds, those K4 is held to on the card: Y and the exports within 2e-5 of
the largest |Y| (float32 sums in another order: the register FFT against
torch.fft, or the JAX kernel's matmul DFT); the demod's error median
< 5e-5 and 99th percentile < 1e-3 rad (the angle of a near-zero
z = Y[t] conj(Y[t-1]) is amplified on random data).  The register FFT
alone against numpy's float64 FFT: 2e-6 of the largest output.  Tiles and
chained blocks change no number (each frame's u and Y depend on the frame
alone), so those comparisons are exact.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu.ops import pallas_pfb as jpfb
from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.ops import channelizer, pfb

REL, MEDIAN, P99 = 2e-5, 5e-5, 1e-3
PFB_CU = Path(pfb.__file__).resolve().parents[1] / "csrc" / "pfb.cu"


def _mk(rng, c, f, m, p):
    def cn(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
                ).astype(np.complex64)
    taps3 = channelizer.fold_commutator(channelizer.prototype_lowpass(m, p),
                                        m, p)
    return cn(c, f, m), cn(c, p, m), cn(c, 1, m), taps3


def _t(a):
    return cplx.as_block(np.asarray(a, np.complex64))


def _n(x):
    """The port's value (a Complex or a tensor) or a numpy array, as numpy."""
    if isinstance(x, cplx.Complex):
        return cplx.to_numpy(x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _angle_err(a, b, gain):
    half = np.pi * gain
    return np.abs(np.remainder(a - b + half, 2 * half) - half)


def _check(got, ref, demod, gain=1.7):
    if not demod:
        ref = _n(ref)
        assert np.abs(_n(got) - ref).max() / np.abs(ref).max() < REL
        return
    err = _angle_err(_n(got[0]), _n(ref[0]), gain)
    assert np.median(err) < MEDIAN and np.percentile(err, 99) < P99
    scale = max(np.abs(_n(ref[1])).max(), np.abs(_n(ref[2])).max())
    for k in (1, 2):
        assert np.abs(_n(got[k]) - _n(ref[k])).max() / scale < REL


def _literals(fn: str) -> dict:
    """The float literals of one of pfb.cu's switch functions, by case."""
    src = PFB_CU.read_text()
    body = src[src.index(f"float {fn}(int j)"):]
    body = body[:body.index("\n}\n")]
    vals = {}
    for case, lit in re.findall(r"(?:case (\d+)|default): return ([-0-9.e]+)f",
                                body):
        vals[int(case) if case else 15] = np.float32(float(lit))
    return vals


def test_kernel_literals_and_gate_are_the_emulations():
    """pfb.cu's W_32 literals round to W32, and its stream-route gate is
    stream_route's."""
    for fn, table in (("w32_re", pfb.W32[0]), ("w32_im", pfb.W32[1])):
        vals = _literals(fn)
        assert sorted(vals) == [j for j in range(1, 16) if j != 8]
        for j, v in vals.items():
            assert v == table[j], (fn, j, v, table[j])
    src = PFB_CU.read_text()
    gate = src[src.index("int stream_log2n(int M, int P)"):]
    gate = gate[:gate.index("\n}\n")]
    ms = [int(v) for v in re.findall(r"case (\d+): return", gate)]
    assert ms == [n * n for n in pfb.STREAM_N]
    assert f"kStreamP = {pfb.STREAM_P};" in src
    assert [m for m in range(1, 8193) if pfb.stream_route(m, 8)] == ms
    assert not any(pfb.stream_route(m, p) for m in ms for p in (1, 7, 9, 32))


@pytest.mark.parametrize("logn", [2, 3, 4, 5])
def test_fft_reg_is_the_dft(logn):
    """The register FFT (bit-reversed out) against numpy's float64 FFT."""
    rng = np.random.default_rng(logn)
    n = 1 << logn
    x = rng.normal(size=(7, n)) + 1j * rng.normal(size=(7, n))
    re, im = pfb.fft_reg(torch.tensor(x.real, dtype=torch.float32),
                         torch.tensor(x.imag, dtype=torch.float32), logn)
    got = (re + 1j * im).numpy()[:, pfb._bitrev(logn)]
    ref = np.fft.fft(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-6


@pytest.mark.parametrize("m", [16, 64, 256, 1024])
def test_stream_fft_and_store(m):
    """The four-step DFT against numpy's, and the store's lane order
    against lane_of_channel."""
    rng = np.random.default_rng(m)
    x = (rng.normal(size=(3, m)) + 1j * rng.normal(size=(3, m)))
    y = pfb.stream_fft(_t(x))
    ref = np.fft.fft(x.astype(np.complex64).astype(np.complex128))
    assert np.abs(_n(y) - ref).max() / np.abs(ref).max() < 2e-6
    lanes = _n(pfb.stream_store(y))
    np.testing.assert_array_equal(lanes[:, pfb.lane_of_channel(m)], _n(y))


@pytest.mark.parametrize("demod", [False, True])
@pytest.mark.parametrize("m", [16, 64, 256, 1024])
def test_split_matches_plain(m, demod):
    """Over F 3 (< P) and 21, C 1 and 2, and tiles of the whole block, 5
    frames and 8 frames (tile edges inside the block; the demod recomputes
    the frame before each later tile)."""
    rng = np.random.default_rng(10 * m + demod)
    for f in (3, 21):
        for c in (1, 2):
            x, hist, prev, taps3 = _mk(rng, c, f, m, 8)
            args = (_t(x), _t(hist), taps3, m, 1.7, _t(prev), demod)
            ref = pfb.pfb_plain(*args)
            for tt in (None, 5, 8):
                _check(pfb.pfb_split(*args, tt=tt), ref, demod)


@pytest.mark.parametrize("demod", [False, True])
@pytest.mark.parametrize("m", [256, 1024])
def test_split_matches_jax_kernel(rng, m, demod):
    """Against the JAX kernel in interpret mode on one stream of 32 frames,
    in tiles of 12 (edges at frames 12 and 24)."""
    x, hist, prev, taps3 = _mk(rng, 1, 32, m, 8)
    jx = jcplx.as_block(x[0])
    jh = jcplx.as_block(hist[0])
    if demod:
        ja, jl, j0 = jpfb.pfb_mxu(jx, jh, taps3, m, gain=1.7,
                                  prev=jcplx.as_block(prev[0]), demod=True,
                                  interpret=True)
        ref = (np.asarray(ja), jcplx.to_numpy(jl), jcplx.to_numpy(j0))
        got = pfb.pfb_split(_t(x[0]), _t(hist[0]), taps3, m, 1.7,
                            _t(prev[0]), True, tt=12)
    else:
        ref = jcplx.to_numpy(jpfb.pfb_mxu(jx, jh, taps3, m, interpret=True))
        got = pfb.pfb_split(_t(x[0]), _t(hist[0]), taps3, m, tt=12)
    _check(got, ref, demod)


@pytest.mark.parametrize("demod", [False, True])
def test_split_tiles_and_chained_blocks_change_no_number(demod):
    """Any tile size gives the same numbers, and three carry-chained blocks
    (hist = the last P frames, prev = the y_last export) give what one
    block of all their frames gives."""
    rng = np.random.default_rng(3)
    m, p, f = 256, 8, 16
    x, hist, prev, taps3 = _mk(rng, 2, 3 * f, m, p)
    one = pfb.pfb_split(_t(x), _t(hist), taps3, m, 1.7, _t(prev), demod)
    first = lambda r: r[0] if demod else r.re  # noqa: E731
    for tt in (1, 7, 16, 40):
        got = pfb.pfb_split(_t(x), _t(hist), taps3, m, 1.7, _t(prev), demod,
                            tt=tt)
        assert torch.equal(first(got), first(one))
    outs, h, pv = [], hist, prev
    for i in range(3):
        blk = x[:, i * f:(i + 1) * f]
        r = pfb.pfb_split(_t(blk), _t(h), taps3, m, 1.7, _t(pv), demod,
                          tt=5)
        outs.append(first(r))
        h = blk[:, f - p:]
        if demod:
            pv = _n(r[1])
    assert torch.equal(torch.cat(outs, 1), first(one))


def test_split_refuses_what_the_route_does_not_take():
    rng = np.random.default_rng(4)
    for m, p in ((128, 8), (1024, 4), (4096, 8)):
        x, hist, prev, taps3 = _mk(rng, 1, 4, m, p)
        with pytest.raises(ValueError, match="stream-route"):
            pfb.pfb_split(_t(x), _t(hist), taps3, m)
