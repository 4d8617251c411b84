"""The port's analog modes against the JAX package, on the same numpy inputs:

* the kernel entries ``fir_exact``, ``fir_am_exact`` and ``fir_usb_exact``
  (their plain versions on CPU tensors) against the Pallas kernel
  ``pallas_fir_mxu.fir_exact`` / ``fir_fm_exact(mode=...)`` in interpret
  mode, carry-chained over two blocks, sd export included, and against the
  per-window numpy oracle of tests/test_pallas.py;
* ``AMBasebandFused`` and ``USBBasebandFused`` against JAX's fused ops (XLA
  path, and the Pallas path in interpret mode at 64 channels) and against
  JAX's unfused chains (the cases of tests/test_fuzz_chains.py and
  tests/test_pallas.py::test_am_fused_matches_unfused_pipeline);
* the fused ops' bound constants and carry layouts, and a mid-stream carry
  hand-off in both directions;
* ``AGC``, ``AMDemod``, ``USBDemod``, the ``ops/utils.py`` plumbing and
  ``Pipeline.switch_stages``.

The CUDA kernels are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libsdr_tpu as J
import libsdr_tpu.ops as jops
import libsdr_tpu_torch as P
import libsdr_tpu_torch.ops as pops
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu.core import fuse as jfuse
from libsdr_tpu.ops import fm_fused as jfm_fused
from libsdr_tpu.ops import pallas_fir_mxu as pfm
from libsdr_tpu.ops.fir import kernel_mode
from libsdr_tpu_torch import interop
from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.ops.fir_fm import (fir_am_exact, fir_exact,
                                         fir_usb_exact)
from libsdr_tpu_torch.ops.fm_fused import AMBasebandFused, USBBasebandFused

from tests.conftest import snr_db

FS = 96_000.0


def _cx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def _taps(g):
    return cplx.constant(np.asarray(g, np.complex128), torch.float32)


def _signature(tree):
    """Nesting, shapes and plane dtypes of a carry of either package."""
    if hasattr(tree, "re") and hasattr(tree, "im"):
        return ("complex", _signature(tree.re))
    if isinstance(tree, (tuple, list)):
        return tuple(_signature(t) for t in tree)
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


# -- the kernel entries against the Pallas kernel (interpret mode) ----------

C8, D2 = 8, 2
B2 = 2 * 8 * pfm._S * D2          # the exact-tiling shapes of test_pallas.py
LAM, GAIN = 0.96, 0.125
THETA, A0 = 0.3, np.exp(0.4j)     # USB: per-output NCO step, first phasor
TAPS = [17, 37, 53, 65, 129]


@pytest.mark.parametrize("T", TAPS)
def test_fir_exact_matches_jax_kernel(T):
    """Bound 2e-4 of max |y|: tests/test_pallas.py:338,365 (the JAX
    kernel's 3-pass bf16 split; the port's plain version is float32)."""
    rng = np.random.default_rng(T)
    x = _cx(rng, (C8, 2 * B2))
    g = rng.normal(size=T) + 1j * rng.normal(size=T)
    jt, pt = jcplx.zeros((C8, T - 1)), cplx.zeros((C8, T - 1))
    ys = []
    for k in range(2):
        blk = x[:, k * B2:(k + 1) * B2]
        yj = jcplx.to_numpy(pfm.fir_exact(jcplx.as_block(blk), g, D2, jt,
                                          interpret=True))
        yp = cplx.to_numpy(fir_exact(cplx.as_block(blk), _taps(g), D2, pt))
        assert yp.shape == (C8, B2 // D2) and yp.dtype == np.complex64
        assert np.abs(yj - yp).max() / np.abs(yj).max() < 2e-4
        ys.append(yp)
        jt = jcplx.as_block(blk[:, B2 - (T - 1):])
        pt = cplx.as_block(blk[:, B2 - (T - 1):])
    # per-window oracle across the block edge (zero history)
    y = np.concatenate(ys, -1)
    xc = np.concatenate([np.zeros((C8, T - 1)), x.astype(np.complex128)], -1)
    for j in (0, 1, B2 // D2 - 1, B2 // D2, B2 // D2 + 1):
        orc = xc[:, j * D2 + D2 - 1:j * D2 + D2 - 1 + T] @ g
        assert np.abs(y[:, j] - orc).max() / np.abs(orc).max() < 1e-5


def _usb_phasors(a0, n_out):
    """The JAX kernel's USB phasor operands for one block (see
    libsdr_tpu/ops/fm_fused.py::USBBasebandFused._bind/apply)."""
    s = pfm._S
    fr = (a0 * np.exp(-1j * THETA * s * np.arange(n_out // s))).astype(
        np.complex64)
    fph = np.zeros((len(fr), 8), np.float32)
    fph[:, 0], fph[:, 1] = fr.real, fr.imag
    row = np.exp(-1j * THETA * np.arange(s))
    rrow = np.zeros((16, s), np.float32)
    rrow[0], rrow[8] = row.real, row.imag
    return jnp.asarray(fph), jnp.asarray(rrow)


@pytest.mark.parametrize("agc", [True, False])
@pytest.mark.parametrize("mode", ["am", "usb"])
@pytest.mark.parametrize("T", TAPS)
def test_am_usb_match_jax_kernel(T, mode, agc):
    """Two carry-chained blocks; the AGC's sd export carries between them.
    Bound 2e-4 absolute on outputs of ~0.1 (the JAX kernel's bf16 split
    matmuls, ~1e-5 relative on y and on the envelope) and 1e-4 relative on
    sd; the per-window oracle bound is tests/test_pallas.py:311's 5e-3."""
    rng = np.random.default_rng(10 * T + (mode == "usb"))
    x = _cx(rng, (C8, 2 * B2))
    g = rng.normal(size=T) + 1j * rng.normal(size=T)
    n = B2 // D2
    ab = (LAM, 1 - LAM) if agc else None
    ramp = cplx.constant(np.exp(-1j * THETA * np.arange(n)), torch.float32)
    jt, pt = jcplx.zeros((C8, T - 1)), cplx.zeros((C8, T - 1))
    sd_j = jnp.full((C8, 1), 0.5, jnp.float32)
    sd_p = torch.full((C8,), 0.5)
    a0 = A0
    outs = []
    for k in range(2):
        blk = x[:, k * B2:(k + 1) * B2]
        kw = dict(usb_phasors=_usb_phasors(a0, n)) if mode == "usb" else {}
        aj, ej = pfm.fir_fm_exact(
            jcplx.as_block(blk), g, D2, jt, jcplx.zeros((C8, 1)), 1.0,
            GAIN if agc else 1.0, deemph_ab=ab,
            deemph_lead=sd_j if agc else None, mode=mode, interpret=True,
            **kw)
        args = (cplx.as_block(blk), _taps(g), D2, pt)
        g_p = GAIN if agc else 1.0
        if mode == "am":
            ap, sp = fir_am_exact(*args, g_p, ab, sd_p)
        else:
            ph = cplx.constant(np.complex64(a0), torch.float32)
            ap, sp = fir_usb_exact(*args, ph, ramp, g_p, ab, sd_p)
        assert ap.shape == (C8, n) and ap.dtype == torch.float32
        np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=0,
                                   atol=2e-4 * max(1.0, float(ap.abs().max())))
        if agc:
            np.testing.assert_allclose(sp.numpy(), np.asarray(ej.re)[:, 0],
                                       rtol=1e-4)
            sd_j, sd_p = ej.re, sp
        else:
            assert sp is None
        outs.append(ap.numpy())
        jt = jcplx.as_block(blk[:, B2 - (T - 1):])
        pt = cplx.as_block(blk[:, B2 - (T - 1):])
        a0 = a0 * np.exp(-1j * THETA * n)
    if mode == "am" and agc:
        got = np.concatenate(outs, -1)
        xc = np.concatenate([np.zeros((C8, T - 1)),
                             x.astype(np.complex128)], -1)
        sdv = np.full(2, 0.5)
        for j in range(n + 5):              # crosses the block boundary
            sig = np.abs(xc[(0, 5), j * D2 + D2 - 1:j * D2 + D2 - 1 + T] @ g)
            sdv = LAM * sdv + (1 - LAM) * sig
            au = GAIN * sig / sdv
            assert np.all(np.abs(got[(0, 5), j] - au)
                          < 5e-3 * np.maximum(1.0, au))


@pytest.mark.parametrize("complex_taps", [True, False])
def test_fir_overlap_save_takes_tap_tensors(rng, complex_taps):
    """Taps as numpy, as a tensor or as a Complex of planes (a FIRFilter on
    a card hands its taps over as tensors) give the same block."""
    g = rng.normal(size=19) + (1j * rng.normal(size=19) if complex_taps
                               else 0.0)
    x = cplx.as_block(_cx(rng, (2, 400)))
    tail = cplx.as_block(_cx(rng, (2, 18)))
    y0, t0 = pops.fir_overlap_save(g, x, tail, stride=4, offset=3)
    y1, t1 = pops.fir_overlap_save(cplx.constant(g, torch.float32), x, tail,
                                   stride=4, offset=3)
    np.testing.assert_allclose(cplx.to_numpy(y1), cplx.to_numpy(y0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(cplx.to_numpy(t1), cplx.to_numpy(t0))


def test_kernel_entries_refuse_devices_without_a_kernel():
    def meta(*shape):
        return cplx.Complex(torch.empty(shape, device="meta"),
                            torch.empty(shape, device="meta"))

    with pytest.raises(ValueError, match="no kernel"):
        fir_exact(meta(2, 64), meta(5), 4, meta(2, 4))
    with pytest.raises(ValueError, match="no kernel"):
        fir_am_exact(meta(2, 64), meta(5), 4, meta(2, 4), 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        fir_usb_exact(meta(2, 64), meta(5), 4, meta(2, 4), meta(), meta(16),
                      1.0)


# -- the fused ops against JAX's fused ops and unfused chains ---------------

def _am_stages(m, order, decim, agc=True):
    st = [m.IQBaseBand(fc=11000.0, width=9000.0, order=order, decim=decim,
                       design="textbook"), m.AMDemod()]
    return st + [m.AGC(tau=0.03)] if agc else st


def _usb_stages(m, order, decim, agc=True):
    st = [m.IQBaseBand(fc=11000.0, ff=12500.0, width=3000.0, order=order,
                       decim=decim, design="textbook"), m.USBDemod()]
    return st + [m.AGC(tau=0.03)] if agc else st


def _jax_pipe(stages, block, n_ch, fused=True):
    p = J.Pipeline(stages, optimize=fused)
    orig = jfuse._on_tpu
    jfuse._on_tpu = lambda: True    # the fused rewrite on CPU (XLA path)
    try:
        p.bind(J.StreamSpec(jnp.complex64, FS, block, channels=(n_ch,)))
    finally:
        jfuse._on_tpu = orig
    return p


def _port_pipe(stages, block, n_ch, fused=True):
    p = P.Pipeline(stages, optimize=fused)
    p.bind(P.StreamSpec(np.complex64, FS, block, channels=(n_ch,)))
    return p


def _stream(pipe, step, blocks, to_block, to_np, carry=None, **kw):
    carry = pipe.init_carry(**kw) if carry is None else carry
    outs = []
    for blk in blocks:
        carry, y = step(carry, to_block(blk))
        outs.append(to_np(y))
    return carry, np.concatenate(outs, -1)


def _run_jax(pipe, blocks, carry=None):
    """The JAX pipeline through its jitted step (eager dispatch of its
    envelope scan costs seconds per block)."""
    return _stream(pipe, pipe.compile(), blocks, jcplx.as_block, np.asarray,
                   carry)


def _run_port(pipe, blocks, carry=None):
    return _stream(pipe, pipe.compile(), blocks, cplx.as_block,
                   lambda y: y.numpy(), carry, device="cpu")


def _blocks(seed, n_ch, block, n=4):
    rng = np.random.default_rng(seed)
    return [_cx(rng, (n_ch, block)) for _ in range(n)]


AM_CASES = [(16, 2, 4096, 3), (48, 4, 2048, 2), (80, 8, 1024, 1)]
USB_CASES = [(48, 4, 4096, 2), (64, 8, 2048, 1), (96, 8, 8192, 3)]


@pytest.mark.parametrize("kind,order,decim,block,n_ch",
                         [("am",) + c for c in AM_CASES]
                         + [("usb",) + c for c in USB_CASES])
def test_fused_streams_like_jax(kind, order, decim, block, n_ch):
    """Port fused vs JAX fused (XLA path: the same float32 math, with the
    AGC envelope recurrence associated differently, an associative scan
    there and frame matmuls here; 1e-4 of the output scale) and vs JAX's
    unfused chain with tests/test_fuzz_chains.py's bounds (median error 1e-4
    of the scale, SNR > 40 / 45 dB)."""
    mk = _am_stages if kind == "am" else _usb_stages
    op = AMBasebandFused if kind == "am" else USBBasebandFused
    blocks = _blocks(order + decim, n_ch, block)
    pp = _port_pipe(mk(pops, order, decim), block, n_ch)
    assert len(pp.stages) == 1 and isinstance(pp.stages[0], op)
    _, yp = _run_port(pp, blocks)
    _, yj = _run_jax(_jax_pipe(mk(jops, order, decim), block, n_ch), blocks)
    scale = np.abs(yj).max()
    assert yp.shape == yj.shape == (n_ch, 4 * block // decim)
    assert np.abs(yp - yj).max() / scale < 1e-4
    _, yu = _run_jax(_jax_pipe(mk(jops, order, decim), block, n_ch, False),
                     blocks)
    err = np.abs(yu - yp)
    assert np.median(err) / scale < 1e-4
    assert snr_db(yu.ravel() + 1e-9, yp.ravel() + 1e-9) > (
        40.0 if kind == "am" else 45.0)


def test_am_fused_matches_unfused_pipeline():
    """tests/test_pallas.py::test_am_fused_matches_unfused_pipeline on the
    port: the fused op against JAX's unfused [IQBaseBand -> AMDemod -> AGC]
    (rtol 2e-4, atol 2e-5, that test's bounds), and the port's own unfused
    chain against JAX's (float32 round-off)."""
    def stages(m):
        return [m.IQBaseBand(fc=12000, width=9000, order=48, decim=4,
                             design="textbook"), m.AMDemod(), m.AGC(tau=0.05)]

    blocks = _blocks(3, 4, 9600, 3)
    _, yu = _run_jax(_jax_pipe(stages(jops), 9600, 4, False), blocks)
    _, yp = _run_port(_port_pipe(stages(pops), 9600, 4), blocks)
    np.testing.assert_allclose(yp, yu, rtol=2e-4, atol=2e-5)
    pu = _port_pipe(stages(pops), 9600, 4, fused=False)
    assert [type(s) for s in pu.stages] == [pops.IQBaseBand, pops.AMDemod,
                                            pops.AGC]
    _, ypu = _run_port(pu, blocks)
    np.testing.assert_allclose(ypu, yu, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["am", "usb"])
def test_fused_matches_jax_pallas_path_at_64_channels(kind):
    """At 64 channels JAX's fused op takes the Pallas kernel (interpret
    mode here).  Bound: 60 dB SNR, as tests/test_torch_main_path.py asks of
    the FM kernel (bf16 split matmuls on the JAX side)."""
    mk = _am_stages if kind == "am" else _usb_stages
    blocks = _blocks(64, 64, 4096, 2)
    with kernel_mode("interpret"):
        jp = J.Pipeline(mk(jops, 48, 4))
        jp.bind(J.StreamSpec(jnp.complex64, FS, 4096, channels=(64,)))
        assert isinstance(jp.stages[0], (jfm_fused.AMBasebandFused,
                                         jfm_fused.USBBasebandFused))
        _, yj = _run_jax(jp, blocks)
    _, yp = _run_port(_port_pipe(mk(pops, 48, 4), 4096, 64), blocks)
    assert snr_db(yj.ravel(), yp.ravel()) > 60.0


@pytest.mark.parametrize("agc", [True, False])
@pytest.mark.parametrize("kind", ["am", "usb"])
def test_fused_constants_and_carry_match_jax(kind, agc):
    mk = _am_stages if kind == "am" else _usb_stages
    blocks = _blocks(5, 2, 2048, 1)
    jp = _jax_pipe(mk(jops, 48, 4, agc), 2048, 2)
    pp = _port_pipe(mk(pops, 48, 4, agc), 2048, 2)
    jop, pop = jp.stages[0], pp.stages[0]
    assert type(pop).__name__ == type(jop).__name__
    np.testing.assert_array_equal(pop._g2, jop._g2)
    assert pop._decim == jop._decim and pop._t == jop._t
    assert pop._ab == jop._ab and pop._gain == jop._gain
    if kind == "usb":
        for a, b in ((pop._ramp_np, jop._ramp),
                     (pop._step_np, jop._block_step)):
            a = np.complex64(a) if np.ndim(a) == 0 else a.astype(np.complex64)
            np.testing.assert_array_equal(a.real, np.asarray(b.re))
            np.testing.assert_array_equal(a.imag, np.asarray(b.im))
    assert _signature(pp.init_carry("cpu")) == _signature(jp.init_carry())
    jc, _ = _run_jax(jp, blocks)
    pc, _ = _run_port(pp, blocks)
    assert _signature(pc) == _signature(jc)
    assert pp.out_spec.block_size == jp.out_spec.block_size
    assert float(pp.out_spec.sample_rate) == float(jp.out_spec.sample_rate)


def _to_jax(t):
    if isinstance(t, interop.PlanarArray):
        return jcplx.Complex(jnp.asarray(t.re), jnp.asarray(t.im))
    if isinstance(t, tuple):
        return tuple(_to_jax(v) for v in t)
    return jnp.asarray(t)


@pytest.mark.parametrize("kind", ["am", "usb"])
def test_carry_handoff_jax_port_jax(kind):
    """Block 0 in JAX, block 1 in the port, block 2 in JAX again, with the
    carry crossing through interop both ways: the stream equals JAX's
    uninterrupted run (float32 round-off)."""
    mk = _am_stages if kind == "am" else _usb_stages
    blocks = _blocks(7, 3, 4096, 3)
    _, ref = _run_jax(_jax_pipe(mk(jops, 64, 8), 4096, 3), blocks)
    jp = _jax_pipe(mk(jops, 64, 8), 4096, 3)
    jc, y0 = _run_jax(jp, blocks[:1])
    pc = interop.state_from_numpy(jc, "cpu")
    assert _signature(pc) == _signature(jc)
    pc, y1 = _run_port(_port_pipe(mk(pops, 64, 8), 4096, 3), blocks[1:2], pc)
    jc = _to_jax(interop.state_to_numpy(pc))
    _, y2 = _run_jax(jp, blocks[2:], jc)
    got = np.concatenate([y0, y1, y2], -1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


# -- the single ops ----------------------------------------------------------

def _stream_ops(jop, pop, spec_args, blocks):
    jop.bind(J.StreamSpec(*spec_args))
    pop.bind(P.StreamSpec(*spec_args))
    jc, pc = jop.init_carry(), pop.init_carry("cpu")
    jo, po = [], []
    jstep = jax.jit(jop.apply)
    for blk in blocks:
        jc, jy = jstep(jc, jcplx.as_block(blk))
        pc, py = pop.apply(pc, cplx.as_block(blk))
        jo.append(jcplx.to_numpy(jy))
        po.append(cplx.to_numpy(py))
    return np.concatenate(jo, -1), np.concatenate(po, -1)


@pytest.mark.parametrize("make,dtype", [
    (lambda m: m.AGC(tau=0.01), np.complex64),
    (lambda m: m.AGC(tau=0.02, target=0.3), np.float32),
    (lambda m: m.AGC(enabled=False, gain=1.7), np.complex64),
    (lambda m: m.AMDemod(), np.complex64),
    (lambda m: m.USBDemod(), np.complex64),
    (lambda m: m.Scale(0.25), np.complex64),
    (lambda m: m.Scale(1.0), np.float32),
    (lambda m: m.IQBalance(1.1, 0.9), np.complex64),
    (lambda m: m.RealPart(), np.complex64),
    (lambda m: m.ImagPart(), np.complex64),
    (lambda m: m.ToComplex(), np.float32),
])
def test_single_ops_stream_like_jax(rng, make, dtype):
    """Elementwise ops and the AGC's envelope recurrence, streamed over
    three blocks of two channels (float32 round-off)."""
    x = rng.normal(size=(2, 3 * 480)) + 1j * rng.normal(size=(2, 3 * 480))
    x = x.astype(dtype) if np.dtype(dtype).kind == "c" else \
        x.real.astype(dtype)
    yj, yp = _stream_ops(make(jops), make(pops), (dtype, 48_000.0, 480, (2,)),
                         np.split(x, 3, axis=-1))
    assert yp.shape == yj.shape
    np.testing.assert_allclose(yp, yj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("src,make", [
    (np.int16, lambda m: m.Cast(np.float32, normalize=True)),
    (np.uint8, lambda m: m.UnsignedToSigned()),
    (np.int16, lambda m: m.SignedToUnsigned()),
    (np.float32, lambda m: m.AutoCast("bfloat16")),
])
def test_casts_like_jax(rng, src, make):
    if np.dtype(src).kind == "f":
        x = rng.normal(size=(2, 960)).astype(src)
    else:
        info = np.iinfo(src)
        x = rng.integers(info.min, info.max, size=(2, 960)).astype(src)
    yj, yp = _stream_ops(make(jops), make(pops), (src, 48_000.0, 480, (2,)),
                         np.split(x, 2, axis=-1))
    assert yp.dtype == np.asarray(yj).dtype or src == np.float32
    np.testing.assert_array_equal(yp.astype(np.float64),
                                  np.asarray(yj, np.float64))


def test_autocast_bf16_planes_advertised_like_jax(rng):
    jop, pop = jops.AutoCast("bfloat16"), pops.AutoCast("bfloat16")
    js = jop.bind(J.StreamSpec(jnp.complex64, 48_000.0, 480))
    ps = pop.bind(P.StreamSpec(np.complex64, 48_000.0, 480))
    assert ps.plane_dtype == torch.bfloat16 and str(js.plane_dtype) == \
        "bfloat16"
    x = _cx(rng, (480,))
    _, yp = pop.apply((), cplx.as_block(x))
    _, yj = jop.apply((), jcplx.as_block(x))
    assert yp.re.dtype == torch.bfloat16
    np.testing.assert_array_equal(cplx.to_numpy(yp), jcplx.to_numpy(yj))


@pytest.mark.parametrize("n", [2, 3])
def test_interleave_round_trip_like_jax(rng, n):
    x = _cx(rng, (n, 64))
    yj, yp = _stream_ops(jops.Interleave(n), pops.Interleave(n),
                         (np.complex64, 8000.0, 32, (n,)),
                         np.split(x, 2, axis=-1))
    np.testing.assert_array_equal(yp, yj)
    d = pops.Deinterleave(n)
    d.bind(P.StreamSpec(np.complex64, 8000.0 * n, 32 * n))
    _, back = d.apply((), cplx.as_block(yp[..., :32 * n]))
    np.testing.assert_array_equal(cplx.to_numpy(back), x[..., :32])


def test_switch_stages_preserves_front_end(rng):
    """tests/test_core.py::test_pipeline_switch_stages_preserves_front_end
    on the port: FM for two blocks, then a live switch to AM; the switched
    output equals a continuous AM pipeline (the front-end tail is
    transplanted) and JAX's switched pipeline."""
    block = 9600

    def bb(m):
        return m.IQBaseBand(fc=12000, width=9000, order=48, decim=4,
                            design="textbook")

    x = _cx(rng, (4, block))
    outs = {}
    for name, m, pkg, blk in (("port", pops, P, cplx.as_block),
                              ("jax", jops, J, jcplx.as_block)):
        p = pkg.Pipeline([bb(m), m.FMDemod(), m.FMDeemph()])
        p.bind(pkg.StreamSpec(np.complex64, FS, block))
        c = p.init_carry("cpu") if pkg is P else p.init_carry()
        step = p.compile()
        for b in range(2):
            c, _ = step(c, blk(x[b]))
        c = p.switch_stages([bb(m), m.AMDemod()], c)
        ys = []
        step = p.compile()
        for b in range(2, 4):
            c, y = step(c, blk(x[b]))
            ys.append(np.asarray(y))
        outs[name] = np.concatenate(ys)
        if name == "port":
            assert [type(s) for s in p.stages] == [AMBasebandFused]
            assert "AMBasebandFused" in p.describe()
    q = P.Pipeline([bb(pops), pops.AMDemod()])
    q.bind(P.StreamSpec(np.complex64, FS, block))
    _, cont = _run_port(q, list(x))
    np.testing.assert_allclose(outs["port"], cont[2 * block // 4:],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-4,
                               atol=1e-5)
