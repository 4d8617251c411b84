"""The port's main path, Pipeline([IQBaseBand(order=64, decim=4), FMDemod,
FMDeemph]) on a 64-channel bank of FM tones, against the JAX package: fused
with the Pallas kernel in interpret mode, and unfused (optimize=False).  Also
the port's own unfused chain, the fused op's carry layout and bound
constants, and a mid-stream hand-off of the carry in both directions.

SNR bound: the fused chains use a polynomial atan2 (|err| < 2e-5 rad) and the
JAX kernel a 3-pass bf16 split matmul (~1e-5 relative); both sit far above
the 60 dB that tests/test_ops.py asks of fused vs unfused FM.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libsdr_tpu as J
import libsdr_tpu_torch as P
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu.ops import FMDeemph as JFMDeemph
from libsdr_tpu.ops import FMDemod as JFMDemod
from libsdr_tpu.ops import IQBaseBand as JIQBaseBand
from libsdr_tpu.ops.fir import kernel_mode
from libsdr_tpu.ops.fm_fused import FMBasebandFused as JFused
from libsdr_tpu_torch import interop
from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand, siggen
from libsdr_tpu_torch.ops.fm_fused import FMBasebandFused

FS, C, B, N_BLOCKS = 960_000.0, 64, 4096, 3
GAIN = FS / 4 / (2 * np.pi * 75_000.0)
SNR_MIN_DB = 60.0


def _snr_db(ref, test):
    err = np.mean(np.abs(np.asarray(ref, np.float64) - test) ** 2)
    return 10 * np.log10(np.mean(np.asarray(ref, np.float64) ** 2) / err)


def _bank():
    """(C, N_BLOCKS*B) FM tones with per-channel carrier and tone."""
    n = N_BLOCKS * B
    rows = []
    for c in range(C):
        audio = siggen.sine(FS, n, 1000.0 + 37.0 * c, amps=0.8)
        rows.append(siggen.fm_modulate(FS, audio, deviation=60_000.0,
                                       carrier=FS / 8 + 500.0 * (c % 9 - 4)))
    return np.stack(rows)


BANK = _bank()


def _stages(mod):
    return [mod[0](fc=FS / 8, width=FS / 4.8, order=64, decim=4,
                   design="textbook"), mod[1](gain=GAIN), mod[2]()]


def _jax_pipe(optimize):
    p = J.Pipeline(_stages((JIQBaseBand, JFMDemod, JFMDeemph)),
                   optimize=optimize)
    p.bind(J.StreamSpec(jnp.complex64, FS, B, channels=(C,)))
    return p


def _port_pipe(optimize):
    p = P.Pipeline(_stages((IQBaseBand, FMDemod, FMDeemph)),
                   optimize=optimize)
    p.bind(P.StreamSpec(np.complex64, FS, B, channels=(C,)))
    return p


def _run_jax(p, blocks, carry=None):
    carry = p.init_carry() if carry is None else carry
    outs = []
    for k in blocks:
        carry, y = p.apply(carry, jcplx.as_block(BANK[:, k * B:(k + 1) * B]))
        outs.append(np.asarray(y))
    return carry, np.concatenate(outs, -1)


def _run_port(p, blocks, carry=None):
    carry = p.init_carry("cpu") if carry is None else carry
    outs = []
    for k in blocks:
        carry, y = p.apply(carry, cplx.as_block(BANK[:, k * B:(k + 1) * B]))
        outs.append(y.numpy())
    return carry, np.concatenate(outs, -1)


@pytest.fixture(scope="module")
def jax_fused():
    with kernel_mode("interpret"):
        p = _jax_pipe(True)
        assert isinstance(p.stages[0], JFused)
        carry, y = _run_jax(p, range(N_BLOCKS))
    return p, carry, y


@pytest.fixture(scope="module")
def port_fused():
    p = _port_pipe(True)
    carry, y = _run_port(p, range(N_BLOCKS))
    return p, carry, y


def _signature(tree):
    """Nesting, shapes and plane dtypes of a carry of either package."""
    if hasattr(tree, "re") and hasattr(tree, "im"):
        return ("complex", _signature(tree.re))
    if isinstance(tree, (tuple, list)):
        return tuple(_signature(t) for t in tree)
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def test_fusion_installs_fused_op_with_jax_constants(jax_fused, port_fused):
    jp, pp = jax_fused[0], port_fused[0]
    assert len(pp.stages) == 1 and isinstance(pp.stages[0], FMBasebandFused)
    jop, pop = jp.stages[0], pp.stages[0]
    np.testing.assert_array_equal(pop._g2, jop._g2)
    assert pop._rot == jop._rot
    assert pop._gain == jop._gain
    assert pop._dab == jop._dab
    assert pp.out_spec.block_size == jp.out_spec.block_size == B // 4
    assert float(pp.out_spec.sample_rate) == float(jp.out_spec.sample_rate)


def test_fused_carry_matches_jax_layout(jax_fused, port_fused):
    assert _signature(port_fused[1]) == _signature(jax_fused[1])
    assert _signature(port_fused[0].init_carry("cpu")) == _signature(
        jax_fused[0].init_carry())


def test_fused_matches_jax_fused_kernel(jax_fused, port_fused):
    assert port_fused[2].shape == (C, N_BLOCKS * B // 4)
    assert _snr_db(jax_fused[2], port_fused[2]) > SNR_MIN_DB


def test_fused_matches_jax_unfused(port_fused):
    _, y = _run_jax(_jax_pipe(False), range(N_BLOCKS))
    assert _snr_db(y, port_fused[2]) > SNR_MIN_DB


def test_unfused_matches_jax_unfused_and_fused(port_fused):
    p = _port_pipe(False)
    assert [type(s) for s in p.stages] == [IQBaseBand, FMDemod, FMDeemph]
    carry, y = _run_port(p, range(N_BLOCKS))
    _, yj = _run_jax(_jax_pipe(False), range(N_BLOCKS))
    assert _snr_db(yj, y) > 100.0     # same math, both exact atan2
    assert _signature(carry) == _signature(_jax_pipe(False).init_carry())
    assert _snr_db(y, port_fused[2]) > SNR_MIN_DB


def test_handoff_jax_to_port(jax_fused):
    with kernel_mode("interpret"):
        jp = _jax_pipe(True)
        jcarry, _ = _run_jax(jp, [0])
    carry = interop.state_from_numpy(jcarry, "cpu")
    assert _signature(carry) == _signature(jcarry)
    _, y = _run_port(_port_pipe(True), range(1, N_BLOCKS), carry)
    assert _snr_db(jax_fused[2][:, B // 4:], y) > SNR_MIN_DB


def test_handoff_port_to_jax(jax_fused):
    pcarry, _ = _run_port(_port_pipe(True), [0])
    host = interop.state_to_numpy(pcarry)
    back = interop.state_from_numpy(host, "cpu")
    assert _signature(back) == _signature(pcarry)

    def to_jax(t):
        if isinstance(t, interop.PlanarArray):
            return jcplx.Complex(jnp.asarray(t.re), jnp.asarray(t.im))
        if isinstance(t, tuple):
            return tuple(to_jax(v) for v in t)
        return jnp.asarray(t)

    with kernel_mode("interpret"):
        _, y = _run_jax(_jax_pipe(True), range(1, N_BLOCKS), to_jax(host))
    assert _snr_db(jax_fused[2][:, B // 4:], y) > SNR_MIN_DB


def test_tone_drive_through_run_pipeline():
    """The single-stream FM tone drive through ``run_pipeline`` and
    ``stream_blocks`` of both packages: the 1 kHz tone stands >= 60 dB over
    the median FFT bin, and the port agrees with the JAX chain.  CPU blocks
    take the plain version, so the kernel's launch counter does not move."""
    from libsdr_tpu.core import run_pipeline as j_run_pipeline
    from libsdr_tpu.core import stream_blocks as j_stream_blocks
    from libsdr_tpu_torch.core import run_pipeline, stream_blocks
    from libsdr_tpu_torch.ops.fir_fm import fir_fm_exact

    fs, blk, out_fs = 960_000.0, 96_000, 240_000
    iq = siggen.fm_modulate(fs, siggen.sine(fs, 5 * blk, 1000.0, amps=0.8),
                            deviation=75_000.0, carrier=120_000.0)

    def stages(mod):
        return [mod[0](fc=120_000, width=200_000, order=64, out_rate=out_fs,
                       design="textbook"),
                mod[1](gain=fs / 4 / (2 * np.pi * 75_000.0)), mod[2]()]

    rx = P.Pipeline(stages((IQBaseBand, FMDemod, FMDeemph)))
    rx.bind(P.StreamSpec(np.complex64, fs, block_size=blk))
    assert isinstance(rx.stages[0], FMBasebandFused)
    n0 = fir_fm_exact.launches
    _, out = run_pipeline(rx, stream_blocks(iq, blk), device="cpu")
    assert fir_fm_exact.launches == n0
    assert out.shape == (5 * blk // 4,) and np.isfinite(out).all()
    seg = out[24_000:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    k = int(np.argmax(spec))
    assert abs(np.fft.rfftfreq(len(seg), 1 / out_fs)[k] - 1000.0) < 1.0
    assert 20 * np.log10(spec[k] / np.median(spec)) >= 60.0

    jrx = J.Pipeline(stages((JIQBaseBand, JFMDemod, JFMDeemph)))
    jrx.bind(J.StreamSpec(jnp.complex64, fs, block_size=blk))
    _, jout = j_run_pipeline(jrx, j_stream_blocks(iq, blk))
    assert _snr_db(jout, out) > SNR_MIN_DB


def test_fir_fm_exact_refuses_devices_without_a_kernel():
    from libsdr_tpu_torch.ops.fir_fm import fir_fm_exact

    def meta(*shape):
        return cplx.Complex(torch.empty(shape, device="meta"),
                            torch.empty(shape, device="meta"))

    with pytest.raises(ValueError, match="no kernel"):
        fir_fm_exact(meta(2, 64), meta(5), 4, meta(2, 4), meta(2), 1j, 1.0)


def test_bf16_planes_carry_and_output(port_fused):
    p = P.Pipeline(_stages((IQBaseBand, FMDemod, FMDeemph)))
    p.bind(P.StreamSpec(np.complex64, FS, B, channels=(C,),
                        plane_dtype=torch.bfloat16))
    carry = p.init_carry("cpu")
    assert carry[0][0].re.dtype == torch.bfloat16
    outs = []
    for k in range(N_BLOCKS):
        x = cplx.as_block(BANK[:, k * B:(k + 1) * B], torch.bfloat16)
        carry, y = p.apply(carry, x)
        outs.append(y.numpy())
    assert carry[0][0].re.dtype == torch.bfloat16
    # bf16 planes keep 8 bits of mantissa: a coarser bound than f32.
    assert _snr_db(port_fused[2], np.concatenate(outs, -1)) > 30.0
