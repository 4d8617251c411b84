"""The port's wideband receive path (``libsdr_tpu_torch``: ops/fft,
ops/channelizer, ops/pfb, parallel/wideband, ops/wideband_rx, the
Channelizer -> FMDemod fusion rule, ops/fftfilter, ops/psk31 and the apps
scanner, multimode, psk31_rx and spectrum) against the JAX package on the
CPU.

The inputs are made with numpy from a seed (or by the JAX package's own test
helpers) and go through both packages; every port entry point runs with
``device="cpu"``, where K4's wrapper takes its plain version.  The JAX
kernel runs in Pallas interpret mode, its XLA paths as its tests run them.
Bounds are the JAX tests' own:

* the channelizer's Y within 2e-5 of the largest |Y| (the JAX kernel
  against its XLA channelizer, ``tests/test_pallas_pfb.py``), and its
  exports y_last / y_first too;
* the demod's error median < 5e-5 and 99th percentile < 1e-3 rad (the
  angle of a near-zero z on random data is amplified);
* three chained blocks equal one block within 1e-6;
* the FFT at > 110 dB SNR against numpy, ``fft_f64`` within 1e-12;
* BPSK31 bits equal to the JAX bits, and every app decodes what the JAX
  app decodes, on the same channels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libsdr_tpu as J
import libsdr_tpu_torch as P
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu.ops import channelizer as jchan
from libsdr_tpu.ops import pallas_pfb as jpfb
from libsdr_tpu.ops.fir import kernel_mode
from libsdr_tpu.parallel import wideband as jwb
from libsdr_tpu_torch import interop
from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import ConfigError
from libsdr_tpu_torch.ops import channelizer, pfb
from libsdr_tpu_torch.ops.fft import fft, fft_f64, fft_np
from libsdr_tpu_torch.parallel import wideband as pwb
from tests.conftest import snr_db

MEDIAN, P99, REL = 5e-5, 1e-3, 2e-5


def _t(a):
    """numpy complex -> the port's planar Complex on the CPU."""
    return cplx.as_block(np.asarray(a, np.complex64))


def _j(a):
    return jcplx.as_block(np.asarray(a, np.complex64))


def _c(x):
    """Either package's planar value (or real array) as numpy."""
    if isinstance(x, Complex):
        return cplx.to_numpy(x)
    if hasattr(x, "re"):
        return jcplx.to_numpy(x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_jax(tree):
    """A host carry (interop.state_to_numpy) as the JAX package's carry."""
    if isinstance(tree, interop.PlanarArray):
        return jcplx.Complex(jnp.asarray(tree.re), jnp.asarray(tree.im))
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_jax(v) for v in tree)
    return jnp.asarray(tree)


def _mk(rng, m, p, f):
    x = (rng.normal(size=f * m) + 1j * rng.normal(size=f * m)).astype(
        np.complex64)
    hist = (rng.normal(size=(p, m)) + 1j * rng.normal(size=(p, m))).astype(
        np.complex64)
    return x, hist, channelizer.fold_commutator(
        channelizer.prototype_lowpass(m, p), m, p)


def _angle_err(a, b, gain=1.0):
    half = np.pi * gain
    return np.abs(np.remainder(a - b + half, 2 * half) - half)


# -- ops/fft.py --------------------------------------------------------------

def test_fft_and_fft_f64_match_jax(rng):
    from libsdr_tpu.ops.fft import fft as jfft
    from libsdr_tpu.ops.fft import fft_f64 as jfft_f64

    for n in [64, 384, 1024, 2048, 4096]:
        x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
             ).astype(np.complex64)
        for inv in (False, True):
            got = _c(fft(_t(x), inverse=inv))
            assert snr_db(_c(jfft(_j(x), inverse=inv)), got) > 110, n
            assert snr_db(np.fft.ifft(x) if inv else np.fft.fft(x),
                          got) > 110
    for n in (1000, 4096):
        x = rng.normal(size=n) + 1j * rng.normal(size=n)
        got = fft_f64(x)
        assert np.abs(got - jfft_f64(x)).max() / np.abs(got).max() < 1e-12
        assert np.abs(fft_f64(got, inverse=True) - x).max() < 1e-12
    np.testing.assert_array_equal(fft_np(x), np.fft.fft(x))


# -- ops/channelizer.py, the taps --------------------------------------------

@pytest.mark.parametrize("m,p", [(16, 8), (256, 8), (1024, 8), (384, 3)])
def test_prototype_and_fold_equal_bytes(m, p):
    """Both packages make the taps from the same numpy code: the port needs
    no weights from the JAX package."""
    proto = channelizer.prototype_lowpass(m, p)
    assert proto.tobytes() == jchan.prototype_lowpass(m, p).tobytes()
    assert channelizer.fold_commutator(proto, m, p).tobytes() == \
        jchan.fold_commutator(proto, m, p).tobytes()


# -- ops/pfb.py: lane maps, the gate, pfb_plain against the JAX kernel --------

def test_lane_maps_match_jax():
    for m in (8, 64, 128, 256, 384, 1024):
        np.testing.assert_array_equal(pfb.lane_of_channel(m),
                                      jpfb.lane_of_channel(m))
        np.testing.assert_array_equal(pfb.channel_of_lane(m),
                                      jpfb.channel_of_lane(m))
    for m in (1000, 2048, 4096):   # beyond the JAX gate: permutations
        lp, ch = pfb.lane_of_channel(m), pfb.channel_of_lane(m)
        np.testing.assert_array_equal(ch[lp], np.arange(m))
        np.testing.assert_array_equal(np.sort(lp), np.arange(m))


def test_pfb_gate():
    # the JAX gate's cases: the port's kernel takes all but the dtype
    assert pfb.pfb_supported(100, 64, 8)          # M not 128 n2
    assert pfb.pfb_supported(2048, 64, 8)         # n2 > 8
    assert pfb.pfb_supported(256, 4, 8)           # F < P
    assert not pfb.pfb_supported(256, 64, 8, dtype=torch.int16)
    assert pfb.pfb_supported(256, 64, 8, dtype=torch.bfloat16)
    assert pfb.pfb_supported(1024, 8192, 8)
    assert not jpfb.mxu_pfb_supported(100, 64, 8)
    assert not jpfb.mxu_pfb_supported(256, 4, 8)
    # the port's wider set and its limits
    for m in (1, 8, 16, 64, 384, 1000, 8192):
        assert pfb.pfb_supported(m, 1, 1)
    assert pfb.pfb_supported(64, 1, 32)
    assert not pfb.pfb_supported(8193, 64, 8)
    assert not pfb.pfb_supported(64, 64, 33)
    assert not pfb.pfb_supported(64, 0, 8)
    assert not pfb.pfb_supported(64, 64, 0)
    # whether WidebandFM's stage launches the kernel: only on a card
    from libsdr_tpu_torch.ops.wideband_rx import fm_local_kernel_ok
    x = cplx.zeros((256 * 40,))
    assert not fm_local_kernel_ok(x, 256, 8)


@pytest.mark.parametrize("m", [128, 384, 256])
def test_pfb_plain_matches_jax_kernel(rng, m):
    """The channel variant against the JAX kernel in interpret mode."""
    p, f = 8, 32
    x, hist, taps3 = _mk(rng, m, p, f)
    jy = jpfb.pfb_mxu(_j(x.reshape(f, m)), _j(hist), taps3, m,
                      interpret=True)
    py = pfb.pfb_mxu(_t(x.reshape(f, m)), _t(hist), taps3, m)
    ref = _c(jy)
    assert np.abs(_c(py) - ref).max() / np.abs(ref).max() < REL


def test_pfb_plain_demod_matches_jax_kernel(rng):
    m, p, f = 256, 8, 32
    x, hist, taps3 = _mk(rng, m, p, f)
    prev = (rng.normal(size=(1, m)) + 1j * rng.normal(size=(1, m))).astype(
        np.complex64)
    ja, jl, j0 = jpfb.pfb_mxu(_j(x.reshape(f, m)), _j(hist), taps3, m,
                              gain=1.7, prev=_j(prev), demod=True,
                              interpret=True)
    pa, pl, p0 = pfb.pfb_mxu(_t(x.reshape(f, m)), _t(hist), taps3, m,
                             gain=1.7, prev=_t(prev), demod=True)
    err = _angle_err(_c(pa), np.asarray(ja), 1.7)
    assert np.median(err) < MEDIAN and np.percentile(err, 99) < P99
    scale = np.abs(_c(jl)).max()
    assert np.abs(_c(pl) - _c(jl)).max() / scale < REL
    assert np.abs(_c(p0) - _c(j0)).max() / scale < REL
    # the row-0 re-demod of the sharded step: the epilogue's op sequence
    from libsdr_tpu_torch.ops.wideband_rx import fm_demod1
    np.testing.assert_allclose(_c(fm_demod1(p0, _t(prev), 1.7))[0],
                               _c(pa)[0], atol=1e-6)


@pytest.mark.parametrize("m", [16, 64])
def test_channelize_segment_matches_jax(rng, m):
    p, f = 8, 40
    x, hist, taps3 = _mk(rng, m, p, f)
    ref = _c(jwb.channelize_segment(_j(x), _j(hist), jnp.asarray(taps3), m,
                                    p))
    got = _c(pwb.channelize_segment(_t(x), _t(hist), taps3, m, p))
    assert got.shape == ref.shape == (m, f)
    assert np.abs(got - ref).max() / np.abs(ref).max() < REL


def test_pfb_streaming_equals_oneshot(rng):
    """Chaining (hist, prev) across blocks gives the one-block result."""
    m, p, f = 128, 8, 48
    x, _, taps3 = _mk(rng, m, p, 3 * f)
    big = _t(x.reshape(3 * f, m))
    hist0 = cplx.zeros((p, m))
    one, _, _ = pfb.pfb_mxu(big, hist0, taps3, m, demod=True)
    hist, prev, outs = hist0, None, []
    for i in range(3):
        blk = big[i * f:(i + 1) * f, :]
        audio, prev, _ = pfb.pfb_mxu(blk, hist, taps3, m, prev=prev,
                                     demod=True)
        outs.append(audio)
        hist = blk[f - p:, :]
    np.testing.assert_allclose(torch.cat(outs).numpy(), one.numpy(),
                               atol=1e-6)


# -- the ops over three blocks, and their carries across the packages -------

def _three_blocks(rng, jop, pop, block, check, lead=()):
    jc, pc = jop.init_carry(), pop.init_carry("cpu")
    for i in range(3):
        x = (rng.normal(size=lead + (block,))
             + 1j * rng.normal(size=lead + (block,))).astype(np.complex64)
        if i == 1:   # the carry crosses to the JAX package and back
            jc = _to_jax(interop.state_to_numpy(pc))
            pc = interop.state_from_numpy(interop.state_to_numpy(pc), "cpu")
        jc, jy = jop.apply(jc, _j(x))
        pc, py = pop.apply(pc, _t(x))
        check(_c(py), _c(jy))


def test_channelizer_matches_jax(rng):
    from libsdr_tpu.ops import Channelizer as JChannelizer
    from libsdr_tpu_torch.ops import Channelizer

    m, p = 64, 8
    for block, lead in ((m * 24, ()), (m * 5, (2,))):   # t >= P and t < P
        spec = dict(dtype=np.complex64, sample_rate=1e6, block_size=block,
                    channels=lead)
        jop, pop = JChannelizer(m, p), Channelizer(m, p)
        jop.bind(J.StreamSpec(**spec))
        pop.bind(P.StreamSpec(**spec))

        def check(got, ref):
            assert got.shape == ref.shape == lead + (m, block // m)
            assert np.abs(got - ref).max() / np.abs(ref).max() < REL
        _three_blocks(rng, jop, pop, block, check, lead)


@pytest.mark.parametrize("layout", ["lane", "channel"])
def test_widebandfm_matches_jax(rng, layout):
    from libsdr_tpu.ops import WidebandFM as JWidebandFM
    from libsdr_tpu_torch.ops import WidebandFM

    m, p, block = 64, 8, 64 * 24
    jop = JWidebandFM(m, p, gain=0.7, layout=layout)
    pop = WidebandFM(m, p, gain=0.7, layout=layout)
    jop.bind(J.StreamSpec(np.complex64, 1e6, block))
    pop.bind(P.StreamSpec(np.complex64, 1e6, block))
    np.testing.assert_array_equal(pop.lane_of_channel, jop.lane_of_channel)
    np.testing.assert_array_equal(pop.channel_of_lane, jop.channel_of_lane)

    def check(got, ref):
        assert got.shape == ref.shape
        err = _angle_err(got, ref, 0.7)
        assert np.median(err) < MEDIAN and np.percentile(err, 99) < P99
    _three_blocks(rng, jop, pop, block, check)


def test_fft_filter_bank_matches_jax(rng):
    from libsdr_tpu.ops import FFTFilterBank as JBank
    from libsdr_tpu_torch.ops import FFTFilterBank

    bands = [(500, 1500), (-3000, -1000)]
    jop, pop = JBank(bands), FFTFilterBank(bands)
    jop.bind(J.StreamSpec(np.complex64, 8000, 256))
    pop.bind(P.StreamSpec(np.complex64, 8000, 256))
    _three_blocks(rng, jop, pop, 256,
                  lambda got, ref: (got.shape == ref.shape
                                    and snr_db(ref, got) > 110)
                  or pytest.fail("FFTFilterBank"))
    pop.set_band(1, -2000, -1500)
    jop.set_band(1, -2000, -1500)
    x = _t(np.ones(256, np.complex64))
    _, y = pop.apply(pop.init_carry("cpu"), x)
    _, jy = jop.apply(jop.init_carry(), _j(np.ones(256, np.complex64)))
    assert snr_db(_c(jy), _c(y)) > 110


# -- the fusion rule ----------------------------------------------------------

def test_fusion_rule_and_small_block_fallback():
    """Channelizer -> FMDemod fuses to WidebandFM('channel') wherever the
    block holds >= P frames; a smaller block binds the unfused pair."""
    from libsdr_tpu_torch.ops import Channelizer, FMDemod, WidebandFM

    m = 16
    p = P.Pipeline([Channelizer(m), FMDemod()])
    p.bind(P.StreamSpec(np.complex64, m * 25_000.0, m * 4))  # 4 < P = 8
    assert [type(s).__name__ for s in p.stages] == ["Channelizer",
                                                    "FMDemod"]
    assert p.out_spec.block_size == 4
    p2 = P.Pipeline([Channelizer(m), FMDemod(gain=0.5)])
    p2.bind(P.StreamSpec(np.complex64, m * 25_000.0, m * 16))
    assert [type(s) for s in p2.stages] == [WidebandFM]
    assert p2.stages[0].layout == "channel" and p2.stages[0].gain == 0.5
    # the scanner app's pipeline fuses the same way
    from libsdr_tpu_torch.apps.scanner import scanner_pipeline
    sp = scanner_pipeline(m * 25_000.0, m * 16 * 8, m)
    assert [type(s).__name__ for s in sp.stages] == [
        "WidebandFM", "ASKDetector", "BitStream"]
    assert sp.out_spec.channels == (m,) and sp.out_spec.ragged


def test_fusion_fallback_resets_folded_rotation(rng):
    """A FreqShift folded into an FMDemod by the first rule is restored
    when a later fused bind fails: the port's stream equals the JAX
    package's (both fall back to the unfused stages)."""
    from libsdr_tpu.ops import Channelizer as JCh
    from libsdr_tpu.ops import FMDemod as JFM
    from libsdr_tpu.ops import FreqShift as JFS
    from libsdr_tpu.ops import ToComplex as JTC
    from libsdr_tpu_torch.core import run_pipeline
    from libsdr_tpu_torch.ops import Channelizer, FMDemod, FreqShift
    from libsdr_tpu_torch.ops import ToComplex

    m, f = 16, 3_000.0
    fs = m * 25_000.0
    x = (rng.standard_normal(m * 4)
         + 1j * rng.standard_normal(m * 4)).astype(np.complex64)
    fused = P.Pipeline([FreqShift(f, "exact"), FMDemod("quadrature"),
                        ToComplex(), Channelizer(m), FMDemod()])
    fused.bind(P.StreamSpec(np.complex64, fs, m * 4))   # 4 frames < P
    assert [type(s).__name__ for s in fused.stages] == [
        "FreqShift", "FMDemod", "ToComplex", "Channelizer", "FMDemod"]
    assert fused.stages[1]._pending_rot_freqs == []
    _, got = run_pipeline(fused, [x], device="cpu")
    with kernel_mode("interpret"):
        jp = J.Pipeline([JFS(f, "exact"), JFM("quadrature"), JTC(),
                         JCh(m), JFM()])
        jp.bind(J.StreamSpec(np.complex64, fs, m * 4))
    _, want = J.core.run_pipeline(jp, [x])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_fused_pipeline_matches_jax_unfused(rng):
    """The fused pair streams like the JAX package's [Channelizer ->
    FMDemod] over three blocks."""
    from libsdr_tpu.ops import Channelizer as JCh
    from libsdr_tpu.ops import FMDemod as JFM
    from libsdr_tpu_torch.ops import Channelizer, FMDemod

    m, block = 64, 64 * 24
    pp = P.Pipeline([Channelizer(m, 8), FMDemod(gain=0.7)])
    pp.bind(P.StreamSpec(np.complex64, 1e6, block))
    jp = J.Pipeline([JCh(m, 8), JFM(gain=0.7)], optimize=False)
    jp.bind(J.StreamSpec(np.complex64, 1e6, block))
    assert type(pp.stages[0]).__name__ == "WidebandFM"

    def check(got, ref):
        err = _angle_err(got, ref, 0.7)
        assert np.median(err) < 1e-4 and np.percentile(err, 99) < P99
    jc, pc = jp.init_carry(), pp.init_carry("cpu")
    for _ in range(3):
        x = (rng.normal(size=block) + 1j * rng.normal(size=block)).astype(
            np.complex64)
        jc, jy = jp.apply(jc, _j(x))
        pc, py = pp.apply(pc, _t(x))
        check(_c(py), _c(jy))


# -- parallel/wideband.py builders --------------------------------------------

def test_wideband_step_matches_jax(rng):
    import jax
    from jax.sharding import Mesh

    m, block = 64, 64 * 32
    jstep, jinit, jplace = jwb.build_wideband_step(
        Mesh(np.asarray(jax.devices()[:1]), ("d",)), m, block)
    pstep, pinit, pplace = pwb.build_wideband_step(m, block, device="cpu")
    jc, pc = jinit(), pinit()
    for _ in range(2):
        x = (rng.normal(size=block) + 1j * rng.normal(size=block)).astype(
            np.complex64)
        jc, jy = jstep(jc, jplace(x))
        pc, py = pstep(pc, pplace(x))
        err = _angle_err(_c(py), np.asarray(jy))
        assert py.shape == (m, block // m)
        assert np.median(err) < MEDIAN and np.percentile(err, 99) < P99
    # a list of devices is refused: the sharded paths take a mesh
    with pytest.raises(ConfigError, match="2 devices: pass a mesh"):
        pwb.build_wideband_step(m, block, device=["cpu", "cpu"])


# -- BPSK31 -------------------------------------------------------------------

def _bpsk31_signal(text):
    from libsdr_tpu_torch.decode import varicode_encode_bits

    bits = varicode_encode_bits(text)
    bits = np.concatenate([np.ones(16, np.uint8), bits,
                           np.ones(16, np.uint8)])
    phases = np.cumsum(np.where(bits == 0, np.pi, 0.0))
    sig = np.exp(1j * np.repeat(phases, 64)).astype(np.complex64)
    return np.concatenate([sig, np.ones((-len(sig)) % 1000, np.complex64)])


def test_bpsk31_bits_equal_jax():
    """tests/test_decode.py::test_bpsk31_decodes_varicode's signal: the same
    bits and valid flags as the JAX scan, block by block, with the carry
    handed to the JAX package and back halfway."""
    from libsdr_tpu.ops import BPSK31 as JBPSK31
    from libsdr_tpu.ops.interpolate import interpolation_bank as jbank
    from libsdr_tpu_torch.decode import VaricodeDecoder
    from libsdr_tpu_torch.ops import BPSK31
    from libsdr_tpu_torch.ops.interpolate import interpolation_bank

    assert interpolation_bank().tobytes() == jbank().tobytes()

    sig = _bpsk31_signal("cq cq de test")
    jop, pop = JBPSK31(), BPSK31()
    jop.bind(J.StreamSpec(np.complex64, 2000, 1000))
    pop.bind(P.StreamSpec(np.complex64, 2000, 1000))
    jc, pc = jop.init_carry(), pop.init_carry("cpu")
    bits = []
    for i in range(len(sig) // 1000):
        blk = sig[i * 1000:(i + 1) * 1000]
        if i == 3:
            host = interop.state_to_numpy(pc)
            assert host["dl_idx"].shape == ()
            jc = _to_jax(host)
            pc = interop.state_from_numpy(host, "cpu")
        jc, jy = jop.apply(jc, _j(blk))
        pc, py = pop.apply(pc, _t(blk))
        np.testing.assert_array_equal(py.valid.numpy(), np.asarray(jy.valid))
        np.testing.assert_array_equal(py.data.numpy(), np.asarray(jy.data))
        bits.append(py.data.numpy()[py.valid.numpy()])
    assert "cq cq de test" in VaricodeDecoder().process(np.concatenate(bits))


def test_psk31_rx_matches_jax(tmp_path):
    from libsdr_tpu.apps import psk31_rx as jpsk
    from libsdr_tpu_torch.apps import psk31_rx
    from libsdr_tpu_torch.io import write_wav_iq

    cap = tmp_path / "psk.wav"
    write_wav_iq(str(cap), 0.8 * _bpsk31_signal("cq de tpu"), 2000)
    got = psk31_rx.main(["--file", str(cap), "--block-size", "2000",
                         "--device", "cpu"])
    assert "cq de tpu" in got
    assert got == jpsk.main(["--file", str(cap), "--block-size", "2000"])


# -- the apps -----------------------------------------------------------------

def test_scanner_matches_jax():
    """tests/test_apps.py::test_wideband_scanner's band: the same pages on
    the same channels as the JAX scanner, through the app's scan() and the
    scanner step's carry crossing the packages."""
    from libsdr_tpu.apps import scanner as jscan
    from libsdr_tpu_torch.apps import scanner
    from tests.test_apps import _pocsag_iq

    m, ch_bw = 16, 25_000.0
    fs = m * ch_bw
    pages = {2: ("CHANNEL TWO", 222), 7: ("CHANNEL SEVEN", 777),
             13: ("UNLUCKY", 1313)}
    n = int(fs * 1.2)
    t = np.arange(n) / fs
    wide = np.zeros(n, np.complex64)
    for ch, (text, addr) in pages.items():
        narrow = _pocsag_iq(ch_bw, text=text, address=addr)
        idx = np.minimum((np.arange(n) / m).astype(np.int64),
                         len(narrow) - 1)
        f_c = ch * fs / m if ch <= m // 2 else (ch * fs / m) - fs
        wide += (0.5 * narrow[idx] * np.exp(2j * np.pi * f_c * t)).astype(
            np.complex64)
    block = int(fs * 0.6) // (m * 16) * m * 16
    got = scanner.scan(wide, fs, m, block=block, device="cpu")
    want = jscan.scan(wide, fs, m, block=block)
    summary = {ch: [(x.address, x.as_text()) for x in msgs]
               for ch, msgs in got.items()}
    assert summary == {ch: [(x.address, x.as_text()) for x in msgs]
                       for ch, msgs in want.items()}
    for ch, (text, addr) in pages.items():
        assert summary[ch][0][0] == addr
        assert summary[ch][0][1].startswith(text)
    # the scanner step's carry (wideband carry, BitStream carry) crosses
    import jax
    from jax.sharding import Mesh
    jstep, jinit, jplace = jwb.build_scanner_step(
        Mesh(np.asarray(jax.devices()[:1]), ("d",)), m, block, fs,
        compact_window=16, packed=True)
    pstep, pinit, pplace = pwb.build_scanner_step(
        m, block, fs, compact_window=16, packed=True, device="cpu")
    pc, py = pstep(pinit(), pplace(wide[:block]))
    jc = _to_jax(interop.state_to_numpy(pc))
    _, jy = jstep(jc, jplace(wide[block:2 * block]))
    pc = interop.state_from_numpy(interop.state_to_numpy(pc), "cpu")
    _, py = pstep(pc, pplace(wide[block:2 * block]))
    assert (py.numpy() == np.asarray(jy)).mean() > 0.999


def test_scanner_matches_jax_permuted_lanes():
    """At M = 256 the kernel's lanes are permuted (lane 128 (c mod 2) +
    c // 2), and the scanner puts its bits back in channel order: pages on
    even and odd channels, on both sides of the +-fs/2 edge and beside the
    wrap, decode on their own channel and nowhere else, as in the JAX
    scanner (tools/wideband_signals: band-limited channels, each page with
    its channel's address)."""
    from libsdr_tpu.apps import scanner as jscan
    from libsdr_tpu_torch.apps import scanner
    from libsdr_tpu_torch.tools import wideband_signals as W

    m, ch_bw = 256, 24_000.0
    fs = m * ch_bw
    chans = (0, 5, 126, 131, 200, 252)
    plan = [(ch, W.page_iq(ch_bw, W.page_address(ch), W.page_text(ch)),
             400 + 700 * i) for i, ch in enumerate(chans)]
    gen = torch.Generator().manual_seed(4)
    wide = cplx.to_numpy(W.upmix(plan, m, m * 2 * 14_000, "cpu", gen=gen,
                                 sigma=0.01))
    block = m * 14_000
    got = scanner.scan(wide, fs, m, block=block, device="cpu")
    want = jscan.scan(wide, fs, m, block=block)
    summary = {ch: [(x.address, x.as_text()) for x in msgs]
               for ch, msgs in got.items()}
    assert summary == {ch: [(x.address, x.as_text()) for x in msgs]
                       for ch, msgs in want.items()}
    for ch in chans:
        where = {c for c, msgs in got.items()
                 if any(x.address == W.page_address(ch) for x in msgs)}
        assert where == {ch}
        assert summary[ch][0][1].startswith(W.page_text(ch))


def _mode_summary(found):
    out = {}
    for ch, (mode, dec) in found.items():
        if mode == "pocsag":
            out[ch] = (mode, [(m.address, m.as_text()) for m in dec])
        elif mode == "ax25":
            out[ch] = (mode, [(str(f), a is not None) for f, a in dec])
        else:
            out[ch] = (mode, dec.strip())
    return out


@pytest.mark.parametrize("ch_bw,mode_map", [
    (24_000.0, {2: "pocsag", 3: "ax25", 5: "rtty", 6: "psk31"}),
    (26_000.0, {3: "psk31"})])
def test_multimode_matches_jax(ch_bw, mode_map):
    """make_mixed_band (tests/test_apps.py) through the port's bank and
    the JAX bank: the same decodes on every channel, also at 26 kHz
    spacing (PSK31 decimator 13)."""
    from libsdr_tpu.apps import multimode as jmm
    from libsdr_tpu_torch.apps import multimode
    from tests.test_apps import make_mixed_band

    m = 8
    fs = m * ch_bw
    assert multimode._t_quantum(fs, m, mode_map.values()) == \
        jmm._t_quantum(fs, m, mode_map.values())
    wide = make_mixed_band(mode_map, m, ch_bw=ch_bw)
    got = _mode_summary(multimode.scan_multimode(wide, fs, m, mode_map,
                                                 device="cpu"))
    assert got == _mode_summary(jmm.scan_multimode(wide, fs, m, mode_map))
    assert set(got) == set(mode_map)
    if 6 in got:
        assert "cq tpu" in got[6][1] and "MULTI" in got[5][1]
        assert got[2][1][0][0] == 99


def test_multimode_cli_map(tmp_path):
    from libsdr_tpu.apps import multimode as jmm
    from libsdr_tpu_torch.apps import multimode
    from libsdr_tpu_torch.io import write_wav_iq
    from libsdr_tpu_torch.tools.wideband_signals import (mixed_band,
                                                         mixed_marks)

    m = 8
    active = {1: "rtty", 6: "pocsag"}
    wide = cplx.to_numpy(mixed_band(active, m, "cpu"))
    cap = tmp_path / "band.wav"
    write_wav_iq(str(cap), wide, m * 24_000)
    args = ["--file", str(cap), "--channels", "8", "--map", "1:rtty,6:pocsag"]
    got = multimode.main(args + ["--device", "cpu"])
    assert _mode_summary(got) == _mode_summary(jmm.main(args))
    assert {ch: mixed_marks(mo, d) for ch, (mo, d) in got.items()} == \
        {1: {1}, 6: {6}}


def test_spectrum_matches_jax(tmp_path):
    from libsdr_tpu.apps import spectrum as jspec
    from libsdr_tpu_torch.apps import spectrum
    from libsdr_tpu_torch.io import write_wav_iq
    from libsdr_tpu_torch.ops import siggen

    fs, n = 96_000, 96_000
    iq = (0.8 * siggen.iq_carrier(fs, n, 12_000)
          + 0.2 * siggen.iq_carrier(fs, n, -25_000)
          + 0.01 * (np.random.default_rng(0).normal(size=n)
                    + 1j * np.random.default_rng(1).normal(size=n))
          ).astype(np.complex64)
    cap = tmp_path / "cap.wav"
    write_wav_iq(str(cap), iq, fs)
    got = spectrum.main(["--file", str(cap), "--nfft", "4096",
                         "--device", "cpu"])
    want = jspec.main(["--file", str(cap), "--nfft", "4096"])
    assert [p["freq_hz"] for p in got["peaks"]] == \
        [p["freq_hz"] for p in want["peaks"]]
    for a, b in zip(got["peaks"], want["peaks"]):
        assert abs(a["power_db"] - b["power_db"]) <= 0.02
    f, psd = spectrum.welch_psd(iq.real.copy(), fs, 1024, device="cpu")
    jf, jpsd = jspec.welch_psd(iq.real.copy(), fs, 1024)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(psd, jpsd, atol=1e-3)


def test_scanner_and_multimode_empty_capture():
    from libsdr_tpu_torch.apps import multimode, scanner

    short = np.zeros(100, np.complex64)
    assert scanner.scan(short, fs=1_000_000.0, n_channels=8,
                        device="cpu") == {}
    assert multimode.scan_multimode(short, 192_000.0, 8,
                                    {2: "pocsag", 3: "ax25"},
                                    device="cpu") == {}
