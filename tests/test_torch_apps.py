"""The port's CLIs (``libsdr_tpu_torch.apps``: rx in all five modes and
with ``--switch``, fm_rx, wavplay, pocsag_rx, ax25_rx, rtty_rx and tx)
against the JAX package's, on the synthesized captures of
tests/test_apps.py, run with ``--device cpu``.  The digital receivers
decode the same messages as the JAX CLIs.

Each port CLI writes the JAX CLI's WAV within 1 LSB of the 16-bit output:
both chains compute in float32 and differ by round-off (~1e-6), by the AGC
envelope's association (~1e-5) or, for FM, by the fused chain's polynomial
atan2 (|err| < 2e-5 rad times the discriminator gain <= 0.85), all under the
3.05e-5 of one LSB; a value on a rounding edge moves by one LSB.  The tone
checks of tests/test_apps.py run on the port's output as well.
"""

import numpy as np
import pytest
import torch

from libsdr_tpu.apps import fm_rx as j_fm_rx
from libsdr_tpu.apps import rx as j_rx
from libsdr_tpu.apps import wavplay as j_wavplay
from libsdr_tpu.core import fuse as jfuse
from libsdr_tpu.io import read_wav as j_read_wav
from libsdr_tpu.io import write_wav as j_write_wav
from libsdr_tpu.io import write_wav_iq as j_write_wav_iq
from libsdr_tpu_torch.apps import fm_rx, rx, wavplay
from libsdr_tpu_torch.io import (read_wav, read_wav_iq, write_wav,
                                 write_wav_iq)
from libsdr_tpu_torch.ops import siggen

LSB = 1.0 / 32768


def _peak(audio, rate, lo=100.0):
    seg = audio.astype(np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1 / rate)
    spec[freqs < lo] = 0
    return freqs[np.argmax(spec)]


def _both(tmp_path, jax_main, port_main, args):
    """Run the JAX CLI and the port's CLI on the same arguments; return the
    two WAVs as (samples, rate)."""
    jax_main(args + ["-o", str(tmp_path / "jax.wav")])
    port_main(args + ["-o", str(tmp_path / "port.wav"), "--device", "cpu"])
    return read_wav(str(tmp_path / "jax.wav")), read_wav(
        str(tmp_path / "port.wav"))


def _assert_same_wav(a, b):
    (ja, jr), (pa, pr) = a, b
    assert pr == jr and pa.shape == ja.shape
    assert np.abs(pa - ja).max() <= LSB


def _ssb_am_capture(path, mode, tone):
    """tests/test_apps.py::test_rx_cli_modes' capture (LSB: the tone below
    the carrier)."""
    fs = 96_000
    n = 4 * fs
    if mode == "AM":
        audio = siggen.sine(fs, n, tone, amps=0.5)
        base = (1.0 + audio) * siggen.iq_carrier(fs, n, 5000.0)
    else:
        sign = 1.0 if mode == "USB" else -1.0
        base = siggen.iq_carrier(fs, n, 5000.0 + sign * tone)
    j_write_wav_iq(str(path), 0.5 * base, fs)


@pytest.mark.parametrize("mode,tone", [("AM", 800.0), ("USB", 700.0),
                                       ("LSB", 600.0)])
def test_rx_am_ssb_like_jax(tmp_path, mode, tone):
    cap = tmp_path / "cap.wav"
    _ssb_am_capture(cap, mode, tone)
    a, b = _both(tmp_path, j_rx.main, rx.main,
                 ["--file", str(cap), "-m", mode, "-F", "5000",
                  "--block-size", "24000"])
    _assert_same_wav(a, b)
    got, rate = b
    assert abs(_peak(got[rate // 2:-rate // 2], rate) - tone) < 10


def _fm_capture(path):
    """tests/test_apps.py::test_fm_rx_cli's capture."""
    fs = 480_000
    audio = siggen.sine(fs, fs, 1000.0, amps=0.7)
    j_write_wav_iq(str(path), siggen.fm_modulate(fs, audio, deviation=75e3,
                                                 carrier=60e3), fs)


def test_fm_rx_like_jax(tmp_path):
    cap = tmp_path / "cap.wav"
    _fm_capture(cap)
    a, b = _both(tmp_path, j_fm_rx.main, fm_rx.main,
                 ["--file", str(cap), "-F", "60000", "--block-size", "48000"])
    _assert_same_wav(a, b)
    got, rate = b
    assert rate == 48000
    assert abs(_peak(got[4800:-4800], rate, 0.0) - 1000.0) < 5


def test_rx_wfm_like_jax(tmp_path):
    cap = tmp_path / "cap.wav"
    _fm_capture(cap)
    a, b = _both(tmp_path, j_rx.main, rx.main,
                 ["--file", str(cap), "-m", "WFM", "-F", "60000",
                  "--block-size", "48000"])
    _assert_same_wav(a, b)
    got, rate = b
    assert abs(_peak(got[4800:-4800], rate, 0.0) - 1000.0) < 5


def _switch_capture(path):
    """tests/test_apps.py::test_rx_cli_live_mode_switch's capture: NFM for
    the first half second, AM for the second."""
    fs = 960_000
    n = fs
    t = np.arange(n) / fs
    audio_f = np.sin(2 * np.pi * 800.0 * t[: n // 2])
    fm = np.exp(1j * 2 * np.pi * 4500.0 * np.cumsum(audio_f) / fs)
    am = 0.6 + 0.4 * np.sin(2 * np.pi * 1100.0 * t[n // 2:])
    j_write_wav_iq(str(path), 0.5 * np.concatenate([fm, am]).astype(
        np.complex64), fs)


@pytest.mark.parametrize("switch", [False, True])
def test_rx_nfm_and_switch_to_am_like_jax(tmp_path, monkeypatch, switch):
    """With --switch the JAX CLI runs with its fusion on, as on its TPU.
    Unfused (its CPU default) its switch_stages transplants the FMDeemph
    state into the new AGC's envelope, a leaf of the same shape and dtype;
    fused, as in the port, the envelope starts at the AGC's target."""
    cap = tmp_path / "switch.wav"
    _switch_capture(cap)
    args = ["--file", str(cap), "-m", "NFM", "--block-size", "96000"]
    if switch:
        args += ["--switch", "0.5:AM"]
        monkeypatch.setattr(jfuse, "_on_tpu", lambda: True)
    a, b = _both(tmp_path, j_rx.main, rx.main, args)
    _assert_same_wav(a, b)
    audio, rate = b
    assert rate == 24000
    half = len(audio) // 2
    assert abs(_peak(audio[half // 4:half], rate) - 800.0) < 10
    if switch:  # the AM envelope's DC term is skipped
        assert abs(_peak(audio[half + half // 4:], rate) - 1100.0) < 10


def test_wavplay_like_jax(tmp_path):
    fs = 8000
    src = tmp_path / "in.wav"
    j_write_wav(str(src), siggen.sine(fs, fs, 440.0, amps=0.5), fs)
    a, b = _both(tmp_path, j_wavplay.main, wavplay.main,
                 [str(src), "--gain", "0.5", "--block-size", "1000"])
    assert b[1] == a[1] == fs
    np.testing.assert_array_equal(b[0], a[0])


def test_wav_io_round_trips_with_jax(tmp_path, rng):
    """Files written by either package read back identically in the
    other: mono audio, stereo IQ, and the bytes on disk."""
    audio = np.clip(0.4 * rng.normal(size=4000), -1, 0.99).astype(
        np.float32)
    iq = (np.clip(0.3 * rng.normal(size=3000), -1, 0.99)
          + 1j * np.clip(0.3 * rng.normal(size=3000), -1, 0.99)
          ).astype(np.complex64)
    write_wav(str(tmp_path / "p.wav"), audio, 11025)
    j_write_wav(str(tmp_path / "j.wav"), audio, 11025)
    write_wav_iq(str(tmp_path / "piq.wav"), iq, 48000)
    j_write_wav_iq(str(tmp_path / "jiq.wav"), iq, 48000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path /
                                                 "j.wav").read_bytes()
    assert (tmp_path / "piq.wav").read_bytes() == (tmp_path /
                                                   "jiq.wav").read_bytes()
    got, rate = j_read_wav(str(tmp_path / "p.wav"))
    mine, rate2 = read_wav(str(tmp_path / "j.wav"))
    assert rate == rate2 == 11025
    np.testing.assert_array_equal(got, mine)
    np.testing.assert_allclose(mine, audio, atol=LSB)
    back, r = read_wav_iq(str(tmp_path / "jiq.wav"))
    assert r == 48000 and back.dtype == np.complex64
    np.testing.assert_allclose(back, iq, atol=LSB)


def test_cuda_device_refused_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cap = tmp_path / "cap.wav"
    j_write_wav_iq(str(cap), np.zeros(4800, np.complex64), 48000)
    with pytest.raises(SystemExit, match="no CUDA device"):
        rx.main(["--file", str(cap), "-m", "AM", "-o",
                 str(tmp_path / "out.wav")])


# -- the digital receivers and the signal generator --------------------------

def _nrzi(bits):
    line, cur = [], 0
    for b in np.asarray(bits):
        if b == 0:
            cur ^= 1
        line.append(cur)
    return np.asarray(line, np.uint8)


def _pocsag(ms):
    return [(m.address, m.function, m.bits, m.as_text()) for m in ms]


def _ax25(dec):
    return ([str(m) for m in dec.messages],
            [str(a) for a in dec.aprs_messages])


def test_pocsag_rx_like_jax(tmp_path):
    """tests/test_apps.py::test_pocsag_rx_cli's capture."""
    from libsdr_tpu.apps import pocsag_rx as j_pocsag_rx
    from libsdr_tpu.decode import pocsag_encode_batch
    from libsdr_tpu_torch.apps import pocsag_rx

    fs = 240_000
    bits = pocsag_encode_batch(address=4242, function=1, text="TPU PAGER")
    spb = fs / 1200.0
    n = int(len(bits) * spb)
    idx = np.minimum((np.arange(n) / spb).astype(np.int64), len(bits) - 1)
    dev = np.where(bits[idx] > 0, -4500.0, 4500.0)
    iq = np.exp(1j * 2 * np.pi * np.cumsum(dev) / fs).astype(np.complex64)
    cap = tmp_path / "pocsag.wav"
    j_write_wav_iq(str(cap), 0.9 * iq, fs)
    args = ["--file", str(cap), "--block-size", "24000"]
    got = pocsag_rx.main(args + ["--device", "cpu"])
    assert _pocsag(got) == _pocsag(j_pocsag_rx.main(args))
    assert got[0].address == 4242 and got[0].as_text().startswith(
        "TPU PAGER")


def _afsk_audio(fs=24_000):
    """tests/test_apps.py::test_ax25_rx_cli's audio."""
    from libsdr_tpu.decode import ax25_frame_bits

    line = _nrzi(ax25_frame_bits("N0CALL", "APRS",
                                 b"!4903.50N/07201.75W-TPU", n_flags=50))
    audio = siggen.fsk_modulate(fs, line, 1202.0, 1200.0, 2200.0).real
    return np.concatenate([audio, np.zeros(4000, np.float32)])


@pytest.mark.parametrize("iq", [False, True])
def test_ax25_rx_like_jax(tmp_path, iq):
    """From demodulated audio (--audio) and from an FM IQ capture at
    240 kHz, which the NFM front end demodulates first."""
    from libsdr_tpu.apps import ax25_rx as j_ax25_rx
    from libsdr_tpu_torch.apps import ax25_rx

    audio = _afsk_audio()
    cap = tmp_path / "afsk.wav"
    if iq:
        j_write_wav_iq(str(cap), 0.8 * siggen.fm_modulate(
            240_000, np.repeat(audio, 10), deviation=3e3), 240_000)
        args = ["--file", str(cap), "--block-size", "24000"]
    else:
        j_write_wav(str(cap), 0.8 * audio.astype(np.float32), 24_000)
        args = ["--file", str(cap), "--audio", "--block-size", "12000"]
    got = ax25_rx.main(args + ["--device", "cpu"])
    assert _ax25(got) == _ax25(j_ax25_rx.main(args))
    assert got.messages and got.aprs_messages[0].has_location


def test_rtty_rx_like_jax(tmp_path):
    """tests/test_apps.py::test_rtty_rx_cli's capture."""
    from libsdr_tpu.apps import rtty_rx as j_rtty_rx
    from libsdr_tpu.decode import baudot_encode_bits
    from libsdr_tpu_torch.apps import rtty_rx

    fs = 8000
    half_bits = baudot_encode_bits("RYRY HELLO RTTY", stop_bits="1.5")
    audio = siggen.fsk_modulate(fs, half_bits, 2 * 45.45, 930.0, 1100.0).real
    cap = tmp_path / "rtty.wav"
    j_write_wav(str(cap), 0.8 * np.concatenate(
        [audio, np.zeros(2000, np.float32)]).astype(np.float32), fs)
    args = ["--file", str(cap), "--block-size", "8000"]
    got = rtty_rx.main(args + ["--device", "cpu"])
    assert got == j_rtty_rx.main(args) and "HELLO RTTY" in got


def test_tx_loopback_like_jax(tmp_path):
    """tests/test_apps.py::test_tx_loopback: the port's generator writes
    the JAX generator's files byte for byte, and its receivers decode them
    as the JAX receivers do."""
    from libsdr_tpu.apps import ax25_rx as j_ax25_rx
    from libsdr_tpu.apps import pocsag_rx as j_pocsag_rx
    from libsdr_tpu.apps import rtty_rx as j_rtty_rx
    from libsdr_tpu.apps import tx as j_tx
    from libsdr_tpu_torch.apps import ax25_rx, pocsag_rx, rtty_rx, tx

    for mode, extra in (("pocsag", ["--address", "777", "--text",
                                    "LOOPBACK"]),
                        ("afsk", ["--from-call", "K2TX", "--info",
                                  "!4903.50N/07201.75W-tx"]),
                        ("rtty", ["--text", "RYRY TX LOOP", "--fs", "8000"]),
                        ("psk31", ["--text", "tx ok"]),
                        ("fm", ["--seconds", "0.1"])):
        f = tx.main([mode, "-o", str(tmp_path / f"{mode}.wav")] + extra)
        jf = j_tx.main([mode, "-o", str(tmp_path / f"j{mode}.wav")] + extra)
        assert (tmp_path / f"{mode}.wav").read_bytes() == (
            tmp_path / f"j{mode}.wav").read_bytes()
        if mode == "pocsag":
            args = ["--file", f, "--block-size", "24000"]
            got = pocsag_rx.main(args + ["--device", "cpu"])
            assert _pocsag(got) == _pocsag(j_pocsag_rx.main(["--file", jf,
                                                             "--block-size",
                                                             "24000"]))
            assert got[0].address == 777
            assert got[0].as_text().startswith("LOOPBACK")
        elif mode == "afsk":
            args = ["--file", f, "--audio", "--block-size", "12000"]
            got = ax25_rx.main(args + ["--device", "cpu"])
            assert _ax25(got) == _ax25(j_ax25_rx.main(args))
            assert got.messages[0].frm.call == "K2TX"
        elif mode == "rtty":
            args = ["--file", f, "--block-size", "8000"]
            got = rtty_rx.main(args + ["--device", "cpu"])
            assert got == j_rtty_rx.main(args) and "TX LOOP" in got


@pytest.mark.parametrize("app", ["pocsag_rx", "ax25_rx", "rtty_rx"])
def test_digital_apps_refuse_cuda_without_a_card(tmp_path, app):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = importlib.import_module(f"libsdr_tpu_torch.apps.{app}").main
    cap = tmp_path / "cap.wav"
    j_write_wav(str(cap), np.zeros(8000, np.float32), 8000)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--file", str(cap)])
