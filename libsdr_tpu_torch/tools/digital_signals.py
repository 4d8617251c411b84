"""Synthetic traffic for the digital receive banks, made from a seed.

Each bank carries real messages, so the PLL sees the crossings of real
bit streams and the decoders have something to find:

* :func:`ax25_bank`: the AX.25/APRS bank (P1), every channel FM-modulated
  (3 kHz deviation, 24 kHz off centre at 192 kHz) by AFSK1200 frames;
* :func:`pocsag_blocks`: the POCSAG bank (P2), one page per channel at
  per-channel gains;
* :func:`mode_bank`: the multi-mode bank (P3) at 24 kHz a channel, one
  third each of POCSAG pagers, AX.25 over FM and RTTY on USB, channels
  assigned round-robin, each with its own gain, time offset and noise;
  :func:`mode_chains` builds the bank's three receive chains.

The message bits are numpy on the host; the channels, their gains, offsets
and noise are made on the device of the generator ``gen``.  Used by
``chip_smoke.py`` and :mod:`libsdr_tpu_torch.tools.digital_profile`.
"""

from __future__ import annotations

import numpy as np
import torch

from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.decode import (ax25_frame_bits, baudot_encode_bits,
                                     pocsag_encode_batch)
from libsdr_tpu_torch.ops import siggen

AX25_INFO = b"!4903.50N/07201.75W-frame"
POCSAG_ADDRESS, POCSAG_TEXT = 1234, "CAPACITY BENCH"
RTTY_TEXT = "RYRY CQ DE N0CALL"
MODES = ("pocsag", "ax25", "rtty")
NOISE = 0.02   # per-plane noise deviation, against signal amplitudes 0.5-1


def _nrzi(bits):
    """NRZI line levels: a 0 bit toggles the line, a 1 holds it."""
    return (np.cumsum(np.asarray(bits) == 0) & 1).astype(np.uint8)


def ax25_audio(fs_audio: float, n: int, frames: int = 8) -> np.ndarray:
    """``n`` samples at ``fs_audio`` of ``frames`` AFSK1200 AX.25 frames
    (info ``AX25_INFO + str(k)``; a 0.17% clock offset, as real
    transmitters have) spaced evenly by silence."""
    out = np.zeros(n, np.float32)
    step = n // frames
    for f in range(frames):
        line = _nrzi(ax25_frame_bits("N0CALL", "APRS",
                                     AX25_INFO + str(f).encode(),
                                     n_flags=20))
        a = siggen.fsk_modulate(fs_audio, line, 1200.0 * 1.0017, 1200.0,
                                2200.0).real
        k = min(len(a), step - 2000)
        out[f * step + 2000:f * step + 2000 + k] = a[:k]
    return out


def _noisy(sig: Complex, gen, gains=None, sigma=NOISE) -> Complex:
    """Rows of ``sig`` times ``gains`` plus independent complex noise of
    deviation ``sigma`` a plane."""
    def plane(p):
        p = p if gains is None else p * gains
        return p + sigma * torch.randn(p.shape, generator=gen,
                                       device=gen.device)
    return Complex(plane(sig.re), plane(sig.im))


def _on(a: np.ndarray, device) -> Complex:
    a = np.asarray(a, np.complex64)
    return Complex(torch.from_numpy(a.real.copy()).to(device),
                   torch.from_numpy(a.imag.copy()).to(device))


def ax25_bank(c: int, b: int, gen, fs: float = 192_000.0,
              frames: int = 8) -> Complex:
    """(c, b) float32 planes: every channel FM-modulated by
    :func:`ax25_audio` at fs/4 (``frames`` frames), with its own noise
    (0.05 a plane: 23 dB SNR)."""
    audio = np.repeat(ax25_audio(fs / 4, b // 4, frames), 4)
    inst = 2 * np.pi * (24e3 / fs) + 2 * np.pi * (3e3 / fs) * audio.astype(
        np.float64)
    ph = torch.tensor(np.mod(np.cumsum(inst), 2 * np.pi), device=gen.device)
    one = Complex(torch.cos(ph).float()[None], torch.sin(ph).float()[None])
    return _noisy(Complex(one.re.expand(c, b), one.im.expand(c, b)), gen,
                  sigma=0.05)


def pocsag_iq(fs: float, n: int, gap_s: float = 0.0,
              address: int = POCSAG_ADDRESS,
              text: str = POCSAG_TEXT) -> np.ndarray:
    """``n`` samples at ``fs`` of a POCSAG page (by default address
    ``POCSAG_ADDRESS``, ``POCSAG_TEXT``) at 1200 baud, FSK +-4.5 kHz, sent
    once (``gap_s`` = 0, silence after it) or repeated with ``gap_s`` of
    silence between pages."""
    bits = pocsag_encode_batch(address=address, function=1, text=text)
    spb = fs / 1200.0
    nsig = int(len(bits) * spb)
    idx = np.minimum((np.arange(nsig) / spb).astype(np.int64), len(bits) - 1)
    dev = np.where(bits[idx] > 0, -4500.0, 4500.0)
    page = np.exp(1j * 2 * np.pi * np.cumsum(dev) / fs).astype(np.complex64)
    return _fill(page, n, int(gap_s * fs) if gap_s else None)


def _fill(msg: np.ndarray, n: int, gap) -> np.ndarray:
    """``msg`` once at the start of n samples (gap None), or repeated with
    ``gap`` samples of silence between copies."""
    out = np.zeros(n, msg.dtype)
    period = n if gap is None else len(msg) + gap
    for s in range(0, n, period):
        k = min(len(msg), n - s)
        out[s:s + k] = msg[:k]
    return out


def pocsag_blocks(c: int, blk: int, nb: int, gen, fs: float = 240_000.0):
    """``nb`` consecutive (c, blk) blocks of one POCSAG page per channel
    (0.9 x a gain in 0.5-1, drawn per channel) with noise."""
    one = _on(0.9 * pocsag_iq(fs, blk * nb), gen.device)
    gains = 0.5 + 0.5 * torch.rand((c, 1), generator=gen, device=gen.device)
    return [_noisy(one[None, k * blk:(k + 1) * blk], gen, gains)
            for k in range(nb)]


def _mode_signals(fs: float, t: int) -> dict:
    """One channel of each mode of the multi-mode bank, t samples at fs
    (complex baseband): the POCSAG page over and over (0.1 s apart); AX.25
    frames (info ``AX25_INFO``) as AFSK over FM at 3 kHz deviation
    (0.1 s apart); and RTTY, ``RTTY_TEXT`` sent without pause, as USB
    tones at 930/1100 Hz, 45.45 baud."""
    frame = _nrzi(ax25_frame_bits("N0CALL", "APRS", AX25_INFO, n_flags=20))
    afsk = siggen.fsk_modulate(fs, frame, 1200.0 * 1.0017, 1200.0,
                               2200.0).real
    ax25 = siggen.fm_modulate(fs, 0.8 * afsk, deviation=3000.0)
    rtty = siggen.fsk_modulate(fs, baudot_encode_bits(RTTY_TEXT + " ",
                                                      stop_bits="1.5"),
                               2 * 45.45, 930.0, 1100.0)
    return dict(pocsag=pocsag_iq(fs, t, gap_s=0.1),
                ax25=_fill(ax25, t, int(0.1 * fs)),
                rtty=_fill(rtty, t, 0))


def mode_bank(per: int, t: int, gen, fs: float = 24_000.0):
    """The multi-mode bank: (3 per, t) float32 planes and the groups
    {mode: channel rows}, round-robin (row 3i + k is mode k).  Each
    channel is its mode's signal (:func:`_mode_signals`) rotated by its own
    time offset, at a gain in 0.5-1, plus noise."""
    dev = gen.device
    sig = _mode_signals(fs, t)
    groups = {m: list(range(k, 3 * per, 3)) for k, m in enumerate(MODES)}
    re = torch.empty((3 * per, t), device=dev)
    im = torch.empty_like(re)
    n = torch.arange(t, device=dev)
    for mode in MODES:
        one = _on(sig[mode], dev)
        off = torch.randint(0, t, (per, 1), generator=gen, device=dev)
        idx = (n[None, :] + off) % t
        rows = groups[mode]
        re[rows[0]::3], im[rows[0]::3] = one.re[idx], one.im[idx]
    gains = 0.5 + 0.5 * torch.rand((3 * per, 1), generator=gen, device=dev)
    return _noisy(Complex(re, im), gen, gains), groups


def mode_chains(per: int, t: int, fs: float = 24_000.0):
    """The multi-mode bank's receive chains, as the JAX package's
    ``apps/multimode.py`` builds them, bound to ``per`` channels of
    ``t``-sample blocks: ({mode: Pipeline}, {mode: compaction window})."""
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.core.ragged import min_valid_gap, pick_window
    from libsdr_tpu_torch.ops import (ASKDetector, BitStream, FMDemod,
                                      FSKDetector, USBDemod)

    stages = {
        "pocsag": [FMDemod(), ASKDetector(invert=True),
                   BitStream(1200.0, mode="normal")],
        "ax25": [FMDemod(), FSKDetector(1200.0, 1200.0, 2200.0),
                 BitStream(1200.0, mode="transition")],
        "rtty": [USBDemod(), FSKDetector(2 * 45.45, 930.0, 1100.0),
                 BitStream(2 * 45.45, mode="normal")]}
    sub, windows = {}, {}
    for mode in MODES:
        p = L.Pipeline(stages[mode])
        p.bind(L.StreamSpec(np.complex64, fs, t, channels=(per,)))
        sub[mode] = p
        windows[mode] = pick_window(min_valid_gap(p.stages[-1]), t, cap=256)
    return sub, windows
