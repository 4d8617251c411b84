"""``mode_band``: a wideband capture for the multi-mode decoder bank.  Every
channel carries its mode's traffic, the modes by the configuration's
repeating ``pattern`` (channel ch: ``pattern[ch % len(pattern)]``):

* ``pocsag``: a POCSAG page (``reference/pocsag.py``), FSK at +-
  ``deviation_hz``, mark (1) below the centre;
* ``ax25``: an APRS position report in an AX.25 UI frame
  (``reference/codes.py``), NRZI, Bell 202 AFSK (1200 Hz for a mark, 2200
  Hz for a space) at 1200 baud off by up to ``baud_error``, on FM at
  ``deviation_hz``;
* ``rtty``: ITA2 at 45.45 baud, 930 Hz (mark) and 1100 Hz (space) on the
  upper sideband;
* ``psk31``: Varicode after ``preamble`` reversals and before ``postamble``
  steady symbols, BPSK at 31.25 baud with the cosine envelope at each
  reversal, off the channel's centre by up to ``offset_hz``.

Each channel's message starts at a time drawn from the seed, at a gain
drawn from ``gain_range`` times ``amplitude``, and lies whole inside one
period of the capture; a channel whose message does not fit the period
(at a test's tiny size) carries none.  The channels are mixed to their
centres by one inverse FFT over the whole capture, as ``pocsag_pages``
does, and noise is added.  The capture is periodic in its length.

The block is ``block_samples`` rounded down to whole quanta of M x lcm(16,
D) samples (:func:`block_frames`), D = floor(channel rate / 2000) the
PSK31 chain's decimation: the bank's block must hold whole multiples of
both.  Nothing here imports the program."""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from benchmark.reference import codes, pocsag
from benchmark.signals import generator
from benchmark.signals.pocsag_pages import page_iq

PSK31_BAUD = 31.25
RTTY_BAUD = 45.45
RTTY_TONES = (930.0, 1100.0)          # mark, space
AFSK_TONES = (1200.0, 2200.0)         # mark, space
MARGIN_S = 0.02                       # a message's distance from the ends


class Message(typing.NamedTuple):
    """One planned message: its channel and mode, its first sample and
    length at the channel rate, its gain, and what it carries (a POCSAG
    page's (address, function, payload bits), an AX.25 frame without its
    FCS, or an RTTY or PSK31 text)."""
    ch: int
    mode: str
    start: int
    length: int
    gain: float
    content: object


def pattern(config: dict) -> list:
    return [p.strip() for p in config["pattern"].split(",")]


def mode_of(config: dict, ch: int) -> str:
    pat = pattern(config)
    return pat[ch % len(pat)]


def decimation(config: dict) -> int:
    """The PSK31 chain's decimation D = floor(channel rate / 2000)."""
    return int(float(config["sample_rate"]) / int(config["channels"])
               / 2000.0)


def block_frames(config: dict, traffic: dict) -> int:
    """Frames a block: ``block_samples`` / M rounded down to a multiple of
    lcm(16, D)."""
    q = math.lcm(16, decimation(config))
    return int(traffic["block_samples"]) // int(config["channels"]) // q * q


def tag(ch: int) -> str:
    """The channel's number in the letters a-z (a text of lower-case
    letters that every code here carries alike)."""
    out = ""
    while True:
        ch, r = divmod(ch, 26)
        out = chr(ord("a") + r) + out
        if not ch:
            return out


def _fill(fmt: str, ch: int) -> str:
    return fmt.format(ch=ch, tag=tag(ch))


def _tones(levels: np.ndarray, rate: float, fs: float, hi_lo) -> np.ndarray:
    """The phase (radians a sample, summed) of a continuous-phase FSK of
    ``levels`` at ``rate`` symbols a second: ``hi_lo[0]`` Hz for a 1, else
    ``hi_lo[1]``."""
    n = int(len(levels) * fs / rate)
    idx = np.minimum((np.arange(n) * rate / fs).astype(np.int64),
                     len(levels) - 1)
    f = np.where(levels[idx] > 0, hi_lo[0], hi_lo[1])
    return 2 * np.pi * np.cumsum(f) / fs


def _psk31_iq(bits: np.ndarray, fs: float) -> np.ndarray:
    """One PSK31 transmission of ``bits`` at the channel rate: differential
    BPSK (a 0 reverses the phase) from key-up to key-down, the envelope a
    half cosine across each symbol that changes the level, rising from
    silence in the first symbol and falling to it after the last."""
    spb = int(round(fs / PSK31_BAUD))
    lev = np.concatenate([[0.0], np.cumprod(np.where(bits == 0, -1.0, 1.0)),
                          [0.0]])
    w = 0.5 * (1 + np.cos(np.pi * np.arange(spb) / spb))   # 1 -> 0
    env = lev[:-1, None] * w + lev[1:, None] * (1 - w)
    return env.reshape(-1).astype(np.complex64)


def _message(config: dict, traffic: dict, ch: int, mode: str, rng):
    """(content, complex baseband at the channel rate) of channel ``ch``'s
    message."""
    fs = float(config["sample_rate"]) / int(config["channels"])
    tr = traffic[mode]
    if mode == "pocsag":
        bits = pocsag.encode_page(tr["address0"] + ch, 1,
                                  _fill(tr["text"], ch))
        (page,) = pocsag.decode(bits)
        return page, page_iq(bits, fs, 1200.0, tr["deviation_hz"])
    if mode == "ax25":
        frame = codes.ui_frame(_fill(tr["source"], ch), tr["destination"],
                               _fill(tr["info"], ch).encode("ascii"))
        levels = codes.nrzi(codes.hdlc_bits(frame, tr["lead_flags"]))
        baud = 1200.0 * (1 + rng.uniform(-1, 1) * tr["baud_error"])
        audio = np.cos(_tones(levels, baud, fs, AFSK_TONES))
        phase = 2 * np.pi * tr["deviation_hz"] * np.cumsum(audio) / fs
        return frame, np.exp(1j * phase).astype(np.complex64)
    if mode == "rtty":
        text = _fill(tr["text"], ch).upper()
        half = codes.ita2_half_bits(tr["sync"] + text)
        phase = _tones(half, 2 * RTTY_BAUD, fs, RTTY_TONES)
        return text, np.exp(1j * phase).astype(np.complex64)
    if mode == "psk31":
        text = _fill(tr["text"], ch)
        bits = np.concatenate([np.zeros(tr["preamble"], np.uint8),
                               codes.varicode_bits(text),
                               np.ones(tr["postamble"], np.uint8)])
        iq = _psk31_iq(bits, fs)
        off = rng.uniform(-1, 1) * tr["offset_hz"]
        turn = np.exp(2j * np.pi * off * np.arange(len(iq)) / fs)
        return text, (iq * turn).astype(np.complex64)
    raise ValueError(f"unknown mode {mode!r}")


def _messages(config: dict, traffic: dict, seed: int):
    """[(Message, its baseband)], one a channel whose message fits."""
    m = int(config["channels"])
    fs = float(config["sample_rate"]) / m
    frames = block_frames(config, traffic) * int(traffic["distinct_blocks"])
    margin = int(MARGIN_S * fs)
    lo, hi = traffic["gain_range"]
    rng = np.random.default_rng(seed)
    out = []
    for ch in range(m):
        mode = mode_of(config, ch)
        content, iq = _message(config, traffic, ch, mode, rng)
        span = frames - len(iq) - 2 * margin
        start = margin + int(rng.integers(0, max(span, 0) + 1))
        gain = float(rng.uniform(lo, hi))
        if span >= 0:
            out.append((Message(ch, mode, start, len(iq), gain, content),
                        iq))
    return out


def plan(config: dict, traffic: dict, seed: int) -> list:
    """The messages :func:`make` puts in the capture for ``seed``."""
    return [msg for msg, _ in _messages(config, traffic, seed)]


def make(config: dict, traffic: dict, seed: int, device):
    """The capture cut into ``distinct_blocks`` wideband blocks of
    :func:`block_frames` frames; returns (blocks, plan)."""
    m = int(config["channels"])
    b = block_frames(config, traffic) * m
    if b <= 0:
        raise ValueError("the block holds no whole quantum of frames")
    n = b * int(traffic["distinct_blocks"])
    nn = n // m
    k = torch.arange(nn, device=device)
    k = torch.where(k < (nn + 1) // 2, k, k - nn)
    keep = k != -(nn // 2) if nn % 2 == 0 else torch.ones_like(k, dtype=bool)
    k = k[keep]
    spec = torch.zeros(n, dtype=torch.complex64, device=device)
    msgs = _messages(config, traffic, seed)
    amp = float(traffic["amplitude"]) * m
    for msg, iq in msgs:
        buf = np.zeros(nn, np.complex64)
        buf[msg.start:msg.start + len(iq)] = iq * np.float32(msg.gain)
        xn = torch.fft.fft(torch.from_numpy(buf).to(device))[keep]
        spec[(msg.ch * nn + k) % n] += xn * amp
    x = torch.fft.ifft(spec)
    del spec
    re, im = x.real.contiguous(), x.imag.contiguous()
    del x
    gen = generator(seed, device)
    re += traffic["noise"] * torch.randn(n, generator=gen, device=device)
    im += traffic["noise"] * torch.randn(n, generator=gen, device=device)
    blocks = [(re[i * b:(i + 1) * b], im[i * b:(i + 1) * b])
              for i in range(n // b)]
    return blocks, [msg for msg, _ in msgs]
