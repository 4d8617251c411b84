"""Synthetic wideband traffic for the channelizer paths, made from a seed.

A narrowband message signal at the channel rate fs/M is interpolated to the
wideband rate band-limited to its channel and mixed to the channel's center
ch*fs/M (channels above M/2 are the negative band): its spectrum is placed
on the channel's bins of one inverse FFT over the whole band.  So a
channel reaches its neighbours only through the channelizer's own
prototype filter (a Blackman-windowed sinc: -39 dB at 0.75 channel
spacings, -76 dB at the next channel's center), not through interpolation
images: a hold-upsampled burst leaks about -13 dB into each neighbour and,
as an FM discriminator ignores level, decoded on dozens of other
channels.  Each
message carries its channel's number, so a decode shows where it came
from.  The bands keep at least 3 idle channels between active ones
(counting around the wrap: channel M-1 is next to channel 0).

* :func:`pager_band`: W1, the whole-band pager scanner's traffic: a POCSAG
  page (its own address and text) on each channel of
  :data:`PAGER_CHANNELS` (or a given set), at a start that puts some pages
  across a block edge;
* :func:`mixed_band`: W2, the multimode bank's traffic: each active
  channel carries its mode's message (POCSAG, AX.25/APRS, RTTY or PSK31,
  as the JAX package's app tests make them, with the channel's number in
  the address, call or text; :func:`mixed_marks` reads it back).

The narrowband signals are numpy on the host; the band is made on the
device asked for.  Used by ``chip_smoke.py``,
:mod:`libsdr_tpu_torch.tools.digital_profile` and the tests.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.decode import (ax25_frame_bits, baudot_encode_bits,
                                     pocsag_encode_batch,
                                     varicode_encode_bits)
from libsdr_tpu_torch.ops import siggen
from libsdr_tpu_torch.tools.digital_signals import _nrzi, pocsag_iq

# W1's active channels at M = 1024: every 16th channel, and 508, 516 and
# 1020 beside 512 and 0 (both sides of the +-fs/2 edge at 512, and the wrap
# from 1023 to 0), each 4 or more channels from the next.
PAGER_CHANNELS = tuple(sorted(set(range(0, 1024, 16)) | {508, 516, 1020}))
PAGE_SAMPLES = 24_160   # the longest W1 page at 24 kHz (1,208 bits)
MIXED_ADDRESS0 = 1000   # W2's POCSAG address on channel ch: 1000 + ch


def page_address(ch: int) -> int:
    """W1's POCSAG address on channel ``ch``."""
    return 100_000 + ch


def page_text(ch: int) -> str:
    return f"W1 CH {ch}"


def page_iq(fs: float, address: int, text: str) -> np.ndarray:
    """One POCSAG page at ``fs``, exactly as long as its bits."""
    n_bits = len(pocsag_encode_batch(address=address, function=1,
                                     text=text))
    return pocsag_iq(fs, int(n_bits * fs / 1200.0), address=address,
                     text=text)


def upmix(narrows, m: int, n: int, device, amp: float = 0.5, gen=None,
          sigma: float = 0.0) -> Complex:
    """The n wideband samples (n a multiple of M) of the channels
    ``narrows`` (a list of (ch, narrow numpy complex at fs/M, start in
    narrow samples)), each band-limited to its channel, as float32 planes on
    ``device``, plus complex noise of deviation ``sigma`` a plane drawn
    from ``gen`` (on ``device``)."""
    if n % m:
        raise ValueError(f"the band's {n} samples must divide by M = {m}")
    nn = n // m
    dev = torch.device(device)
    k = torch.arange(nn, device=dev)
    k = torch.where(k < (nn + 1) // 2, k, k - nn)
    keep = k != -(nn // 2) if nn % 2 == 0 else torch.ones_like(k, dtype=bool)
    k = k[keep]
    spec = torch.zeros(n, dtype=torch.complex64, device=dev)
    for ch, narrow, start in narrows:
        a = np.asarray(narrow, np.complex64)[:max(0, nn - int(start))]
        buf = np.zeros(nn, np.complex64)
        buf[int(start):int(start) + len(a)] = a
        xn = torch.fft.fft(torch.from_numpy(buf).to(dev))[keep]
        spec[(ch * nn + k) % n] += xn * (amp * m)
    x = torch.fft.ifft(spec)
    del spec
    re, im = x.real.contiguous(), x.imag.contiguous()
    del x
    if sigma:
        re += sigma * torch.randn(n, generator=gen, device=dev)
        im += sigma * torch.randn(n, generator=gen, device=dev)
    return Complex(re, im)


def pager_plan(m: int, n_frames: int, channels=None):
    """W1's pages: [(ch, narrow page, start)] over ``n_frames`` channel
    samples, every fourth page starting 12,000 samples before the middle
    (so it crosses the edge between two blocks of n_frames/2), the others
    spread over the span."""
    channels = PAGER_CHANNELS if channels is None else channels
    span = n_frames - PAGE_SAMPLES - 200
    plan = []
    for idx, ch in enumerate(channels):
        page = page_iq(24_000.0, page_address(ch), page_text(ch))
        start = (n_frames // 2 - 12_000 if idx % 4 == 0
                 else 100 + (idx * 7_919) % span)
        plan.append((ch, page, start))
    return plan


def pager_band(m: int, n_blocks: int, block: int, device, gen=None,
               channels=None, sigma: float = 0.02):
    """W1: ``n_blocks`` consecutive (block,) wideband blocks (Complex on
    ``device``) with a page on each channel of ``channels`` (default
    :data:`PAGER_CHANNELS`), and {ch: (address, text)} of the pages."""
    plan = pager_plan(m, n_blocks * block // m, channels)
    x = upmix(plan, m, n_blocks * block, device, gen=gen, sigma=sigma)
    blocks = [x[b * block:(b + 1) * block] for b in range(n_blocks)]
    return blocks, {ch: (page_address(ch), page_text(ch))
                    for ch, _, _ in plan}


def crosses_edge(plan, block_frames: int) -> list:
    """The channels of a pager plan whose page spans a block edge."""
    return [ch for ch, page, start in plan
            if start // block_frames != (start + len(page) - 1)
            // block_frames]


def narrow_for(mode: str, ch_bw: float, ch: int) -> np.ndarray:
    """Channel ``ch``'s message at the channel rate ``ch_bw``, by mode: a
    POCSAG page "MIXED BAND" to address 1000 + ch; an AX.25 APRS position
    report from K<ch> (three digits; AFSK over FM, 3 kHz deviation); RTTY
    "RY <ch>" (930/1100 Hz, 45.45 baud, 1.5 stop bits); PSK31 "cq <ch>"."""
    tag = f"{ch:03d}"
    if mode == "pocsag":
        return page_iq(ch_bw, MIXED_ADDRESS0 + ch, "MIXED BAND")
    if mode == "ax25":
        frame = ax25_frame_bits("K" + tag, "APRS",
                                b"!4903.50N/07201.75W-multimode",
                                n_flags=50)
        afsk = siggen.fsk_modulate(ch_bw, _nrzi(frame), 1200.0 * 1.0017,
                                   1200.0, 2200.0).real
        return siggen.fm_modulate(ch_bw, 0.8 * afsk, deviation=3000.0)
    if mode == "rtty":
        half_bits = baudot_encode_bits("RY " + tag, stop_bits="1.5")
        return siggen.fsk_modulate(ch_bw, half_bits, 2 * 45.45, 930.0,
                                   1100.0)
    if mode != "psk31":
        raise ValueError(f"unknown mode {mode!r}")
    vbits = np.concatenate([np.ones(24, np.uint8),
                            varicode_encode_bits("cq " + tag),
                            np.ones(24, np.uint8)])
    spb = int(round(ch_bw / 31.25))
    phases = np.cumsum(np.where(vbits == 0, np.pi, 0.0))
    return np.exp(1j * np.repeat(phases, spb)).astype(np.complex64)


def mixed_marks(mode: str, dec) -> set:
    """The channels whose :func:`narrow_for` message one channel's decodes
    (an app's ``found[ch][1]`` in ``mode``) hold."""
    if mode == "pocsag":
        return {x.address - MIXED_ADDRESS0 for x in dec
                if 0 <= x.address - MIXED_ADDRESS0 < 1000}
    if mode == "ax25":
        return {int(f.frm.call[1:]) for f, _ in dec
                if re.fullmatch(r"K\d{3}", f.frm.call)}
    pat = r"RY (\d{3})" if mode == "rtty" else r"cq (\d{3})"
    return {int(v) for v in re.findall(pat, dec)}


def mixed_band(active: dict, m: int, device, ch_bw: float = 24_000.0,
               n: int = None, gen=None, sigma: float = 0.0) -> Complex:
    """W2: the wideband capture (Complex on ``device``) with each channel of
    ``active`` ({ch: mode}) carrying its mode's message
    (:func:`narrow_for`) from the start, silent from its last sample on,
    and ``n`` samples long (default: the longest message + 0.3 s, rounded
    up to whole frames of M)."""
    narrows = {ch: narrow_for(mode, ch_bw, ch)
               for ch, mode in active.items()}
    if n is None:
        n = m * (max(len(s) for s in narrows.values()) + int(0.3 * ch_bw))
    plan = [(ch, s[:len(s) - 1], 0) for ch, s in narrows.items()]
    return upmix(plan, m, n, device, gen=gen, sigma=sigma)
