"""``pocsag_pages``: a whole band of pager channels: one POCSAG page on
each channel of the traffic's plan, band-limited to its channel and mixed
to its centre by one inverse FFT over the whole capture, plus noise.  The
seed draws which page starts where (the same set of starts in another
order) and the noise.  The capture is periodic in its length, so blocks
replayed in turn run on without a seam.  Blocks of (B,) float32 planes of
one wideband stream."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import pocsag
from benchmark.signals import generator


def page_channels(m: int, traffic: dict) -> list:
    """The channels that carry a page: every ``page_every``-th, and with
    ``edge_pages`` three beside the band's edges (M/2 - 4, M/2 + 4: both
    sides of +-fs/2; M - 4: the wrap to channel 0)."""
    chans = set(range(0, m, int(traffic["page_every"])))
    if traffic.get("edge_pages"):
        chans |= {m // 2 - 4, m // 2 + 4, m - 4}
    return sorted(chans)


def page_iq(bits: np.ndarray, fs: float, baud: float, dev_hz: float):
    """FSK of ``bits`` at ``baud``: mark (1) at -dev_hz, space at +dev_hz."""
    spb = fs / baud
    n = int(len(bits) * spb)
    idx = np.minimum((np.arange(n) / spb).astype(np.int64), len(bits) - 1)
    f = np.where(bits[idx] > 0, -dev_hz, dev_hz)
    return np.exp(1j * 2 * np.pi * np.cumsum(f) / fs).astype(np.complex64)


def page_plan(config: dict, traffic: dict, seed: int) -> list:
    """[(channel, page bits, start in channel samples)]: every fourth page
    starts 12,000 channel samples before the capture's middle, across the
    edge between its two halves; the others are spread over the span."""
    m = int(config["channels"])
    fs_ch = float(config["sample_rate"]) / m
    frames = int(traffic["block_samples"]) * int(traffic["distinct_blocks"]) \
        // m
    pages = []
    for ch in page_channels(m, traffic):
        bits = pocsag.encode_page(traffic["address0"] + ch, 1,
                                  traffic["text"].format(ch=ch))
        pages.append((ch, bits))
    longest = max(int(len(bits) * fs_ch / config["baud"])
                  for _, bits in pages)
    span = frames - longest - 200
    if span <= 0 or frames // 2 < 12_000:
        raise ValueError("the capture is too short for its pages")
    starts = [frames // 2 - 12_000 if i % 4 == 0 else 100 + (i * 7_919) % span
              for i in range(len(pages))]
    order = np.random.default_rng(seed).permutation(len(pages))
    return [(ch, bits, starts[j]) for (ch, bits), j in zip(pages, order)]


def make(config: dict, traffic: dict, seed: int, device):
    """The capture cut into ``distinct_blocks`` wideband blocks; returns
    (blocks, plan) with the plan of :func:`page_plan`."""
    m = int(config["channels"])
    fs = float(config["sample_rate"])
    b = int(traffic["block_samples"])
    n = b * int(traffic["distinct_blocks"])
    if n % m or b % m:
        raise ValueError("blocks must hold whole frames of M samples")
    plan = page_plan(config, traffic, seed)
    nn = n // m
    k = torch.arange(nn, device=device)
    k = torch.where(k < (nn + 1) // 2, k, k - nn)
    keep = k != -(nn // 2) if nn % 2 == 0 else torch.ones_like(k, dtype=bool)
    k = k[keep]
    spec = torch.zeros(n, dtype=torch.complex64, device=device)
    for ch, bits, start in plan:
        iq = page_iq(bits, fs / m, config["baud"], traffic["deviation_hz"])
        buf = np.zeros(nn, np.complex64)
        buf[start:start + len(iq)] = iq[:nn - start]
        xn = torch.fft.fft(torch.from_numpy(buf).to(device))[keep]
        spec[(ch * nn + k) % n] += xn * (traffic["amplitude"] * m)
    x = torch.fft.ifft(spec)
    del spec
    re, im = x.real.contiguous(), x.imag.contiguous()
    del x
    gen = generator(seed, device)
    re += traffic["noise"] * torch.randn(n, generator=gen, device=device)
    im += traffic["noise"] * torch.randn(n, generator=gen, device=device)
    blocks = [(re[i * b:(i + 1) * b], im[i * b:(i + 1) * b])
              for i in range(n // b)]
    return blocks, plan
