"""``fm_tones``: one FM broadcast carrier a channel, near the
configuration's tuning frequency, modulated by one tone, plus complex
Gaussian noise.  The seed draws each channel's carrier offset, deviation,
tone and phases and the noise: the shape of the work is the same for every
seed.  Blocks of (C, B) float32 planes, consecutive in time."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.signals import generator

CHUNK = 1 << 20     # samples a channel made at once (bounds the float64 temps)


def make(config: dict, traffic: dict, seed: int, device):
    """``traffic["distinct_blocks"]`` consecutive blocks of
    ``traffic["block_samples"]`` samples a channel; returns (blocks, None)."""
    c = int(config["channels"])
    fs = float(config["sample_rate"])
    b = int(traffic["block_samples"])
    n = int(traffic["distinct_blocks"])
    p = traffic["tones"]
    rng = np.random.default_rng(seed)
    fc = config["chain"]["fc"] + rng.uniform(-1, 1, c) * p["offset_hz"]
    dev = rng.uniform(*p["deviation_hz"], c)
    tone = rng.uniform(*p["tone_hz"], c)
    ph0, ph1 = rng.uniform(0, 2 * math.pi, (2, c))

    def col(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device)[:, None]

    f_c, f_m, beta = col(fc / fs), col(tone / fs), col(dev / tone)
    ph0, ph1 = col(ph0), col(ph1)
    gen = generator(seed, device)
    blocks = []
    for k in range(n):
        re = torch.empty((c, b), dtype=torch.float32, device=device)
        im = torch.empty_like(re)
        for s in range(0, b, CHUNK):
            w = min(CHUNK, b - s)
            t = torch.arange(k * b + s, k * b + s + w, dtype=torch.float64,
                             device=device)[None, :]
            cyc = torch.remainder(f_c * t, 1.0)
            ph = (2 * math.pi) * cyc + beta * torch.sin(
                (2 * math.pi) * torch.remainder(f_m * t, 1.0) + ph1) + ph0
            re[:, s:s + w] = torch.cos(ph)
            im[:, s:s + w] = torch.sin(ph)
            del t, cyc, ph
        re += p["noise"] * torch.randn(re.shape, generator=gen,
                                       device=device)
        im += p["noise"] * torch.randn(im.shape, generator=gen,
                                       device=device)
        blocks.append((re, im))
    return blocks, None
