"""The FM broadcast receive chain written out plainly in float64: the
reference that ``fm_bank`` cells are judged against.  It imports nothing of
the program and works the taps out again from the configuration.

The chain (libsdr's ``IQBaseBand(fc, width, order, decim) -> FMDemod ->
FMDeemph``), per channel, input x at rate fs:

    filt[n]  = sum_i k[i] x[n - N + 1 + i]       k: complex band-pass at fc
    base[j]  = mean_d filt[jD + d] e^(-i w (jD + d))        w = 2 pi fc / fs
    fm[j]    = gain * angle(base[j] conj(base[j - 1]))
    audio[j] = a audio[j - 1] + b fm[j]          a = 1 - 1/alpha, b = 1/alpha

with k the Blackman-windowed sinc low-pass of cut-off width/2 (unity DC
gain) times e^(-2 pi i fc i / fs), and alpha = round(1 / (1 - e^(-1 /
(fs/D tau)))).  The band-pass and the decimator's mean fold into one
decimating filter of N + D - 1 taps:

    base[j] = e^(-i w jD) sum_m g[m] x[jD - N + 1 + m],
    g[m] = (1/D) sum_d e^(-i w d) k[m - d].
"""

from __future__ import annotations

import math

import numpy as np
import torch


def bandpass_taps(chain: dict, fs: float) -> np.ndarray:
    """k: the textbook complex band-pass of the chain (float64)."""
    if chain.get("design", "textbook") != "textbook":
        raise ValueError("the reference writes out the textbook design only")
    n = int(chain["order"])
    i = np.arange(n)
    cut = chain["width"] / fs            # (2 pi (width/2) / fs) / pi
    lp = np.sinc(cut * (i - (n - 1) / 2.0)) * cut * np.blackman(n)
    lp /= lp.sum()
    return lp * np.exp(-2j * np.pi * chain["fc"] * i / fs)


def decimating_taps(chain: dict, fs: float) -> np.ndarray:
    """g: the band-pass and the decimator's mean as one filter."""
    k = bandpass_taps(chain, fs)
    d = int(chain["decim"])
    w = 2 * np.pi * chain["fc"] / fs
    g = np.zeros(len(k) + d - 1, np.complex128)
    for dd in range(d):
        g[dd:dd + len(k)] += np.exp(-1j * w * dd) * k / d
    return g


def deemph_ab(chain: dict, fs: float):
    rate = fs / chain["decim"]
    alpha = max(1, round(1.0 / (1.0 - math.exp(-1.0 / (rate * chain["tau"])))))
    return 1.0 - 1.0 / alpha, 1.0 / alpha


def iir(x: torch.Tensor, a: float, b: float, chunk: int = 512):
    """y[n] = a y[n-1] + b x[n] from y[-1] = 0 along the last axis, exactly
    in float64: within chunks of ``chunk`` by one matrix product, then each
    chunk's start state from the previous chunks' ends.  ``a**(3 chunk)`` is
    taken as 0 (a chunk of 512 at a <= 0.95 leaves 1e-34 of a state)."""
    c, n = x.shape
    if n % chunk:
        raise ValueError("length must be whole chunks")
    if a ** (3 * chunk) > 1e-30:
        raise ValueError("pole too slow for the chunked form")
    i = torch.arange(chunk, dtype=torch.float64, device=x.device)
    lag = i[:, None] - i[None, :]
    mat = torch.where(lag >= 0, b * a ** lag.clamp(min=0), 0.0)
    y = (x.reshape(c, n // chunk, chunk) @ mat.T)
    ends = y[..., -1]
    al = a ** chunk
    state = ends.clone()                          # state at each chunk's end
    state[:, 1:] += al * ends[:, :-1]
    state[:, 2:] += al * al * ends[:, :-2]
    prev = torch.zeros_like(state)
    prev[:, 1:] = state[:, :-1]
    y += prev[..., None] * (a ** (i + 1))
    return y.reshape(c, n)


def audio(config: dict, x: torch.Tensor, j0: int) -> torch.Tensor:
    """The chain's audio over the complex128 input ``x`` (C, L), outputs j0
    .. L/D - 1 (j0 D >= N - 1, so each reads only x), from a zero
    de-emphasis state at j0 + 1 (the first output has no predecessor and
    is left out): (C, L/D - j0 - 1) float64."""
    chain = config["chain"]
    fs = float(config["sample_rate"])
    d = int(chain["decim"])
    g = torch.as_tensor(decimating_taps(chain, fs), device=x.device)
    t = len(g)
    n_out = x.shape[-1] // d - j0
    base = torch.zeros((x.shape[0], n_out), dtype=torch.complex128,
                       device=x.device)
    start = j0 * d - int(chain["order"]) + 1
    if start < 0:
        raise ValueError("j0 too small for the filter's history")
    for m in range(t):
        s = start + m
        base += g[m] * x[:, s:s + d * n_out:d]
    rot = np.exp(-1j * 2 * np.pi * chain["fc"] / fs * d)
    fm = torch.angle(base[:, 1:] * base[:, :-1].conj() * rot)
    del base
    fm *= float(chain.get("gain", 1.0))
    a, b = deemph_ab(chain, fs)
    pad = -fm.shape[-1] % 512      # zeros ahead of a zero state stay zero
    return iir(torch.nn.functional.pad(fm, (pad, 0)), a, b)[:, pad:]


def compare(config: dict, blocks, order, outputs, lead: int = 4096,
            channels_at_once: int = 8):
    """(the largest gap between the program's audio and the reference's,
    as a share of the reference's largest |audio|; the root mean square
    gap as a share of the reference's root mean square) over the last
    len(outputs) blocks of the stream.

    ``blocks``: the distinct input blocks, (re, im) float32 (C, B);
    ``order``: the block indices fed last, oldest first, one more than
    ``outputs`` (the block before the first compared one gives the filter
    its history and the de-emphasis its run-in); ``outputs``: the
    program's (C, B/D) audio of the compared blocks, in order.  The
    de-emphasis runs in over the ``lead`` samples of the first block (its
    state then holds a**1000 ~ 1e-24 of where it started).
    """
    d = int(config["chain"]["decim"])
    c = blocks[0][0].shape[0]
    worst, peak, sq_gap, sq_ref, count = 0.0, 0.0, 0.0, 0.0, 0
    for c0 in range(0, c, channels_at_once):
        sl = slice(c0, min(c, c0 + channels_at_once))

        def seg(i, s):
            re, im = blocks[i]
            re, im = re[sl, s], im[sl, s]
            return torch.complex(re.double(), im.double())
        x = torch.cat([seg(order[0], slice(-lead, None))]
                      + [seg(i, slice(None)) for i in order[1:]], dim=-1)
        ref = audio(config, x, j0=-(-(int(config["chain"]["order"]) - 1)
                                    // d))
        del x
        n_cmp = sum(o.shape[-1] for o in outputs)
        ref = ref[:, -n_cmp:]
        got = torch.cat([o[sl].double() for o in outputs], dim=-1)
        gap = got - ref
        worst = max(worst, float(gap.abs().max()))
        peak = max(peak, float(ref.abs().max()))
        sq_gap += float((gap * gap).sum())
        sq_ref += float((ref * ref).sum())
        del ref, got, gap
    return worst / peak, (sq_gap / sq_ref) ** 0.5
