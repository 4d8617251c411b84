"""The whole-band pager scanner written out plainly: the reference that
``pager_scan`` cells are judged against.  It imports nothing of the program
and works the prototype filter out again from the configuration.

Per channel c of M, input x at rate fs (frames of M samples, t the frame):

    Y[t, c]   = sum_n h[n] x[tM - n] e^(2 pi i c n / M)   (n < M P)
    fm[t, c]  = angle(Y[t, c] conj(Y[t-1, c]))
    sym       = fm <= 0                          (mark = negative deviation)
    s[t]      = the sum of the last L symbols as +-1, L = fs/M / baud
    bit clock : phase += omega; on phase >= 1 a bit (s > 0) and phase -= 1;
                where sign(s) flips, omega += gain (1/2 - phase), clipped to
                omega0 (1 +- 0.5%)

with h the Blackman-windowed sinc low-pass of length M P, cut-off fs/(2M),
unity DC gain.  The channelizer and the discriminator run in float64 on
the device; the bit clock runs on the host in float32, the precision the
configuration states for its state, so that from one state and one
symbol stream it samples the bits the program's clock samples.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import pocsag


def prototype(m: int, p: int) -> np.ndarray:
    n = m * p
    i = np.arange(n)
    h = np.sinc((i - (n - 1) / 2.0) / m) / m * np.blackman(n)
    return h / h.sum()


def channelize(x: torch.Tensor, hist: torch.Tensor, m: int, p: int):
    """Y (F, M) complex128 over the frames of ``x`` (F M,) complex128, with
    ``hist`` the P M samples before it."""
    h = torch.as_tensor(prototype(m, p), device=x.device).reshape(p, m)
    ext = torch.cat([hist, x]).reshape(-1, m)          # (P + F, M) frames
    f = ext.shape[0] - p
    # r[f, q] = x[fM - q]: lane 0 of frame f, lane M - q of frame f - 1
    r = torch.empty_like(ext)
    r[:, 0] = ext[:, 0]
    r[1:, 1:] = ext[:-1, 1:].flip(-1)
    r[0, 1:] = 0
    u = torch.zeros((f, m), dtype=torch.complex128, device=x.device)
    for k in range(p):                     # x[(t - k) M - q] h[k M + q]
        u += h[k] * r[p - k:p - k + f]
    return torch.fft.ifft(u, dim=-1) * m


def window(baud: float, fs_ch: float, frames: int, cap: int = 64) -> int:
    """The widest power-of-two window of clock steps that holds at most one
    bit: the clock's fastest rate, omega0 (1 + 0.5%), puts bits at least
    floor(1 / omega_max) steps apart; it divides ``frames``."""
    gap = int(1.0 / (baud / fs_ch * 1.005))
    w = 1
    while w * 2 <= min(gap, cap) and frames % (w * 2) == 0:
        w *= 2
    return w


def bit_clock(sym: np.ndarray, baud: float, fs_ch: float, start=None,
              w: int = 1):
    """The bit clock over ``sym`` (T, C) bool in float32, the precision the
    configuration states, from ``start`` (signs (C, L-1) of the last
    symbols as +-1, oldest first; the last window sum (C,); phase (C,);
    omega (C,)) or a fresh state.  Returns (packed (C, T/w) uint8: the bit
    of each window of w steps and 2 where one was sampled; a list of the
    C channels' bit arrays; the clock's (phase, omega) after the last
    step)."""
    t, c = sym.shape
    ell = int(fs_ch / baud)
    om0 = np.float32(baud / fs_ch)
    if start is None:
        start = (np.zeros((c, ell - 1), np.int64), np.zeros(c, np.int64),
                 np.zeros(c, np.float32), np.full(c, om0))
    signs, sym_sum, ph, om = (np.asarray(v) for v in start)
    full = np.concatenate([signs.T.astype(np.int64),
                           np.where(sym, 1, -1).astype(np.int64)])
    cz = np.concatenate([np.zeros((1, c), np.int64), np.cumsum(full, 0)])
    s = cz[ell:] - cz[:-ell]                       # (T, C) window sums
    del full, cz
    bn = s > 0
    last = np.concatenate([sym_sum.astype(np.int64)[None], s[:-1]])
    crossed = (last < 0) != (s < 0)
    del s, last
    lo = np.float32(float(om0) * (1 - 0.005))
    hi = np.float32(float(om0) * (1 + 0.005))
    one, half, gain = np.float32(1.0), np.float32(0.5), 0.0005
    ph, om = ph.astype(np.float32), om.astype(np.float32)
    emit = np.empty((t, c), bool)
    for k in range(t):
        ph = ph + om
        e = ph >= one
        ph = np.where(e, ph - one, ph)
        emit[k] = e
        cr = crossed[k]
        if cr.any():
            # the nudge in float64, rounded once (as a fused multiply-add)
            nudged = (om.astype(np.float64) + gain * (half - ph)).astype(
                np.float32)
            om = np.minimum(np.maximum(np.where(cr, nudged, om), lo), hi)
    bits = [bn[emit[:, j], j].astype(np.uint8) for j in range(c)]
    ew = emit.reshape(t // w, w, c)
    data = (bn.reshape(t // w, w, c) & ew).any(1)
    packed = (data.astype(np.uint8) | (ew.any(1).astype(np.uint8) << 1)).T
    return np.ascontiguousarray(packed), bits, (ph, om)


def history(sym: np.ndarray, ell: int) -> tuple:
    """(signs, window sum) of the clock's start after the last ``ell``
    symbols of ``sym`` (T, C): the capture repeats, so the symbols before
    a period's first frame are its last ones."""
    hist = np.where(sym[-ell:], 1, -1).astype(np.int64)
    return np.ascontiguousarray(hist[1:].T), hist.sum(0)


def symbols(config: dict, blocks):
    """Over one whole period of the capture (``blocks``, (re, im) float32
    (B,), fed in turn and repeated): the channelizer's output Y (F, M)
    complex128 on the device, and the ASK detector's symbols (F, M) bool
    on the host (channel order)."""
    m = int(config["channels"])
    p = int(config["taps_per_branch"])

    def cx(i, s=slice(None)):
        re, im = blocks[i]
        return torch.complex(re[s].double(), im[s].double())
    x = torch.cat([cx(i) for i in range(len(blocks))])
    y = channelize(x, cx(len(blocks) - 1, slice(-p * m, None)), m, p)
    del x
    # the capture repeats: the frame before the first is the last
    prev = torch.cat([y[-1:], y[:-1]])
    sym = (torch.angle(y * prev.conj()) <= 0).cpu().numpy()
    return y, sym


def own_clock(config: dict, sym: np.ndarray) -> tuple:
    """The clock's own (phase, omega) at a period's first frame: run over
    the period before (the capture repeats) from phase 0 and the nominal
    rate, with the capture's symbol history."""
    baud = float(config["baud"])
    fs_ch = float(config["sample_rate"]) / int(config["channels"])
    c = sym.shape[1]
    fresh = (np.zeros(c, np.float32), np.full(c, np.float32(baud / fs_ch)))
    start = history(sym, int(fs_ch / baud)) + fresh
    return bit_clock(sym, baud, fs_ch, start)[2]


def scan(config: dict, sym: np.ndarray, blocks: int, clock=None):
    """The bit clock's packed windows and bits over ``sym`` (F, C), a
    period of ``blocks`` blocks, from the period's first frame with the
    symbol history the capture gives (its last symbols) and ``clock`` =
    (phase, omega) (C,), or with None from a fresh state with no history
    (a program's first block)."""
    baud = float(config["baud"])
    fs_ch = float(config["sample_rate"]) / int(config["channels"])
    w = window(baud, fs_ch, sym.shape[0] // blocks)
    start = None
    if clock is not None:
        start = history(sym, int(fs_ch / baud)) + tuple(clock)
    packed, bits, _ = bit_clock(sym, baud, fs_ch, start, w)
    return packed, bits


def pages(bits_by_channel: dict) -> set:
    """{(channel, address, function, payload bits)} decoded."""
    return {(ch,) + pg for ch, bits in bits_by_channel.items()
            for pg in pocsag.decode(bits)}


def planned_pages(plan) -> set:
    """The pages of a plan as :func:`pages` gives them."""
    return pages({ch: bits for ch, bits, _ in plan})


def pages_gap(got: set, ref: set, plan) -> int:
    """The planned pages that one side decodes and the other does not.
    What noise decodes (a false sync in a noise channel, after which a
    random word passes the BCH check one time in four) is no planned page
    and differs from run to run: it is left out."""
    return len((got ^ ref) & planned_pages(plan))


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|."""
    return float((got - ref).abs().max() / ref.abs().max())

