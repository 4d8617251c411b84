"""The multi-mode decoder bank written out plainly: the reference that
``multimode`` cells are judged against.  It imports nothing of the program
and works every filter out again from the configuration.

Per channel c of M (``reference/pager_scan.channelize``, float64), at the
channel rate fs_c = fs / M, t the frame, the chains of the configuration's
``chains`` on the channels of their mode:

    pocsag  fm[t]   = angle(Y[t] conj(Y[t-1]))  (compared by :func:`fm_gap`)
            sym     = fm <= 0                       (mark below the centre)
    ax25    fm as pocsag; the FSK detector below at (1200, 1200, 2200)
    rtty    usb[t]  = (Re Y[t] + Im Y[t]) / 2; the FSK detector at (90.9,
            930, 1100): two half-bits a 45.45-baud bit
    psk31   bb[j]   = (1/D) sum_{n=jD}^{jD+D-1} sum_i h[i] Y[n - N + 1 + i]
            with h the 64-tap Blackman-windowed sinc low-pass of 100 Hz
            cut-off, unity DC gain, D = floor(fs_c / 2000); then BPSK31

    FSK detector (baud, f_mark, f_space), L = floor(fs_c / baud):
            u_f[n]  = a[n] exp(2 pi i f (n mod L) / fs_c), n the sample's
                      index from the stream's start
            sym[n]  = |sum_{k<L} u_mark[n-k]|^2 > |sum_{k<L} u_space[n-k]|^2

    bit clock (POCSAG and RTTY "normal": the bit is the majority; AX.25
    "transition": the bit is 1 where the majority equals the last bit
    sampled, the NRZI decode): ``reference/pager_scan.bit_clock``'s
    recurrence, each mode at its own baud, window and bounds.

The channelizer and the chains up to the symbols run in float64 on the
device.  The bit clocks and BPSK31's recurrence run on the host in
float32, the precision the configuration states for their state, from the
program's state at the compared period's first block, so that from one
state and one input they make the program's decisions: the bit clocks'
phase, rate and last bit (their symbol history is worked out here from the
capture, as the pager's is), and BPSK31's whole state.

BPSK31 (libsdr's ``src/psk31.cc``, after G3PLX): the carrier removed by a
second-order PLL (damping sqrt(2)/2, bandwidth pi/100, a Costas error
-Re Im / |y|^2, its rate bounded to +-``df``), a fractional resampler to
64 samples a symbol (8-tap interpolation filters at 1/128 of a sample)
steered by a Mueller and Muller timing error (gains 0.01 and 0.001, the
rate within 0.1%), and the differential decision of the sign of each
symbol's summed real part (a reversal is 0), the symbol cut early where
the real part crosses zero past half a symbol.  It departs from the
published description where libsdr does: the summed sign, not a
matched filter, decides.

Each departure of the ITA2 frame from the published one is in
``reference/codes.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import codes, pocsag
from benchmark.reference.pager_scan import channelize, rel_gap  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PLL_GAIN = 0.0005
PLL_RANGE = 0.005
PSK31_BAUD = 31.25
SUPER = 64                   # BPSK31's samples a symbol after resampling
NSTEPS, NTAPS, CENTER = 128, 8, 4
_F32 = np.float32


# ---------------------------------------------------------------------------
# The chains' continuous stages (float64, on the device)
# ---------------------------------------------------------------------------

def fm(y: torch.Tensor) -> torch.Tensor:
    """The discriminator over (C, F) complex frames of a periodic capture
    (the frame before the first is the last)."""
    return torch.angle(y * torch.roll(y, 1, dims=-1).conj())


def usb(y: torch.Tensor) -> torch.Tensor:
    return (y.real + y.imag) * 0.5


def fm_gap(got: torch.Tensor, y: torch.Tensor) -> float:
    """The discriminator's gap over (C, F) ``got`` against the angles of
    ``y`` (C, F + 1), the frame before the first included, each sample's
    angle gap (modulo 2 pi) weighed by the magnitude of the product it is
    the angle of, |Y[t] Y[t-1]|, over the largest: an angle is
    ill-conditioned where the channel falls silent (its gap there grows as
    1 / |Y|), the product is not."""
    prod = y[:, 1:] * y[:, :-1].conj()
    d = torch.remainder(got.double() - torch.angle(prod) + math.pi,
                        2 * math.pi) - math.pi
    return float((d.abs() * prod.abs()).max() / prod.abs().max())


def fsk_symbols(a: torch.Tensor, fs: float, chain: dict, n0: int,
                before: int) -> np.ndarray:
    """The FSK detector's symbols (C, before + F) bool on the host over
    (C, F) real samples ``a`` of a periodic capture whose first sample has
    index ``n0`` (mod L) from the stream's start, and over the ``before``
    samples ahead of it (the capture's last ones, their indices before
    ``n0``)."""
    ell = int(fs / chain["baud"])
    ext = torch.cat([a[:, a.shape[1] - (before + ell - 1):], a], dim=-1)
    idx = torch.remainder(torch.arange(ext.shape[1], device=a.device)
                          + (n0 - before - (ell - 1)), ell)
    power = []
    for f in (chain["f_mark"], chain["f_space"]):
        u = ext * torch.exp(2j * math.pi * f * idx.double() / fs)
        cz = torch.nn.functional.pad(torch.cumsum(u, dim=-1), (1, 0))
        s = cz[:, ell:] - cz[:, :-ell]
        power.append(s.real ** 2 + s.imag ** 2)
    return (power[0] > power[1]).cpu().numpy()


def lowpass(n: int, fc: float, fs: float) -> np.ndarray:
    """The n-tap Blackman-windowed sinc low-pass of cut-off fc, unity DC
    gain."""
    i = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(2 * fc / fs * i) * np.blackman(n)
    return h / h.sum()


def psk31_baseband(y: torch.Tensor, fs: float, chain: dict) -> torch.Tensor:
    """The PSK31 select over (C, F) complex frames of a periodic capture:
    (C, F / D) complex128 (the low-pass as a circular convolution over the
    period, by FFT)."""
    d = int(fs / chain["out_rate"])
    h = lowpass(chain["order"], chain["width"] / 2, fs)
    g = np.zeros(y.shape[-1])
    g[:len(h)] = h[::-1]             # filt[n] = sum_k h[N-1-k] y[n-k]
    gf = torch.fft.fft(torch.as_tensor(g, device=y.device))
    filt = torch.fft.ifft(torch.fft.fft(y, dim=-1) * gf, dim=-1)
    return filt.reshape(y.shape[0], -1, d).mean(-1)


# ---------------------------------------------------------------------------
# The bit clocks and BPSK31 (float32, on the host)
# ---------------------------------------------------------------------------

def window(baud: float, fs: float, frames: int, cap: int = 256) -> int:
    """The widest power-of-two window up to ``cap`` steps that holds at most
    one bit (the clock's fastest rate puts bits floor(1 / omega_max) steps
    apart) and divides ``frames``; 0 where no window of 2 does."""
    gap = int(1.0 / (baud / fs * (1 + PLL_RANGE)))
    w = 1
    while w * 2 <= min(gap, cap) and frames % (w * 2) == 0:
        w *= 2
    return w if w > 1 else 0


def bit_clock(sym: np.ndarray, ells, om0, transition, start):
    """The bit clock over ``sym`` (T + L, C) bool, whose first L rows
    (L the widest lane's window) are the symbols before the first step, in
    float32, each lane c with its window ``ells[c]``, nominal rate
    ``om0[c]`` and mapping ``transition[c]``, from ``start`` = (phase,
    omega, last bit) (C,).  Returns (bits (T, C) uint8, emitted (T, C)
    bool)."""
    big = max(ells)
    t, c = sym.shape[0] - big, sym.shape[1]
    pm = np.where(sym, 1, -1).astype(np.int64)
    cz = np.concatenate([np.zeros((1, c), np.int64), np.cumsum(pm, 0)])
    rows = np.arange(big, big + t + 1)[:, None]          # sums ending there
    ells = np.asarray(ells)
    s = cz[rows, np.arange(c)] - cz[rows - ells, np.arange(c)]
    bn = s[1:] > 0
    crossed = (s[:-1] < 0) != (s[1:] < 0)
    del cz, s
    om0 = np.asarray(om0, np.float64)
    lo = (om0 * (1 - PLL_RANGE)).astype(np.float32)
    hi = (om0 * (1 + PLL_RANGE)).astype(np.float32)
    one, half = _F32(1.0), _F32(0.5)
    gain = float(_F32(PLL_GAIN))            # the state's precision
    ph, om, last = (np.asarray(start[0], np.float32),
                    np.asarray(start[1], np.float32),
                    np.asarray(start[2]).astype(np.int64) & 1)
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
    raw = bn.astype(np.int64)
    # the last bit sampled before each step: the carried one, then each
    # emitted majority in turn
    k_idx = np.where(emit, np.arange(t)[:, None], -1)
    prev_k = np.maximum.accumulate(
        np.concatenate([np.full((1, c), -1), k_idx[:-1]]), axis=0)
    prev = np.where(prev_k >= 0, raw[np.maximum(prev_k, 0), np.arange(c)],
                    last[None, :])
    trans = np.asarray(transition, bool)[None, :]
    bits = np.where(trans, (raw == prev).astype(np.int64), raw)
    return bits.astype(np.uint8), emit


def packed_windows(bits: np.ndarray, emit: np.ndarray, w: int) -> np.ndarray:
    """(C, T / w) uint8: each window's bit where one was sampled, and 2
    where one was."""
    t, c = bits.shape
    bw = (bits.astype(bool) & emit).reshape(t // w, w, c).any(1)
    ew = emit.reshape(t // w, w, c).any(1)
    return np.ascontiguousarray((bw.astype(np.uint8)
                                 | ew.astype(np.uint8) << 1).T)


def interpolation_bank() -> np.ndarray:
    """(NSTEPS + 1, NTAPS) float32: row r the 8-tap filter that evaluates a
    window at position CENTER - r / NSTEPS, a sinc under a Blackman window
    centred there, unity DC gain."""
    bank = np.zeros((NSTEPS + 1, NTAPS))
    i = np.arange(NTAPS)
    for r in range(NSTEPS + 1):
        t = i - (CENTER - r / NSTEPS)
        w = np.clip(0.42 + 0.5 * np.cos(np.pi * t / CENTER)
                    + 0.08 * np.cos(2 * np.pi * t / CENTER), 0.0, None)
        h = np.sinc(t) * w
        bank[r] = h / h.sum()
    return bank.astype(np.float32)


def bpsk31_constants(fs: float, chain: dict) -> dict:
    """The loops' constants at BPSK31's input rate ``fs`` (float32)."""
    damping, bw = math.sqrt(2) / 2, math.pi / 100
    tmp = 1.0 + 2 * damping * bw + bw * bw
    om0 = fs / (SUPER * PSK31_BAUD)
    rel = chain["omega_rel"]
    return {k: _F32(v) for k, v in dict(
        alpha=4 * damping * bw / tmp, beta=4 * bw * bw / tmp,
        fmin=-chain["df"], fmax=chain["df"], omin=om0 * (1 - rel),
        omax=om0 * (1 + rel), gmu=chain["gain_mu"],
        gom=chain["gain_omega"]).items()}


def bpsk31(x: np.ndarray, state: dict, k: dict):
    """BPSK31 over (C, T) complex64 ``x`` from ``state`` (the recurrence's
    state at the first step, float32 (C,) arrays, the delay line (C, 8)
    complex64 with its write index ``dl_idx``); returns (bits, emitted)
    (C, T)."""
    bank = interpolation_bank()
    c, t = x.shape
    xr, xi = x.real.astype(_F32), x.imag.astype(_F32)
    st = {key: np.array(v, copy=True) for key, v in state.items()}
    two_pi, one, zero = _F32(2 * math.pi), _F32(1.0), _F32(0.0)
    P, F, mu_s, om_s = st["P"], st["F"], st["mu"], st["omega"]
    dlr, dli = st["dl"].real.astype(_F32), st["dl"].imag.astype(_F32)
    at = int(st["dl_idx"])
    p0r, p1r = st["p0"].real.astype(_F32), st["p1"].real.astype(_F32)
    c0s, c1s = st["c0"], st["c1"]
    hsum, hprev, hidx, last = (st["hist_sum"], st["hist_prev"],
                               st["hist_idx"], st["last_const"])
    bits = np.empty((c, t), np.uint8)
    emits = np.empty((c, t), bool)

    def wrap(p):
        p = np.where(p > two_pi, p - two_pi, p)
        return np.where(p < -two_pi, p + two_pi, p)

    for n in range(t):
        mu = mu_s - one
        pn = wrap(P + F)
        # the carrier removed: the phasor's float64 cos and sin in float32
        fr = np.cos(pn.astype(np.float64)).astype(_F32)
        fi = np.sin(pn.astype(np.float64)).astype(_F32)
        dlr[:, at] = fr * xr[:, n] - fi * xi[:, n]
        dli[:, at] = fr * xi[:, n] + fi * xr[:, n]
        at = (at + 1) % 8
        make = mu <= one
        row = np.clip(np.round(mu * _F32(NSTEPS)), 0, NSTEPS).astype(
            np.int64)
        taps = np.roll(bank[row], at, axis=-1)      # oldest sample first
        yr = dlr[:, 0] * taps[:, 0]
        yi = dli[:, 0] * taps[:, 0]
        for j in range(1, 8):
            yr = yr + dlr[:, j] * taps[:, j]
            yi = yi + dli[:, j] * taps[:, j]
        # Mueller and Muller: (c[0] - c[-2]) p[-1] against (y - p[-2]) c[-1]
        cn = np.where(yr > 0, _F32(-1.0), one)
        err = np.clip((yr - p1r) * c0s - (cn - c1s) * p0r, -one, one)
        om = np.clip(om_s + k["gom"] * err, k["omin"], k["omax"])
        mu_new = mu + om + k["gmu"] * err
        # the Costas error and the loop
        nrm2 = yr * yr + yi * yi
        z = nrm2 == 0
        phi = np.where(z, zero, -yr * yi / np.where(z, one, nrm2))
        fn = np.clip(F + k["beta"] * phi, k["fmin"], k["fmax"])
        p2 = wrap(pn + fn + k["alpha"] * phi)
        # the symbol's sum, its early cut and the differential decision
        hs = hsum + yr
        cross = ((hprev >= 0) & (yr <= 0)) | ((hprev <= 0) & (yr >= 0))
        early = (hidx > 1) & cross
        drop = early & (hidx < SUPER // 2)
        cut = (early & ~drop) | (hidx == SUPER - 1)
        const = np.where(hs > 0, 1, -1).astype(np.int32)
        bits[:, n] = last == const
        e = cut & make
        emits[:, n] = e
        last = np.where(e, const, last)
        reset = (drop | cut) & make
        hidx = np.where(make, np.where(reset, 0, hidx + 1),
                        hidx).astype(np.int32)
        hsum = np.where(make, np.where(reset, zero, hs), hsum)
        hprev = np.where(make, yr, hprev)
        p1r = np.where(make, p0r, p1r)
        p0r = np.where(make, yr, p0r)
        c1s = np.where(make, c0s, c1s)
        c0s = np.where(make, cn, c0s)
        P = np.where(make, p2, pn)
        F = np.where(make, fn, F)
        mu_s = np.where(make, mu_new, mu)
        om_s = np.where(make, om, om_s)
    return bits, emits


# ---------------------------------------------------------------------------
# The messages
# ---------------------------------------------------------------------------

def decoded(mode: str, bits: np.ndarray):
    """What one channel's bits carry: POCSAG pages (address, function,
    payload bits), AX.25 frames whose FCS checks, or text."""
    if mode == "pocsag":
        return pocsag.decode(bits)
    if mode == "ax25":
        return codes.deframe(bits)
    if mode == "rtty":
        return codes.ita2_decode(bits)
    if mode == "psk31":
        return codes.varicode_decode(bits)
    raise ValueError(f"unknown mode {mode!r}")


def missed(plan, got: dict) -> float:
    """The largest share, over the modes, of a mode's planned messages that
    ``got`` (a channel's decode in :func:`decoded`'s form: a page or frame
    is found in the list, a text in the string) does not hold; 0 without a
    plan."""
    tally = {}
    for m in plan:
        n, k = tally.get(m.mode, (0, 0))
        tally[m.mode] = (n + 1, k + (m.content not in got[m.ch]))
    return max((k / n for n, k in tally.values()), default=0.0)
