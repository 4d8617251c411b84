"""FIR kernel design — windowed-sinc designers (a numpy copy of
``libsdr_tpu.ops.firdesign``: importing that module would load JAX).

Two families:

* ``ref_*`` — reproduce the reference's designer *math* exactly (including its
  quirks, e.g. the ``4*w/pi`` center tap and sum-of-abs normalization) so that
  parity fixtures match: ``ref_lowpass`` mirrors FIRLowPassCoeffs
  (reference: src/firfilter.hh:16-32) and ``ref_complex_bandpass`` mirrors
  IQBaseBand::_update_filter_kernel (reference: src/baseband.hh:239-262).
* textbook designers (``lowpass``/``highpass``/``bandpass``/``bandstop``) —
  clean Blackman-windowed sinc with unity passband gain; these are the
  recommended API (the reference's own high/band-pass designers contain
  obvious typos, src/firfilter.hh:42-110, and are not used by any example).

All designers run in numpy float64 at pipeline-build time.

Tap-order convention (matches the reference ring-buffer evaluation,
src/firfilter.hh:231-248): ``y[n] = sum_i k[i] * x[n - (N-1) + i]`` — i.e.
``k[N-1]`` multiplies the newest sample.
"""

from __future__ import annotations

import numpy as np


def blackman(n: int, denom: int | None = None) -> np.ndarray:
    """Blackman window as used by the reference: ``0.42 - 0.5 cos(2 pi i/N)
    + 0.08 cos(4 pi i/N)`` (reference: src/firfilter.hh:26)."""
    denom = n if denom is None else denom
    i = np.arange(n)
    return 0.42 - 0.5 * np.cos(2 * np.pi * i / denom) + 0.08 * np.cos(4 * np.pi * i / denom)


# ---------------------------------------------------------------------------
# Reference-compatible designers (same math, for parity fixtures)
# ---------------------------------------------------------------------------

def ref_lowpass(order: int, fc: float, fs: float) -> np.ndarray:
    """Low-pass taps with the reference's exact formula
    (reference: src/firfilter.hh:16-32): sinc(w (i-M)) with w = 2 pi fc/fs,
    M = N/2, center tap 4 w/pi, Blackman window, normalized by sum(|k|)."""
    n = int(order)
    w = 2 * np.pi * fc / fs
    m = n / 2.0
    i = np.arange(n)
    with np.errstate(invalid="ignore", divide="ignore"):
        k = np.sin(w * (i - m)) / (w * (i - m))
    center = (2 * i == n)
    k[center] = 4 * w / np.pi
    k *= blackman(n)
    return k / np.abs(k).sum()


def ref_complex_bandpass(order: int, ff: float, width: float, fs: float) -> np.ndarray:
    """Complex band-pass taps with IQBaseBand's exact designer math
    (reference: src/baseband.hh:239-262): low-pass prototype of width/2
    cut-off (w = pi*width/fs), modulated by ``exp(-2j pi ff i / fs)``,
    Blackman windowed, normalized by sum(|k|).  Note the reference's center
    tap is ``4 w/pi`` (same quirk as ref_lowpass)."""
    n = int(order)
    w = np.pi * width / fs
    m = n / 2.0
    i = np.arange(n)
    with np.errstate(invalid="ignore", divide="ignore"):
        proto = np.sin(w * (i - m)) / (w * (i - m))
    proto[2 * i == n] = 4 * w / np.pi
    k = proto.astype(np.complex128)
    k *= np.exp(-2j * np.pi * ff * i / fs)
    k *= blackman(n)
    return k / np.abs(k).sum()


# ---------------------------------------------------------------------------
# Textbook designers (recommended)
# ---------------------------------------------------------------------------

def _sinc_lowpass(num_taps: int, fc: float, fs: float) -> np.ndarray:
    """Symmetric windowed-sinc low-pass, unity DC gain."""
    n = int(num_taps)
    m = (n - 1) / 2.0
    i = np.arange(n)
    wc = 2 * np.pi * fc / fs  # rad/sample cutoff
    k = np.sinc((wc / np.pi) * (i - m)) * (wc / np.pi)
    k *= np.blackman(n)
    return k / k.sum()


def lowpass(num_taps: int, fc: float, fs: float) -> np.ndarray:
    return _sinc_lowpass(num_taps, fc, fs)


def highpass(num_taps: int, fc: float, fs: float) -> np.ndarray:
    """Spectral inversion of the low-pass; requires odd tap count."""
    n = int(num_taps)
    if n % 2 == 0:
        n += 1
    k = -_sinc_lowpass(n, fc, fs)
    k[(n - 1) // 2] += 1.0
    return k


def bandpass(num_taps: int, fl: float, fu: float, fs: float) -> np.ndarray:
    """Real band-pass: low-pass of width (fu-fl)/2 modulated to the band
    center by a cosine, normalized to unity gain at band center."""
    n = int(num_taps)
    m = (n - 1) / 2.0
    i = np.arange(n)
    k = _sinc_lowpass(n, (fu - fl) / 2.0, fs)
    f0 = (fl + fu) / 2.0
    k = 2.0 * k * np.cos(2 * np.pi * f0 * (i - m) / fs)
    # Normalize gain at f0:
    gain = np.abs(np.sum(k * np.exp(-2j * np.pi * f0 * i / fs)))
    return k / gain


def bandstop(num_taps: int, fl: float, fu: float, fs: float) -> np.ndarray:
    n = int(num_taps)
    if n % 2 == 0:
        n += 1
    k = -bandpass(n, fl, fu, fs)
    k[(n - 1) // 2] += 1.0
    return k


def complex_bandpass(num_taps: int, f0: float, width: float, fs: float) -> np.ndarray:
    """Complex (analytic) band-pass selecting only the band around +f0.

    Sign convention: taps are evaluated as a *correlation*
    ``y[n] = sum_i k[i] x[n-(N-1)+i]`` (see ops/fir.py), whose response
    peaks at +f0 for ``k[i] = lp[i] exp(-2j pi f0 i/fs)`` — same sign as the
    reference's kernel (src/baseband.hh:252).  With the opposite sign the
    filter selects -f0: the passband-gain test in tests/test_ops.py guards
    this.
    """
    n = int(num_taps)
    i = np.arange(n)
    k = _sinc_lowpass(n, width / 2.0, fs).astype(np.complex128)
    return k * np.exp(-2j * np.pi * f0 * i / fs)
