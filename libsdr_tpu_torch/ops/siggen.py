"""Test-signal generation (reference: src/siggen.hh SigGen/IQSigGen and
src/utils.hh:906-980 GWNSource).

Host-side numpy generators (fixtures are produced once, then streamed); a
numpy copy of ``libsdr_tpu.ops.siggen``, since importing that would load JAX.
"""

from __future__ import annotations

import numpy as np


def sine(fs: float, n: int, freqs, amps=None, phases=None,
         dtype=np.float32) -> np.ndarray:
    """Sum of real sines (reference: src/siggen.hh SigGen)."""
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    amps = np.ones_like(freqs) if amps is None else np.atleast_1d(amps)
    phases = np.zeros_like(freqs) if phases is None else np.atleast_1d(phases)
    t = np.arange(n, dtype=np.float64) / fs
    out = sum(a * np.sin(2 * np.pi * f * t + p)
              for f, a, p in zip(freqs, amps, phases))
    return out.astype(dtype)


def iq_carrier(fs: float, n: int, freq: float, amp: float = 1.0,
               phase: float = 0.0, dtype=np.complex64) -> np.ndarray:
    """Complex exponential carrier (reference: src/siggen.hh IQSigGen)."""
    t = np.arange(n, dtype=np.float64) / fs
    return (amp * np.exp(1j * (2 * np.pi * freq * t + phase))).astype(dtype)


def gaussian_noise(n, std: float = 1.0, complex_: bool = False,
                   seed: int = 0, dtype=None) -> np.ndarray:
    """Gaussian white noise (reference: src/utils.hh:957-969 GWNSource uses a
    Box-Muller polar method; any exact-distribution generator is equivalent)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if np.isscalar(n) else tuple(n)
    if complex_:
        z = rng.normal(0, std / np.sqrt(2), shape + (2,))
        out = (z[..., 0] + 1j * z[..., 1]).astype(dtype or np.complex64)
    else:
        out = rng.normal(0, std, shape).astype(dtype or np.float32)
    return out


def fm_modulate(fs: float, audio: np.ndarray, deviation: float,
                carrier: float = 0.0, dtype=np.complex64) -> np.ndarray:
    """FM-modulate an audio signal onto an IQ baseband carrier (fixture
    helper; the reference has no modulator — its fixtures are live radio)."""
    phase = 2 * np.pi * np.cumsum(
        carrier + deviation * audio.astype(np.float64)) / fs
    return np.exp(1j * phase).astype(dtype)


def fsk_modulate(fs: float, bits: np.ndarray, baud: float, f_mark: float,
                 f_space: float, dtype=np.complex64) -> np.ndarray:
    """Generate an FSK tone sequence (audio-band, real or complex) from a bit
    vector — fixture helper for the FSK/AX.25/RTTY decode tests."""
    spb = fs / baud
    n = int(round(len(bits) * spb))
    idx = np.minimum((np.arange(n) / spb).astype(np.int64), len(bits) - 1)
    freqs = np.where(np.asarray(bits)[idx] > 0, f_mark, f_space)
    phase = 2 * np.pi * np.cumsum(freqs) / fs
    return np.exp(1j * phase).astype(dtype)
