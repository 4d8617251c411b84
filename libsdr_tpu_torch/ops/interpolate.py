"""Fractional-delay interpolation bank (copied from
``libsdr_tpu.ops.interpolate``, which is numpy-only; importing it would
load JAX).

A 129 x 8 table of 8-tap interpolation filters indexed by the fractional
delay mu in [0, 1] at 1/128 resolution; row mu evaluates the signal at
position ``4 - mu`` within an 8-sample window (row 0 = delta at index 4,
row 128 = delta at index 3): Blackman-windowed sinc filters with unity DC
gain.
"""

from __future__ import annotations

import functools

import numpy as np

NSTEPS = 128   # table resolution (129 rows = NSTEPS+1)
NTAPS = 8      # taps per filter
CENTER = 4     # row 0 is a delta at index 4


@functools.lru_cache(maxsize=None)
def interpolation_bank() -> np.ndarray:
    """(NSTEPS+1, NTAPS) float32 bank; row r evaluates x at window position
    ``CENTER - r/NSTEPS``."""
    bank = np.zeros((NSTEPS + 1, NTAPS), dtype=np.float64)
    i = np.arange(NTAPS)
    for r in range(NSTEPS + 1):
        mu = r / NSTEPS
        t = i - (CENTER - mu)  # distance from the evaluation point
        h = np.sinc(t)
        # Blackman window centered on the evaluation point, spanning the taps.
        w = (0.42 + 0.5 * np.cos(np.pi * t / CENTER)
             + 0.08 * np.cos(2 * np.pi * t / CENTER))
        h = h * np.clip(w, 0.0, None)
        bank[r] = h / h.sum()  # unity DC gain
    return bank.astype(np.float32)


def interpolate(window: np.ndarray, mu: float):
    """Evaluate an 8-sample window at position CENTER - mu."""
    row = int(round(mu * NSTEPS))
    return (window * interpolation_bank()[row]).sum(axis=-1)
