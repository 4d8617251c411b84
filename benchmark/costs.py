"""The yardstick's arithmetic: the card's published peaks, the least time a
block's work could take on them, and rates.

Peaks of one NVIDIA H100 SXM (the data sheet, dense, at its 700 W limit):
HBM3 at 3.35 TB/s and float32 outside the tensor cores at 67 TFLOP/s.  A
configuration's file states its work per complex input sample (``cost``:
the bytes read once and written once, and the float32 operations), so the
bound reads the same work whatever implements it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(cost: dict, samples: float) -> float:
    """The least time for ``samples`` complex input samples of work: the
    larger of its bytes at the HBM peak and its operations at the float32
    peak."""
    return max(cost["bytes_per_sample"] * samples / HBM_BYTES_PER_S,
               cost["flops_per_sample"] * samples / F32_FLOPS_PER_S)


def msps(samples: float, seconds: float) -> float:
    """Millions of samples a second."""
    return samples / seconds / 1e6


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
