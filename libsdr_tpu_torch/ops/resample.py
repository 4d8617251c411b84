"""Rate conversion (counterpart of ``libsdr_tpu.ops.resample``): an integer
averaging decimator, the reference's fractional decimator, and a
polyphase-interpolating rational resampler (reference: src/subsample.hh).

With a rational ratio p/q and ``block*q % p == 0`` the outputs a block and
every (input index, fractional phase) pair are fixed at bind: the resampler
is one gather of (n_out, 8) windows times a constant (n_out, 8) tap matrix,
both made at bind from ``ops/interpolate.py`` and placed on the block's
device at first use.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import ConfigError, StreamSpec
from libsdr_tpu_torch.ops.interpolate import (CENTER, NSTEPS, NTAPS,
                                              interpolation_bank)


def _planes(x, fn):
    """``fn`` on a real tensor, or on both planes of a Complex."""
    return x.map(fn) if isinstance(x, Complex) else fn(x)


class SubSample(Processor):
    """Averaging decimator: out[j] = mean(x[j*n:(j+1)*n])
    (reference: src/subsample.hh:15-115 SubSample).

    Args:
      n: decimation factor; or
      out_rate: target rate, n = max(1, floor(fs/out_rate)).
    """

    def __init__(self, n: int = None, out_rate: float = None):
        super().__init__()
        if (n is None) == (out_rate is None):
            raise ValueError("SubSample: give exactly one of n / out_rate")
        self.n = None if n is None else max(1, int(n))
        self.out_rate = out_rate

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        if self.out_rate is not None:
            self.n = max(1, int(in_spec.rate_hz / self.out_rate))
        in_spec.require_block_multiple("SubSample", self.n)
        return in_spec.with_(sample_rate=in_spec.sample_rate / self.n,
                             block_size=in_spec.block_size // self.n)

    def apply(self, carry, x):
        if self.n == 1:
            return carry, x
        n = self.n
        return carry, _planes(
            x, lambda a: a.reshape(a.shape[:-1] + (-1, n)).mean(dim=-1))


class FracSubSample(SubSample):
    """Fractional decimator with the reference's exact behaviour: its
    16.16 phase accumulator resets to zero on every emission instead of
    keeping the remainder (reference: src/subsample.hh:168-175), so it is
    a fixed averaging decimator by ``ceil(frac)`` (2.5 acts as /3).  Use
    :class:`Resampler` for true fractional rates."""

    def __init__(self, frac: float):
        if frac < 1:
            raise ConfigError(
                f"FracSubSample: can not sub-sample with fraction < 1: {frac}")
        period = int(frac * (1 << 16))  # reference: src/subsample.hh:137
        super().__init__(n=math.ceil(period / (1 << 16)))
        self.frac = frac


class Resampler(Processor):
    """Polyphase-interpolating rational resampler (reference:
    src/subsample.hh:194-288 InpolSubSampler, generalized to up- and
    down-sampling): output rate ``fs*q/p`` from the 8-tap fractional-delay
    bank of ``ops/interpolate.py``.  Needs ``block*q % p == 0``.

    Output o at input time ``t = (T0 + o*p)/q`` (T0 = 3q, a fixed latency)
    interpolates the window ``x[n-3 .. n+4]``, n = floor(t).  Do not
    downsample by more than ~8 without a low-pass first
    (src/subsample.hh:188-192).
    """

    def __init__(self, frac=None, p: int = None, q: int = None):
        super().__init__()
        if frac is not None:
            f = Fraction(frac).limit_denominator(1 << 16)
            p, q = f.numerator, f.denominator
        if not p or not q:
            raise ValueError("Resampler: give frac or p and q")
        g = math.gcd(p, q)
        self.p, self.q = p // g, q // g

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        b = in_spec.block_size
        p, q = self.p, self.q
        if (b * q) % p:
            raise ConfigError(
                f"Resampler: block_size*q ({b}*{q}) must be divisible by p "
                f"({p}); pick a block size that is a multiple of "
                f"{p // math.gcd(p, q * b // math.gcd(b, p))}")
        n_out = b * q // p
        t0 = 3 * q  # fixed latency keeps every window inside concat(tail, x)
        times = t0 + np.arange(n_out, dtype=np.int64) * p
        n = times // q                       # floor input index per output
        mu = (times % q) / q                 # fractional part in [0,1)
        rows = np.round((1.0 - mu) * NSTEPS).astype(np.int64)
        self._weights_np = interpolation_bank()[rows]        # (n_out, 8)
        idx = (n[:, None] - (CENTER - 1)) + np.arange(NTAPS)[None, :]
        assert idx.min() >= 0 and idx.max() <= b + NTAPS - 2, "window bounds"
        self._idx_np = idx                                    # (n_out, 8)
        self._n_out = n_out
        self._consts = {}
        return in_spec.with_(sample_rate=in_spec.sample_rate * q / p,
                             block_size=n_out)

    def _on(self, device):
        """(gather indices, tap rows) on ``device``, made at first use."""
        key = str(device)
        if key not in self._consts:
            self._consts[key] = (
                torch.as_tensor(self._idx_np, device=device),
                torch.as_tensor(self._weights_np, device=device).to(
                    self.in_spec.real_dtype))
        return self._consts[key]

    def _init_carry(self, device):
        shape = self.in_spec.channels + (NTAPS - 1,)
        if self.in_spec.is_complex:
            return cplx.zeros(shape, self.in_spec.real_dtype, device)
        return torch.zeros(shape, dtype=self.in_spec.real_dtype,
                           device=device)

    def apply(self, carry, x):
        xc = cplx.concatenate([carry, x], axis=-1)       # (..., B+7)
        idx, w = self._on(getattr(xc, "re", xc).device)
        y = _planes(xc, lambda a: (a[..., idx] * w).sum(dim=-1))
        # a copy: a view would keep the whole concatenation alive
        tail = _planes(xc, lambda a: a[..., a.shape[-1] - (NTAPS - 1):]
                       .clone())
        return tail, y


class InpolSubSampler(Resampler):
    """Reference-named alias: sub-sample by ``frac`` (output rate =
    fs/frac; reference: src/subsample.hh:194-288)."""

    def __init__(self, frac: float):
        if frac <= 0:
            raise ConfigError(
                "InpolSubSampler: sample rate fraction must be > 0, "
                f"got {frac}")
        f = Fraction(frac).limit_denominator(1 << 16)
        super().__init__(p=f.numerator, q=f.denominator)
