"""Plumbing nodes: gain, dtype and layout conversion, I/Q balance,
interleave (counterpart of ``libsdr_tpu.ops.utils``).

The pipeline computes in float32 / planar complex64, so the fixed-point
cast family collapses into :class:`Cast` (with optional normalization to
[-1, 1) full scale) and :class:`AutoCast`.
"""

from __future__ import annotations

import torch

from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import (ConfigError, StreamSpec,
                                          as_torch_dtype, real_dtype_of)


class Scale(Processor):
    """y = scale * x."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = scale

    def apply(self, carry, x):
        if self.scale == 1.0:
            return carry, x
        return carry, x * self.scale


def _to(x, dtype: torch.dtype):
    """x in ``dtype`` (the plane dtype of a complex dtype for Complex)."""
    if isinstance(x, Complex):
        return x.to(real_dtype_of(dtype))
    return x.to(dtype)


class Cast(Processor):
    """Convert the dtype.  Integer -> float casts optionally normalize to
    [-1, 1) full scale (``1 / 2^(bits-1)``)."""

    def __init__(self, dtype, normalize: bool = False):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        self.normalize = normalize

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        self._scale = 1.0
        src = in_spec.dtype
        if self.normalize and not (src.is_floating_point or src.is_complex):
            bits = torch.iinfo(src).bits
            self._scale = 1.0 / (1 << (bits - 1))
        if in_spec.is_complex and not self.dtype.is_complex:
            raise ConfigError("Cast: can not cast complex stream to real "
                              "dtype; use RealPart/ImagPart")
        return in_spec.with_(dtype=self.dtype)

    def apply(self, carry, x):
        y = _to(x, self.dtype)
        if self._scale != 1.0:
            y = y * self._scale
        return carry, y


class AutoCast(Cast):
    """Normalization to the compute format: any integer or float stream
    becomes normalized float32 (complex64 for complex streams).

    Args:
      compute: plane dtype, 'float32' (default) or 'bfloat16'.  bfloat16
        planes halve the bytes the front-end kernels read and are lossless
        for 8-bit sources (8 significand bits fit bfloat16 exactly); use
        float32 for sources of 12 bits or more.
    """

    def __init__(self, compute: str = "float32"):
        super().__init__(torch.float32, normalize=True)
        self._compute = getattr(torch, compute)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        self.dtype = (torch.complex64 if in_spec.is_complex
                      else torch.float32)
        out = super()._bind(in_spec)
        if self._compute != torch.float32:
            # Advertise the narrow plane dtype so that downstream carries
            # (FIR tails and the like) start in the dtype the planes have.
            out = out.with_(plane_dtype=self._compute)
        return out

    def apply(self, carry, x):
        carry, y = super().apply(carry, x)
        if self._compute != torch.float32:
            y = y.to(self._compute)
        return carry, y


class ToComplex(Processor):
    """Real -> complex with zero imaginary part."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_real("ToComplex")
        out = (torch.complex128 if in_spec.dtype == torch.float64
               else torch.complex64)
        return in_spec.with_(dtype=out)

    def apply(self, carry, x):
        x = x.to(self.out_spec.real_dtype)
        return carry, Complex(x, torch.zeros_like(x))


class RealPart(Processor):
    """Complex -> real part."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("RealPart")
        return in_spec.with_(dtype=real_dtype_of(in_spec.dtype))

    def apply(self, carry, x):
        return carry, x.re


class ImagPart(Processor):
    """Complex -> imaginary part."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("ImagPart")
        return in_spec.with_(dtype=real_dtype_of(in_spec.dtype))

    def apply(self, carry, x):
        return carry, x.im


# Unsigned <-> signed integer dtypes of one width.
_SIGNED_OF = {torch.uint8: torch.int8, torch.uint16: torch.int16,
              torch.uint32: torch.int32}
_UNSIGNED_OF = {v: k for k, v in _SIGNED_OF.items()}


class _HalfRangeShift(Processor):
    """Integer stream shifted by half its range into the other signedness
    (computed in int64, then cast)."""

    _map: dict = {}
    _sign = 0

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        d = in_spec.dtype
        if d not in self._map:
            raise ConfigError(f"{type(self).__name__}: unsupported dtype {d}")
        self._half = 1 << (torch.iinfo(d).bits - 1)
        return in_spec.with_(dtype=self._map[d])

    def apply(self, carry, x):
        y = x.to(torch.int64) + self._sign * self._half
        return carry, y.to(self.out_spec.dtype)


class UnsignedToSigned(_HalfRangeShift):
    """u8/u16/u32 -> s8/s16/s32 by subtracting half the range."""

    _map, _sign = _SIGNED_OF, -1


class SignedToUnsigned(_HalfRangeShift):
    """s8/s16/s32 -> u8/u16/u32 by adding half the range."""

    _map, _sign = _UNSIGNED_OF, 1


class IQBalance(Processor):
    """I/Q gain-imbalance correction: y = I*gi + j*Q*gq."""

    def __init__(self, i_gain: float = 1.0, q_gain: float = 1.0):
        super().__init__()
        self.i_gain, self.q_gain = float(i_gain), float(q_gain)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("IQBalance")
        return in_spec

    def apply(self, carry, x):
        return carry, Complex(x.re * self.i_gain, x.im * self.q_gain)


def _map(x, fn):
    return x.map(fn) if isinstance(x, Complex) else fn(x)


class Interleave(Processor):
    """Interleave N equal-rate streams sample by sample into one stream at
    N times the rate: block (..., N, B) -> (..., N*B) with
    out[n*N + k] = in[k, n]."""

    def __init__(self, n: int):
        super().__init__()
        self.n = int(n)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        if not in_spec.channels or in_spec.channels[-1] != self.n:
            raise ConfigError(
                f"Interleave: expected trailing channel dim {self.n}, "
                f"got channels {in_spec.channels}")
        return in_spec.with_(
            channels=in_spec.channels[:-1],
            sample_rate=in_spec.sample_rate * self.n,
            block_size=in_spec.block_size * self.n)

    def apply(self, carry, x):
        def go(a):
            y = a.transpose(-1, -2)
            return y.reshape(y.shape[:-2] + (-1,))
        return carry, _map(x, go)


class Deinterleave(Processor):
    """Inverse of :class:`Interleave`: (..., N*B) -> (..., N, B)."""

    def __init__(self, n: int):
        super().__init__()
        self.n = int(n)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_block_multiple("Deinterleave", self.n)
        return in_spec.with_(
            channels=in_spec.channels + (self.n,),
            sample_rate=in_spec.sample_rate / self.n,
            block_size=in_spec.block_size // self.n)

    def apply(self, carry, x):
        def go(a):
            return a.reshape(a.shape[:-1] + (-1, self.n)).transpose(-1, -2)
        return carry, _map(x, go)
