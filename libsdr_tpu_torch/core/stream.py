"""Stream metadata: the static description of one stream between two
processors (counterpart of ``libsdr_tpu.core.stream``).

A frozen :class:`StreamSpec` flows through :meth:`Processor.bind` when a
pipeline is built.  It pins the element dtype, the exact rational sample
rate, the block size on the trailing time axis and the leading channel
shape.  dtypes are ``torch.dtype``; numpy dtypes are accepted and converted.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Tuple, Union

import numpy as np
import torch


class SDRError(Exception):
    """Base error of the package."""


class ConfigError(SDRError):
    """Raised when a processor rejects its input spec."""


class RuntimeSDRError(SDRError):
    """Runtime failure (an unreadable input file, for one)."""


RateLike = Union[int, float, Fraction]


def _as_fraction(rate: RateLike) -> Fraction:
    if isinstance(rate, Fraction):
        return rate
    if isinstance(rate, int):
        return Fraction(rate)
    # Sample rates given as floats are exactly representable in practice.
    return Fraction(rate).limit_denominator(10**9)


def as_torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Static description of a sample stream.

    Attributes:
      dtype: logical element dtype (``torch.complex64`` for IQ,
        ``torch.float32`` for audio).
      sample_rate: samples per second, exact rational.
      block_size: samples per block on the trailing time axis.
      channels: leading batch shape, ``()`` for one stream.
      ragged: True when blocks are :class:`~libsdr_tpu_torch.core.ragged.
        Ragged` (data, valid) pairs at capacity ``block_size`` and nominal
        rate ``sample_rate`` (the bit-sync PLL's output).
      plane_dtype: storage dtype of the planar samples when narrower than
        the logical dtype (``torch.bfloat16`` planes), else None.
    """

    dtype: torch.dtype
    sample_rate: Fraction
    block_size: int
    channels: Tuple[int, ...] = ()
    ragged: bool = False
    plane_dtype: object = None

    def __init__(self, dtype, sample_rate: RateLike, block_size: int,
                 channels: Tuple[int, ...] = (), ragged: bool = False,
                 plane_dtype=None):
        object.__setattr__(self, "dtype", as_torch_dtype(dtype))
        object.__setattr__(self, "sample_rate", _as_fraction(sample_rate))
        object.__setattr__(self, "block_size", int(block_size))
        object.__setattr__(self, "channels", tuple(int(c) for c in channels))
        object.__setattr__(self, "ragged", bool(ragged))
        object.__setattr__(self, "plane_dtype",
                           None if plane_dtype is None else
                           as_torch_dtype(plane_dtype))

    @property
    def shape(self) -> Tuple[int, ...]:
        """Full shape of one block: ``channels + (block_size,)``."""
        return self.channels + (self.block_size,)

    @property
    def rate_hz(self) -> float:
        return float(self.sample_rate)

    @property
    def is_complex(self) -> bool:
        return self.dtype.is_complex

    @property
    def real_dtype(self) -> torch.dtype:
        """Per-plane storage dtype (honours a narrower ``plane_dtype``)."""
        if self.plane_dtype is not None:
            return self.plane_dtype
        return real_dtype_of(self.dtype)

    def with_(self, **kw) -> "StreamSpec":
        """Functional update."""
        cur = dict(dtype=self.dtype, sample_rate=self.sample_rate,
                   block_size=self.block_size, channels=self.channels,
                   ragged=self.ragged, plane_dtype=self.plane_dtype)
        cur.update(kw)
        return StreamSpec(**cur)

    def require_dtype(self, who: str, *allowed) -> None:
        allowed_d = tuple(as_torch_dtype(a) for a in allowed)
        if self.dtype not in allowed_d:
            raise ConfigError(
                f"Can not configure {who}: invalid dtype {self.dtype}, "
                f"expected one of {[str(d) for d in allowed_d]}")

    def require_complex(self, who: str) -> None:
        if not self.is_complex:
            raise ConfigError(
                f"Can not configure {who}: expected complex input, "
                f"got {self.dtype}")

    def require_real(self, who: str) -> None:
        if self.is_complex:
            raise ConfigError(
                f"Can not configure {who}: expected real input, "
                f"got {self.dtype}")

    def require_block_multiple(self, who: str, n: int) -> None:
        if n <= 0 or self.block_size % n:
            raise ConfigError(
                f"Can not configure {who}: block_size {self.block_size} "
                f"must be a positive multiple of {n}")

    def __str__(self) -> str:
        ch = "x".join(map(str, self.channels)) + " ch, " if self.channels else ""
        return (f"StreamSpec({ch}{self.dtype} @ {float(self.sample_rate):g} "
                f"Hz, block={self.block_size})")


def result_dtype(*dtypes) -> torch.dtype:
    out = as_torch_dtype(dtypes[0])
    for d in dtypes[1:]:
        out = torch.promote_types(out, as_torch_dtype(d))
    return out


def real_dtype_of(dtype) -> torch.dtype:
    """float32 for complex64, float64 for complex128, identity otherwise."""
    dtype = as_torch_dtype(dtype)
    if dtype.is_complex:
        return torch.empty(0, dtype=dtype).real.dtype
    return dtype
