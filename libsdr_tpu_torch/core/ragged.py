"""Ragged block outputs (counterpart of ``libsdr_tpu.core.ragged``).

Decoders emit a variable number of items per fixed-size input block (bits
from the bit-sync PLL).  A ragged block is a fixed-capacity ``data`` tensor
plus a boolean ``valid`` mask of the same shape, time on the trailing axis,
compacted on the host with :func:`compact` or on the device with
:func:`compact_device` / :func:`compact_windows`.  PyTorch has no pytrees,
so :class:`Ragged` is a plain pair.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Ragged:
    """Fixed-capacity block with a validity mask (time = trailing axis)."""

    __slots__ = ("data", "valid")

    def __init__(self, data, valid):
        self.data = data
        self.valid = valid

    @property
    def shape(self):
        return self.data.shape

    def to_numpy(self) -> "Ragged":
        """The pair as host numpy arrays."""
        return Ragged(_np(self.data), _np(self.valid).astype(bool))

    def __repr__(self):
        return (f"Ragged(capacity={tuple(self.data.shape)}, "
                f"dtype={self.data.dtype})")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def compact(r: Ragged):
    """Host-side: the valid items of a (possibly multi-block concatenated)
    ragged stream.  1-D streams return a dense numpy array; channel banks a
    list of per-channel vectors (flattened over the leading channel axes)."""
    data = _np(r.data)
    valid = _np(r.valid).astype(bool)
    if data.ndim == 1:
        return data[valid]
    flat_d = data.reshape(-1, data.shape[-1])
    flat_v = valid.reshape(-1, valid.shape[-1])
    return [d[v] for d, v in zip(flat_d, flat_v)]


def compact_device(r: Ragged, capacity: int):
    """On-device compaction: the valid items of each channel's row moved to
    the front of a ``capacity`` buffer.  Returns (data (..., capacity),
    counts (...)): ``counts`` is the unclamped valid count, so ``counts >
    capacity`` shows that items past the capacity were dropped."""
    data, valid = r.data, r.valid.to(torch.bool)
    pos = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
    idx = torch.where(valid, pos, torch.full_like(pos, capacity))
    idx = idx.clamp_max(capacity)          # beyond capacity: the drop slot
    out = torch.zeros(data.shape[:-1] + (capacity + 1,), dtype=data.dtype,
                      device=data.device)
    out.scatter_(-1, idx, data)
    # Several items land in the drop slot; only the first capacity matter.
    return out[..., :capacity], valid.sum(dim=-1)


def compact_windows(r: Ragged, window: int) -> Ragged:
    """Lossless on-device decimation of a ragged stream whose valid slots are
    at least ``window`` samples apart (``window`` <= :func:`min_valid_gap`):
    the last axis folded into (T/window, window), each window reduced to its
    one valid item (or none)."""
    data, valid = r.data, r.valid.to(torch.bool)
    t = data.shape[-1]
    if t % window:
        raise ValueError(f"compact_windows: T={t} not divisible by "
                         f"window={window}")
    shape = tuple(data.shape[:-1]) + (t // window, window)
    vw = valid.reshape(shape)
    # At most one valid item per window: the masked sum is that item.
    dw = torch.where(vw, data.reshape(shape), torch.zeros((), dtype=data.dtype,
                                                          device=data.device))
    return Ragged(dw.sum(dim=-1).to(data.dtype), vw.any(dim=-1))


def min_valid_gap(bitstream_or_omega) -> int:
    """Guaranteed minimum sample gap between valid bits of a bit-sync PLL
    (a bound BitStream, or its omega_max as a float): after an emission the
    residual phase is below omega_max, so the next one is at least
    floor(1/omega_max) steps later (not ceil: a residual just under
    omega_max brings the next bit one step earlier)."""
    om = (float(bitstream_or_omega)
          if isinstance(bitstream_or_omega, (int, float))
          else float(bitstream_or_omega._omega_max))
    return int(math.floor(1.0 / om))


def pick_window(gap: int, t_full: int, cap: int = 64) -> int:
    """Largest power-of-two compaction window that divides ``t_full`` and
    respects the PLL's guaranteed bit gap (:func:`min_valid_gap`); 0 when no
    window >= 2 fits."""
    w = 1
    while w * 2 <= min(gap, cap) and t_full % (w * 2) == 0:
        w *= 2
    return w if w > 1 else 0


def concat_host(blocks) -> Ragged:
    """Concatenate ragged blocks along time into one host (numpy) Ragged."""
    return Ragged(np.concatenate([_np(b.data) for b in blocks], axis=-1),
                  np.concatenate([_np(b.valid) for b in blocks], axis=-1))
