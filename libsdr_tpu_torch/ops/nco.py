"""NCO frequency shift (counterpart of ``libsdr_tpu.ops.nco``).

Two modes:

* ``exact`` (default): the per-block mixing vector
  ``exp(-2j pi f arange(B)/fs)`` is a float64 host constant; the carry is
  one unit phasor advanced by ``exp(-2j pi f B/fs)`` per block and
  renormalized, so phase error does not accumulate.
* ``lut``: model of the quantized reference NCO: a 128-entry complex LUT
  indexed by an integer 8.8 fixed-point phase accumulator with increment
  ``floor(128*256*|f|/fs)``; negative frequencies use the mirrored index
  ``127 - idx``.  The carry is the int32 accumulator.
"""

from __future__ import annotations

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.stream import StreamSpec

_LUT_SIZE = 128


def nco_ramp(freq: float, fs: float, n: int) -> np.ndarray:
    """exp(-2j pi freq arange(n) / fs), computed in float64 on the host."""
    ph = -2.0 * np.pi * freq * np.arange(n, dtype=np.float64) / fs
    return np.exp(1j * ph)


class FreqShift(Processor):
    """Mix a complex stream by ``exp(-2j pi f t)`` (shift +f down to DC).

    Args:
      freq: shift frequency in Hz.
      mode: 'exact' or 'lut' (see module docstring).
    """

    def __init__(self, freq: float, mode: str = "exact"):
        super().__init__()
        self.freq = float(freq)
        self.mode = mode
        self._dev_consts = {}

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("FreqShift")
        fs = in_spec.rate_hz
        b = in_spec.block_size
        if self.mode == "exact":
            self._table = nco_ramp(self.freq, fs, b)
            self._block_step = complex(np.exp(-2j * np.pi * self.freq * b / fs))
        elif self.mode == "lut":
            k = np.arange(_LUT_SIZE)
            self._table = np.exp(-2j * np.pi * k / _LUT_SIZE)
            self._lut_inc = int(_LUT_SIZE * 256 * abs(self.freq) / fs)
            self._modulus = _LUT_SIZE << 8
        else:
            raise ValueError(f"unknown FreqShift mode {self.mode!r}")
        self._dev_consts = {}
        return in_spec

    def _on(self, device) -> cplx.Complex:
        """The ramp (exact) or LUT (lut) as planes on ``device``."""
        key = str(device)
        if key not in self._dev_consts:
            self._dev_consts[key] = cplx.constant(
                self._table, self.in_spec.real_dtype, device)
        return self._dev_consts[key]

    def _init_carry(self, device):
        if self.mode == "exact":
            return cplx.full_like_phasor((), self.in_spec.real_dtype, device)
        return torch.zeros((), dtype=torch.int32, device=device)

    def apply(self, carry, x):
        if self.freq == 0.0:
            return carry, x
        table = self._on(x.device)
        if self.mode == "exact":
            y = x * (carry * table)
            nxt = carry * self._block_step
            nxt = cplx.Complex(nxt.re / nxt.abs(), nxt.im / nxt.abs())
            return nxt, y
        b = self.in_spec.block_size
        n = torch.arange(b, dtype=torch.int32, device=x.device)
        idx = ((carry + n * self._lut_inc) % self._modulus) >> 8
        if self.freq < 0:
            idx = _LUT_SIZE - idx - 1
        y = x * table[idx]
        nxt = (carry + b * self._lut_inc) % self._modulus
        return nxt.to(torch.int32), y
