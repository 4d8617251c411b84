"""Automatic gain control (counterpart of ``libsdr_tpu.ops.agc``).

An exponential envelope is tracked per sample::

    sd[n]   = lambda*sd[n-1] + (1-lambda)*|x[n]|,  lambda = exp(-1/(tau*fs))
    gain[n] = target / (4*sd[n])
    y[n]    = gain[n] * x[n]

The envelope is a first-order recurrence (:mod:`libsdr_tpu_torch.ops.iir`);
the gain is elementwise.  The fused AM and SSB front ends
(``ops/fm_fused.py``) absorb an AGC that follows their demodulator and run
it inside their kernel call.
"""

from __future__ import annotations

import math

import torch

from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.stream import StreamSpec, real_dtype_of
from libsdr_tpu_torch.ops.iir import iir_first_order


class AGC(Processor):
    """Args:
      tau: envelope time constant in seconds (default 0.1).
      target: output target level (default 0.5).
      enabled: if False, applies the frozen ``gain`` only.
      gain: initial/frozen gain.
    """

    def __init__(self, tau: float = 0.1, target: float = 0.5,
                 enabled: bool = True, gain: float = 1.0):
        super().__init__()
        self.tau = float(tau)
        self.target = float(target)
        self.enabled = enabled
        self.gain = float(gain)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        self._lambda = math.exp(-1.0 / (self.tau * in_spec.rate_hz))
        return in_spec

    def _init_carry(self, device):
        # sd starts at the target
        return torch.full(self.in_spec.channels, self.target,
                          dtype=real_dtype_of(self.in_spec.dtype),
                          device=device)

    def apply(self, carry, x):
        if not self.enabled:
            return carry, x * self.gain
        env = x.abs()
        sd, sd_last = iir_first_order(env, self._lambda, 1.0 - self._lambda,
                                      carry)
        gain = self.target / (4.0 * sd)
        return sd_last, x * gain
