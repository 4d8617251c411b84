"""Analog demodulators: AM, SSB (USB), FM and FM de-emphasis (counterpart
of ``libsdr_tpu.ops.demod``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.stream import StreamSpec, real_dtype_of
from libsdr_tpu_torch.ops.iir import iir_first_order


class AMDemod(Processor):
    """AM envelope: ``|x| = sqrt(re^2 + im^2)``."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("AMDemod")
        return in_spec.with_(dtype=real_dtype_of(in_spec.dtype),
                             plane_dtype=None)

    def apply(self, carry, x):
        # bf16 planes are widened: the output is the spec's float32
        return carry, x.to(self.out_spec.dtype).abs()


class USBDemod(Processor):
    """SSB demod as ``(re + im)/2`` after the baseband shift.  LSB is the
    negative band selected in IQBaseBand."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("USBDemod")
        return in_spec.with_(dtype=real_dtype_of(in_spec.dtype),
                             plane_dtype=None)

    def apply(self, carry, x):
        x = x.to(self.out_spec.dtype)
        return carry, (x.re + x.im) * 0.5


class FMDemod(Processor):
    """Quadrature FM discriminator.

    mode='quadrature' (default): ``y[n] = angle(x[n] * conj(x[n-1]))`` in
    radians per sample; the carry is the previous complex sample.

    mode='ref': float model of the reference's integer formula:
    ``phi[n] = atan2(re, im)/2`` and ``y[n] = phi[n-1] - phi[n]``.

    Args:
      gain: output scale; ``fs/(2*pi*deviation)`` normalizes a given FM
        deviation to +-1.
    """

    def __init__(self, mode: str = "quadrature", gain: float = 1.0):
        super().__init__()
        self.mode = mode
        self.gain = float(gain)
        # Mixer frequencies folded in by the fusion pass (core/fuse.py): an
        # upstream NCO e^(-i w n) collapses to the constant e^(-i w) in the
        # x[n]*conj(x[n-1]) product.
        self._pending_rot_freqs: list = []
        self._rot = None

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("FMDemod")
        self._rot = None
        if self._pending_rot_freqs:
            w = 2.0 * np.pi * sum(self._pending_rot_freqs) / in_spec.rate_hz
            self._rot = complex(np.exp(-1j * w))
        return in_spec.with_(dtype=real_dtype_of(in_spec.dtype),
                             plane_dtype=None)

    def _init_carry(self, device):
        ch = self.in_spec.channels
        if self.mode == "quadrature":
            phasor = cplx.full_like_phasor(ch, self.in_spec.real_dtype,
                                           device)
            if self._rot is not None:
                # Cancel the folded rotation on the very first sample so the
                # initial transient matches the unfused graph.
                phasor = phasor * self._rot
            return phasor
        return torch.zeros(ch, dtype=self.out_spec.dtype, device=device)

    def apply(self, carry, x):
        if self.mode == "quadrature":
            prev = cplx.concatenate([carry[..., None], x[..., :-1]], axis=-1)
            z = x * prev.conj()
            if self._rot is not None:
                z = z * self._rot
            return x[..., -1], z.angle() * self.gain
        phi = torch.atan2(x.re, x.im) * 0.5
        prev_phi = torch.cat([carry[..., None], phi[..., :-1]], dim=-1)
        return phi[..., -1], (prev_phi - phi) * self.gain


def deemph_coeffs(fs: float, tau: float):
    """(a, b) of the de-emphasis ``y[n] = a*y[n-1] + b*x[n]`` at output rate
    ``fs``: ``alpha = round(1/(1 - exp(-1/(fs*tau))))``, a = 1 - 1/alpha,
    b = 1/alpha (the Euler form of the reference's integer update)."""
    alpha = max(1, int(round(1.0 / (1.0 - math.exp(-1.0 / (fs * tau))))))
    return 1.0 - 1.0 / alpha, 1.0 / alpha


class FMDeemph(Processor):
    """FM de-emphasis: a single-pole low-pass with time constant ``tau``.

    Args:
      tau: time constant in seconds (75e-6 for US/EU FM broadcast).
      enabled: bypass flag.
    """

    def __init__(self, tau: float = 75e-6, enabled: bool = True):
        super().__init__()
        self.tau = float(tau)
        self.enabled = enabled

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_real("FMDeemph")
        self._a, self._b = deemph_coeffs(in_spec.rate_hz, self.tau)
        return in_spec

    def _init_carry(self, device):
        return torch.zeros(self.in_spec.channels, dtype=self.in_spec.dtype,
                           device=device)

    def apply(self, carry, x):
        if not self.enabled:
            return carry, x
        y, last = iir_first_order(x, self._a, self._b, carry)
        return last, y
