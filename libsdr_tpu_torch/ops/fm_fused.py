"""Fused FM receiver front end: IQBaseBand + quadrature FMDemod (+ FMDeemph)
as one op (counterpart of ``libsdr_tpu.ops.fm_fused.FMBasebandFused``).

Installed by the fusion pass (core/fuse.py).  Each block is one call of
``ops/fir_fm.fir_fm_exact``: the decimating FIR over the raw IQ, the
discriminator and the de-emphasis in one pass, so the complex baseband never
reaches device memory.  The math equals the unfused chain with the NCO
folded: y = decimating-FIR(x, g2), audio[j] = gain * angle(y[j] * conj(y[j-1])
* rot), rot = e^(-i 2 pi fc D / fs), with the kernel's polynomial atan2.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.stream import StreamSpec
from libsdr_tpu_torch.ops.baseband import (IQBaseBand, band_taps,
                                           fused_baseband_taps)
from libsdr_tpu_torch.ops.demod import FMDemod, deemph_coeffs
from libsdr_tpu_torch.ops.fir_fm import fir_fm_exact


class FMBasebandFused(Processor):
    """One-op FM front end (built by core/fuse.py from IQBaseBand+FMDemod).

    The carry is ``(tail, prev)`` or, with de-emphasis, ``(tail, prev,
    dstate)``: tail Complex (channels + (T-1,)) in the input plane dtype,
    prev Complex (channels) float32 and dstate (channels) float32 — the
    JAX op's carry, leaf for leaf.
    """

    def __init__(self, bb: IQBaseBand, demod: FMDemod):
        super().__init__()
        self.bb = bb
        self.demod = demod
        self.deemph = None  # set by core/fuse.py when an FMDeemph follows
        self._taps_dev = {}

    def absorb_deemph(self, deemph) -> None:
        self.deemph = deemph

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("FMBasebandFused")
        bb = self.bb
        fs = in_spec.rate_hz
        if bb.out_rate is not None:
            bb.decim = max(1, int(fs / bb.out_rate))
        in_spec.require_block_multiple("FMBasebandFused", bb.decim)
        g = fused_baseband_taps(band_taps(bb, fs), bb.fc, fs, bb.decim)
        t = len(g)
        w = 2 * np.pi * bb.fc / fs
        offset = bb.decim - 1  # the exact-tiling convention of fir_fm_exact
        self._g2 = g * np.exp(-1j * w * (np.arange(t) - (t - 1) + offset))
        self._decim = bb.decim
        self._t = t
        self._rot = np.exp(-1j * w * bb.decim)
        self._gain = float(self.demod.gain)
        self._dab = (None if self.deemph is None else
                     deemph_coeffs(fs / bb.decim, self.deemph.tau))
        self._taps_dev = {}
        return in_spec.with_(
            dtype=torch.float32, plane_dtype=None,
            sample_rate=in_spec.sample_rate / bb.decim,
            block_size=in_spec.block_size // bb.decim)

    def _taps(self, device) -> cplx.Complex:
        key = str(device)
        if key not in self._taps_dev:
            self._taps_dev[key] = cplx.constant(self._g2, torch.float32,
                                                device)
        return self._taps_dev[key]

    def init_carry(self, device=None):
        ch = self.in_spec.channels
        tail = cplx.zeros(ch + (self._t - 1,), self.in_spec.real_dtype,
                          device)
        # prev = rot cancels the folded rotation on the very first sample,
        # matching the unfused graph's initial transient.
        prev = cplx.full_like_phasor(ch, torch.float32, device) * complex(
            self._rot)
        if self._dab is None:
            return (tail, prev)
        return (tail, prev, torch.zeros(ch, dtype=torch.float32,
                                        device=device))

    def apply(self, carry, x):
        tail, prev = carry[0], carry[1]
        ch = x.re.shape[:-1]
        b, t, d = x.re.shape[-1], self._t, self._decim
        c = math.prod(ch)
        dstate = None if self._dab is None else carry[2].reshape(c)
        audio, y_last = fir_fm_exact(
            x.reshape(c, b), self._taps(x.device), d,
            tail.reshape(c, t - 1), prev.reshape(c), self._rot, self._gain,
            deemph_ab=self._dab, dstate=dstate)
        audio = audio.reshape(ch + (b // d,))
        # The new tail is a copy: a view would keep the whole block alive.
        if b >= t - 1:
            new_tail = x[..., b - (t - 1):].map(torch.clone)
        else:
            xc = cplx.concatenate([tail.to(x.re.dtype), x], axis=-1)
            new_tail = xc[..., xc.shape[-1] - (t - 1):]
        new_prev = y_last.reshape(ch)
        if self._dab is None:
            return (new_tail, new_prev), audio
        return (new_tail, new_prev, audio[..., -1]), audio
