"""Fused receiver front ends: IQBaseBand + a demodulator as one op
(counterparts of ``libsdr_tpu.ops.fm_fused``).

Installed by the fusion pass (core/fuse.py).  Each block is one call of an
entry of ``ops/fir_fm.py``: the decimating FIR over the raw IQ and the
demodulator (with FM de-emphasis or an AGC) in one pass, so the complex
baseband never reaches device memory.

* :class:`FMBasebandFused`, IQBaseBand + quadrature FMDemod (+ FMDeemph):
  y = decimating-FIR(x, g2), audio[j] = gain * angle(y[j] * conj(y[j-1]) *
  rot), rot = e^(-i 2 pi fc D / fs), with the kernel's polynomial atan2.
* :class:`AMBasebandFused`, IQBaseBand + AMDemod (+ AGC): |y| is rotation
  invariant, so the NCO vanishes.
* :class:`USBBasebandFused`, IQBaseBand + USBDemod (+ AGC): the SSB demod
  is not rotation invariant, so every output is rotated by the exact NCO
  phasor a0 * exp(-i theta j): a host-float64 ramp stored as float32 times
  the carried unit phasor a0, renormalized every block (as FreqShift's
  exact mode does).

Math equal to the unfused chain with the NCO folded into the taps:
g2[i] = g[i] exp(-i w (i - (T-1) + D-1)), w = 2 pi fc / fs.
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
from libsdr_tpu_torch.ops.fir import new_tail
from libsdr_tpu_torch.ops.fir_fm import (fir_am_exact, fir_fm_exact,
                                         fir_usb_exact)


class _FusedFrontEnd(Processor):
    """What the fused front ends share: the IQBaseBand's fused taps on each
    device, the (channels + (T-1,)) tail carry in the input plane dtype, and
    the float32 output spec at the decimated rate."""

    def __init__(self, bb: IQBaseBand):
        super().__init__()
        self.bb = bb
        self._dev_consts = {}

    def _bind_front(self, in_spec: StreamSpec, who: str) -> StreamSpec:
        in_spec.require_complex(who)
        bb = self.bb
        fs = in_spec.rate_hz
        if bb.out_rate is not None:
            bb.decim = max(1, int(fs / bb.out_rate))
        in_spec.require_block_multiple(who, bb.decim)
        g = fused_baseband_taps(band_taps(bb, fs), bb.fc, fs, bb.decim)
        t = len(g)
        w = 2 * np.pi * bb.fc / fs
        offset = bb.decim - 1  # the exact-tiling convention of ops/fir_fm
        self._g2 = g * np.exp(-1j * w * (np.arange(t) - (t - 1) + offset))
        self._decim = bb.decim
        self._t = t
        self._dev_consts = {}
        return in_spec.with_(
            dtype=torch.float32, plane_dtype=None,
            sample_rate=in_spec.sample_rate / bb.decim,
            block_size=in_spec.block_size // bb.decim)

    def _on(self, name: str, value, device):
        """A host constant as float32 tensors (planes if complex) on
        ``device``, made once per device."""
        key = (name, str(device))
        if key not in self._dev_consts:
            self._dev_consts[key] = cplx.constant(value, torch.float32,
                                                  device)
        return self._dev_consts[key]

    def _taps(self, device) -> cplx.Complex:
        return self._on("taps", self._g2, device)

    def _tail0(self, device):
        return cplx.zeros(self.in_spec.channels + (self._t - 1,),
                          self.in_spec.real_dtype, device)

    def _flat(self, x, tail):
        """x as (C, B) and the tail as (C, T-1), C the channel count."""
        ch = x.re.shape[:-1]
        c = math.prod(ch)
        return ch, c, x.reshape(c, x.re.shape[-1]), tail.reshape(c,
                                                                 self._t - 1)

    def _bind_agc(self, agc, out_rate: float) -> None:
        """AGC constants of the AM and SSB ops at the output rate:
        (lam, 1 - lam) and the gain target/4, or no AGC and gain 1."""
        self.agc = agc
        if agc is None:
            self._ab, self._gain = None, 1.0
            return
        lam = math.exp(-1.0 / (agc.tau * out_rate))
        self._ab = (lam, 1.0 - lam)
        self._gain = agc.target / 4.0

    def _sd0(self, device):
        return torch.full(self.in_spec.channels, self.agc.target,
                          dtype=torch.float32, device=device)


class AMBasebandFused(_FusedFrontEnd):
    """One-op AM front end (built by core/fuse.py from [IQBaseBand ->
    AMDemod (-> AGC)]): decimating band-pass FIR + envelope + optional AGC
    in one kernel call per block.

    The carry is ``(tail,)`` or, with the AGC, ``(tail, sd)``: tail Complex
    (channels + (T-1,)) in the input plane dtype and sd (channels) float32
    — the JAX op's carry, leaf for leaf.
    """

    def __init__(self, bb: IQBaseBand, agc=None):
        super().__init__(bb)
        self.agc = agc

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        out = self._bind_front(in_spec, "AMBasebandFused")
        self._bind_agc(self.agc, in_spec.rate_hz / self._decim)
        return out

    def _init_carry(self, device):
        tail = self._tail0(device)
        if self._ab is None:
            return (tail,)
        return (tail, self._sd0(device))

    def apply(self, carry, x):
        tail = carry[0]
        ch, c, x2, tail2 = self._flat(x, tail)
        sd = None if self._ab is None else carry[1].reshape(c)
        audio, sd_last = fir_am_exact(x2, self._taps(x.device), self._decim,
                                      tail2, self._gain, self._ab, sd)
        audio = audio.reshape(ch + (audio.shape[-1],))
        tail = new_tail(x, tail, self._t)
        if self._ab is None:
            return (tail,), audio
        return (tail, sd_last.reshape(ch)), audio


class USBBasebandFused(_FusedFrontEnd):
    """One-op SSB front end (built by core/fuse.py from [IQBaseBand ->
    USBDemod (-> AGC)]): decimating band-pass FIR + exact NCO rotation +
    (re+im)/2 + optional AGC in one kernel call per block (LSB is the
    negative filter band).

    The carry is ``(tail, phasor)`` or, with the AGC, ``(tail, phasor,
    sd)``: phasor is the unit phasor a0 of the block's first output,
    Complex of shape () float32 — the JAX op's carry, leaf for leaf.
    """

    def __init__(self, bb: IQBaseBand, agc=None):
        super().__init__(bb)
        self.agc = agc

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        out = self._bind_front(in_spec, "USBBasebandFused")
        w = 2 * np.pi * self.bb.fc / in_spec.rate_hz
        n_out = out.block_size
        theta = w * self._decim  # per-output phase step
        # exact-NCO constants (host float64, like ops/nco.py 'exact')
        self._ramp_np = np.exp(-1j * theta * np.arange(n_out))
        self._step_np = np.exp(-1j * theta * n_out)
        self._bind_agc(self.agc, in_spec.rate_hz / self._decim)
        return out

    def _init_carry(self, device):
        tail = self._tail0(device)
        phasor = cplx.full_like_phasor((), torch.float32, device)
        if self._ab is None:
            return (tail, phasor)
        return (tail, phasor, self._sd0(device))

    def _next_phasor(self, a0):
        nxt = a0 * self._on("step", self._step_np, a0.device)
        mag = nxt.abs()
        return cplx.Complex(nxt.re / mag, nxt.im / mag)

    def apply(self, carry, x):
        tail, a0 = carry[0], carry[1]
        ch, c, x2, tail2 = self._flat(x, tail)
        sd = None if self._ab is None else carry[2].reshape(c)
        audio, sd_last = fir_usb_exact(
            x2, self._taps(x.device), self._decim, tail2, a0,
            self._on("ramp", self._ramp_np, x.device), self._gain, self._ab,
            sd)
        audio = audio.reshape(ch + (audio.shape[-1],))
        new = (new_tail(x, tail, self._t), self._next_phasor(a0))
        if self._ab is None:
            return new, audio
        return new + (sd_last.reshape(ch),), audio


class FMBasebandFused(_FusedFrontEnd):
    """One-op FM front end (built by core/fuse.py from IQBaseBand+FMDemod).

    The carry is ``(tail, prev)`` or, with de-emphasis, ``(tail, prev,
    dstate)``: tail Complex (channels + (T-1,)) in the input plane dtype,
    prev Complex (channels) float32 and dstate (channels) float32 — the
    JAX op's carry, leaf for leaf.
    """

    def __init__(self, bb: IQBaseBand, demod: FMDemod):
        super().__init__(bb)
        self.demod = demod
        self.deemph = None  # set by core/fuse.py when an FMDeemph follows

    def absorb_deemph(self, deemph) -> None:
        self.deemph = deemph

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        out = self._bind_front(in_spec, "FMBasebandFused")
        w = 2 * np.pi * self.bb.fc / in_spec.rate_hz
        self._rot = np.exp(-1j * w * self._decim)
        self._gain = float(self.demod.gain)
        self._dab = (None if self.deemph is None else
                     deemph_coeffs(in_spec.rate_hz / self._decim,
                                   self.deemph.tau))
        return out

    def _init_carry(self, device):
        ch = self.in_spec.channels
        tail = self._tail0(device)
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
        ch, c, x2, tail2 = self._flat(x, tail)
        dstate = None if self._dab is None else carry[2].reshape(c)
        audio, y_last = fir_fm_exact(
            x2, self._taps(x.device), self._decim, tail2, prev.reshape(c),
            self._rot, self._gain, deemph_ab=self._dab, dstate=dstate)
        audio = audio.reshape(ch + (audio.shape[-1],))
        tail = new_tail(x, tail, self._t)
        prev = y_last.reshape(ch)
        if self._dab is None:
            return (tail, prev), audio
        return (tail, prev, audio[..., -1]), audio
