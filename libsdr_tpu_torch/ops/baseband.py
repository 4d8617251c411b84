"""Baseband selection: band-pass filter + NCO shift + averaging decimator in
one strided convolution (counterpart of ``libsdr_tpu.ops.baseband``).

Per input sample n the chain computes

    filt[n]  = sum_i k[i] * x[n-N+1+i]          (complex band-pass at Ff)
    shift[n] = filt[n] * exp(-i w n)             (w = 2 pi Fc / fs)
    out[j]   = mean(shift[j*D : (j+1)*D])        (averaging decimator)

Commuting the NCO in front of the filter gives a phase-corrected kernel, and
the boxcar folds into it: ``g = full_conv(k[i] exp(-i w (N-1-i)), ones(D)/D)``
(``fused_baseband_taps``).  Commuting the NCO on to the decimated side gives

    out[j] = exp(-i w D j) * sum_i g2[i] * x[j*D + offset - (T-1) + i]

with ``g2[i] = g[i] exp(-i w (i - (T-1) + offset))``: one strided
convolution over the raw input and an NCO at the output rate.  Where the
next stage is rotation-invariant (AMDemod) or folds the rotation into its
conjugate product (quadrature FMDemod), the fusion pass sets ``fold_nco``
and the NCO is left out (``core/fuse.py``).

:class:`BaseBand` is the real-input variant: the real stream is made
complex first.
"""

from __future__ import annotations

import numpy as np

from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.graph import Pipeline
from libsdr_tpu_torch.core.stream import ConfigError, StreamSpec
from libsdr_tpu_torch.ops import firdesign
from libsdr_tpu_torch.ops.fir import FIRFilter
from libsdr_tpu_torch.ops.nco import FreqShift
from libsdr_tpu_torch.ops.utils import ToComplex


def fused_baseband_taps(kernel: np.ndarray, fc: float, fs: float,
                        decim: int) -> np.ndarray:
    """Fold the post-filter NCO phase and the boxcar decimator into the
    band-pass kernel (see module docstring)."""
    n = kernel.shape[0]
    i = np.arange(n)
    w = 2 * np.pi * fc / fs
    kp = kernel.astype(np.complex128) * np.exp(-1j * w * (n - 1 - i))
    if decim > 1:
        box = np.full(decim, 1.0 / decim)
        kp = np.convolve(kp, box, mode="full")
    return kp


def band_taps(bb: "IQBaseBand", fs: float) -> np.ndarray:
    """The band-pass kernel of ``bb`` at input rate ``fs``."""
    if bb.design == "ref":
        return firdesign.ref_complex_bandpass(bb.order, bb.ff, bb.width, fs)
    return firdesign.complex_bandpass(bb.order, bb.ff, bb.width, fs)


class IQBaseBand(Processor):
    """Select a band around Fc from a complex IQ stream, shift it to DC and
    decimate.

    Args:
      fc: center frequency to shift to DC.
      ff: band-pass filter center (defaults to fc).
      width: filter bandwidth in Hz.
      order: FIR order N.
      decim: integer decimation D; mutually exclusive with ``out_rate``.
      out_rate: target output rate; D = floor(fs/out_rate).
      design: 'ref' (reference designer math, the default) or 'textbook'.
    """

    def __init__(self, fc: float, width: float, order: int, decim: int = 1,
                 ff: float = None, out_rate: float = None,
                 design: str = "ref"):
        super().__init__()
        self.fc = float(fc)
        self.ff = float(fc if ff is None else ff)
        self.width = float(width)
        self.order = max(1, int(order))
        self.decim = int(decim)
        self.out_rate = out_rate
        self.design = design
        # Set by the fusion pass (core/fuse.py) when the next stage needs no
        # output-rate NCO: the unrotated FIR output goes out as it is.
        self.fold_nco = False
        self._inner: Pipeline | None = None

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("IQBaseBand")
        fs = in_spec.rate_hz
        if self.out_rate is not None:
            self.decim = max(1, int(fs / self.out_rate))
        if self.decim < 1:
            raise ConfigError("IQBaseBand: decim must be >= 1")
        in_spec.require_block_multiple("IQBaseBand", self.decim)
        g = fused_baseband_taps(band_taps(self, fs), self.fc, fs, self.decim)
        t = len(g)
        w = 2 * np.pi * self.fc / fs
        offset = self.decim - 1  # FIRFilter's first-output offset
        g2 = g * np.exp(-1j * w * (np.arange(t) - (t - 1) + offset))
        # The output-rate NCO is FreqShift(fc) bound at fs/D.
        stages = [FIRFilter(order=t, kind="custom", taps=g2,
                            decim=self.decim)]
        if not self.fold_nco:
            stages.append(FreqShift(self.fc))
        self._inner = Pipeline(stages, name="IQBaseBand")
        return self._inner.bind(in_spec)

    def _init_carry(self, device):
        return self._inner.init_carry(device)

    def apply(self, carry, x):
        return self._inner.apply(carry, x)


class BaseBand(IQBaseBand):
    """Real-input variant: band-pass filter a real stream, shift the band
    at Fc down to DC and decimate; the output is complex baseband."""

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_real("BaseBand")
        to_complex = ToComplex()
        super()._bind(to_complex.bind(in_spec))
        self._inner = Pipeline([to_complex] + self._inner.stages,
                               name="BaseBand")
        return self._inner.bind(in_spec)
