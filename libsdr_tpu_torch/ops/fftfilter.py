"""FFT fast-convolution filter bank (counterpart of
``libsdr_tpu.ops.fftfilter``): overlap-add filtering of N selectable bands
that share one forward FFT.

Each block of B samples is zero-padded to 2B and transformed once; every
band multiplies the spectrum with the FFT of its zero-padded band kernel,
inverse-transforms, and overlap-adds the halves.  The band dimension is a
batch axis of ``ops/fft.py``'s transform (``torch.fft``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.stream import StreamSpec
from libsdr_tpu_torch.ops.fft import fft


def ref_band_kernel(block_size: int, fmin: float, fmax: float,
                    fs: float) -> np.ndarray:
    """The reference's band kernel: a windowed sinc evaluated over B points,
    zero-padded to 2B, FFT'd and L2-normalized."""
    n = block_size
    fmin = max(fmin, -fs / 2)
    fmax = min(fmax, fs / 2)
    bw = fmax - fmin
    fc = fmin + bw / 2
    i = np.arange(n)
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.sin(np.pi * (bw / fs) * (i - n // 2)) / (i - n // 2)
    v[i == n // 2] = np.pi * bw / fs
    v = v.astype(np.complex128)
    v *= np.exp(2j * np.pi * fc * i / fs)
    v *= (0.42 - 0.5 * np.cos(2 * np.pi * i / n)
          + 0.08 * np.cos(4 * np.pi * i / n))
    kern = np.concatenate([v, np.zeros(n, np.complex128)])
    kf = np.fft.fft(kern)
    return kf / np.linalg.norm(kf)


class FFTFilterBank(Processor):
    """Overlap-add FFT filter bank.

    Args:
      bands: list of (fmin, fmax) tuples, one output band each.

    Input (..., B) complex; output (..., n_bands, B) complex at the same
    rate, one band per slot.  Carry: the saved second half of each band's
    previous inverse transform.
    """

    def __init__(self, bands: Sequence[Tuple[float, float]]):
        super().__init__()
        self.bands: List[Tuple[float, float]] = [
            (min(f), max(f)) for f in bands]
        if not self.bands:
            raise ValueError("FFTFilterBank needs at least one band")

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("FFTFilterBank")
        self._make_kernels(in_spec)
        return in_spec.with_(channels=in_spec.channels + (len(self.bands),),
                             plane_dtype=None)

    def _make_kernels(self, in_spec: StreamSpec) -> None:
        b = in_spec.block_size
        fs = in_spec.rate_hz
        self._kern_np = np.stack([ref_band_kernel(b, lo, hi, fs)
                                  for lo, hi in self.bands])  # (n_bands, 2B)
        self._kern = {}

    def set_band(self, idx: int, lo: float, hi: float) -> None:
        """Retune band ``idx``; the next ``apply`` uses the new band."""
        self.bands[idx] = (min(lo, hi), max(lo, hi))
        if self.is_bound:
            self._make_kernels(self.in_spec)

    def _init_carry(self, device):
        b = self.in_spec.block_size
        shape = self.in_spec.channels + (len(self.bands), b)
        return cplx.zeros(shape, torch.float32, device)

    def apply(self, carry, x):
        b = self.in_spec.block_size
        dev = x.re.device
        key = str(dev)
        if key not in self._kern:
            self._kern[key] = cplx.constant(self._kern_np, torch.float32, dev)
        # the zero-padded forward FFT shared by all bands
        xp = cplx.concatenate(
            [x.to(torch.float32),
             cplx.zeros(tuple(x.shape[:-1]) + (b,), torch.float32, dev)],
            axis=-1)
        spec = fft(xp)                                  # (..., 2B)
        prod = spec.map(lambda a: a[..., None, :]) * self._kern[key]
        y = fft(prod, inverse=True)                     # (..., n_bands, 2B)
        out = carry + y[..., :b]
        new_carry = y[..., b:]
        return new_carry, out
