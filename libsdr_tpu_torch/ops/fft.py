"""FFT over planar complex tensors (counterpart of ``libsdr_tpu.ops.fft``).

The JAX package builds its FFT from MXU matmuls (a mixed-radix four-step
factorization), a TPU workaround outside any Pallas kernel; here the
transform is ``torch.fft`` (pocketfft on the CPU, cuFFT on a card) with the
same conventions: the forward transform is unscaled, the inverse applies
1/n (numpy's).  :func:`fft_np` and :func:`fft_f64` are the JAX package's
host paths, copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from libsdr_tpu_torch.core.cplx import Complex

_MAX_DIRECT = 512


def fft(x, inverse: bool = False) -> Complex:
    """FFT along the trailing axis of a planar complex tensor (a real
    tensor is taken as the real plane).  Forward is unscaled; inverse
    applies the 1/n factor.  Computed in float32 (bfloat16 planes are
    widened)."""
    if not isinstance(x, Complex):
        x = Complex(x.float(), torch.zeros_like(x, dtype=torch.float32))
    z = torch.complex(x.re.float(), x.im.float())
    y = torch.fft.ifft(z) if inverse else torch.fft.fft(z)
    return Complex(y.real.contiguous(), y.imag.contiguous())


def fft_np(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Host-side reference path (numpy) with the same conventions."""
    return np.fft.ifft(x) if inverse else np.fft.fft(x)


def _factorize(n: int) -> Tuple[int, int]:
    """Split n = n1*n2 with both factors as close to sqrt(n) as possible."""
    best = (1, n)
    for n1 in range(int(np.sqrt(n)), 0, -1):
        if n % n1 == 0:
            best = (n1, n // n1)
            break
    return best


def fft_f64(x, inverse: bool = False) -> np.ndarray:
    """Double-precision transform on the host, with the unscaled-forward /
    1/n-inverse convention, by the mixed-radix matmul factorization.

    Accepts numpy complex arrays or planar :class:`Complex`; returns numpy
    complex128.
    """
    if isinstance(x, Complex):
        x = (x.re.double().cpu().numpy()
             + 1j * x.im.double().cpu().numpy())
    x = np.asarray(x, np.complex128)
    n = x.shape[-1]

    def rec(a):
        m = a.shape[-1]
        if m <= _MAX_DIRECT:
            j = np.arange(m)
            w = np.exp(-2j * np.pi * np.outer(j, j) / m)
            return a @ w
        n1, n2 = _factorize(m)
        if n1 == 1:
            j = np.arange(m)
            return a @ np.exp(-2j * np.pi * np.outer(j, j) / m)
        lead = a.shape[:-1]
        b = rec(np.swapaxes(a.reshape(lead + (n2, n1)), -1, -2))
        tw = np.exp(-2j * np.pi
                    * np.outer(np.arange(n1), np.arange(n2)) / m)
        d = rec(np.swapaxes(b * tw, -1, -2))
        return np.swapaxes(d, -1, -2).reshape(lead + (m,))

    if inverse:
        return np.conj(rec(np.conj(x))) / n
    return rec(x)
