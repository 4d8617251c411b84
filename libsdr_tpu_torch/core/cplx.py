"""Planar complex tensors (counterpart of ``libsdr_tpu.core.cplx``).

Complex streams are a :class:`Complex` of two real tensors of one shape and
dtype.  Keeping them planar lets the kernels read bf16 planes and keeps every
carry in the same layout as the JAX package's, so states can be handed
across (``libsdr_tpu_torch.interop``).  Host boundaries use numpy
``complex64``; :func:`as_block` and :func:`to_numpy` convert at the edges.
Arithmetic accepts another :class:`Complex`, a real tensor or a Python
(complex) scalar.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Complex:
    """A complex tensor stored as two real planes of identical shape/dtype."""

    __slots__ = ("re", "im")

    def __init__(self, re: torch.Tensor, im: torch.Tensor):
        self.re = re
        self.im = im

    @property
    def shape(self):
        return self.re.shape

    @property
    def device(self) -> torch.device:
        return self.re.device

    @property
    def dtype(self) -> torch.dtype:
        """Logical complex dtype (complex64 for float32 or bfloat16 planes)."""
        return torch.promote_types(self.re.dtype, torch.complex64)

    @property
    def real_dtype(self) -> torch.dtype:
        return self.re.dtype

    def __add__(self, o):
        if isinstance(o, Complex):
            return Complex(self.re + o.re, self.im + o.im)
        if isinstance(o, complex):
            return Complex(self.re + o.real, self.im + o.imag)
        return Complex(self.re + o, self.im)

    __radd__ = __add__

    def __mul__(self, o):
        if isinstance(o, Complex):
            return Complex(self.re * o.re - self.im * o.im,
                           self.re * o.im + self.im * o.re)
        if isinstance(o, complex):
            return Complex(self.re * o.real - self.im * o.imag,
                           self.re * o.imag + self.im * o.real)
        return Complex(self.re * o, self.im * o)

    __rmul__ = __mul__

    def conj(self) -> "Complex":
        return Complex(self.re, -self.im)

    def abs(self) -> torch.Tensor:
        return torch.sqrt(self.re * self.re + self.im * self.im)

    def angle(self) -> torch.Tensor:
        return torch.atan2(self.im, self.re)

    def map(self, fn) -> "Complex":
        """Apply a linear tensor function to both planes."""
        return Complex(fn(self.re), fn(self.im))

    def __getitem__(self, idx) -> "Complex":
        return Complex(self.re[idx], self.im[idx])

    def reshape(self, *shape) -> "Complex":
        return self.map(lambda a: a.reshape(*shape))

    def to(self, *args, **kw) -> "Complex":
        """``Tensor.to`` on both planes (device and/or plane dtype)."""
        return self.map(lambda a: a.to(*args, **kw))

    def __repr__(self):
        return f"Complex(shape={tuple(self.shape)}, dtype={self.re.dtype})"


def zeros(shape, real_dtype=torch.float32, device=None) -> Complex:
    return Complex(torch.zeros(shape, dtype=real_dtype, device=device),
                   torch.zeros(shape, dtype=real_dtype, device=device))


def full_like_phasor(shape, real_dtype=torch.float32, device=None) -> Complex:
    """Unit phasor 1+0j of the given shape."""
    return Complex(torch.ones(shape, dtype=real_dtype, device=device),
                   torch.zeros(shape, dtype=real_dtype, device=device))


def concatenate(xs: Sequence, axis: int = -1):
    if isinstance(xs[0], Complex):
        return Complex(torch.cat([x.re for x in xs], dim=axis),
                       torch.cat([x.im for x in xs], dim=axis))
    return torch.cat(list(xs), dim=axis)


def constant(value, real_dtype=torch.float32, device=None):
    """Tensor constant from a numpy value: planar if the value is complex."""
    value = np.asarray(value)
    if np.iscomplexobj(value):
        return Complex(torch.tensor(value.real, dtype=real_dtype,
                                    device=device),
                       torch.tensor(value.imag, dtype=real_dtype,
                                    device=device))
    return torch.tensor(value, dtype=real_dtype, device=device)


def as_block(x, real_dtype=torch.float32, device=None):
    """Host block to the device representation: numpy complex becomes a
    planar :class:`Complex` of ``real_dtype`` planes, real numpy arrays a
    tensor; tensors and Complex move to ``device`` if one is given."""
    if isinstance(x, (Complex, torch.Tensor)):
        return x if device is None else x.to(device)
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return constant(x, real_dtype, device)
    return torch.as_tensor(x, device=device)


def to_numpy(x) -> np.ndarray:
    """Complex (or real tensor) to numpy; planar becomes numpy complex."""
    if isinstance(x, Complex):
        re, im = _host(x.re), _host(x.im)
        return (re + 1j * im).astype(np.result_type(re.dtype, np.complex64))
    return _host(x)


def _host(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: widen (exactly) to float32.
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()
