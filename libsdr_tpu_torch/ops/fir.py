"""Streaming FIR filtering via overlap-save (counterpart of
``libsdr_tpu.ops.fir``).

The filter keeps the last ``T-1`` input samples as an explicit ``tail``
carry; each block is one batched correlation
``y[n] = sum_i k[i] * xc[n+i]`` over ``xc = concat(tail, x)``, so ``k[T-1]``
multiplies the newest sample.  The zero initial tail is a zero-initialized
ring buffer.  Complex streams are planar; complex taps on a complex stream
run as one 2-in, 2-out channel convolution.

A complex block on a CUDA device, decimated (stride > 1), goes through a
hand-written FIR kernel instead, one launch per block that reads the tail
itself: with the standard offset ``stride - 1`` the exact-tiling kernel
(``ops/fir_fm.fir_exact``, K1b), with any other offset the v1 kernel in its
overlap-save form (``ops/fir_mxu.fir_offset``, K5) where its gate holds.
Every other shape, real streams, stride 1 and every CPU block run the plain
batched correlation here.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import ConfigError, StreamSpec
from libsdr_tpu_torch.ops import firdesign


@contextlib.contextmanager
def full_f32():
    """Full float32 convolutions and matmuls on the card: cuDNN runs float32
    convolutions in TF32 (about three decimal digits) unless told not to."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _taps_planes(k, dtype, device):
    """Taps as (re, im) tensors; im is None for real taps."""
    if isinstance(k, Complex):
        return k.re.to(device, dtype), k.im.to(device, dtype)
    if isinstance(k, torch.Tensor):
        return k.to(device, dtype), None
    k = np.asarray(k)
    re = torch.as_tensor(np.ascontiguousarray(k.real), dtype=dtype,
                         device=device)
    if not np.iscomplexobj(k):
        return re, None
    return re, torch.as_tensor(np.ascontiguousarray(k.imag), dtype=dtype,
                               device=device)


def _conv1d(x, k, stride: int = 1):
    """Cross-correlation ``y[..., j] = sum_i k[i] x[..., j*stride + i]`` for
    any real/planar-complex combination of x and k (numpy taps or a Complex
    of tap tensors).  Runs in the input plane dtype."""
    x_c = isinstance(x, Complex)
    ref = x.re if x_c else x
    kr, ki = _taps_planes(k, ref.dtype, ref.device)
    if x_c and ki is None:
        # Real taps on a complex stream: one convolution per plane.
        return Complex(_conv1d(x.re, kr, stride), _conv1d(x.im, kr, stride))
    if ki is None:
        planes, w = [x], kr.reshape(1, 1, -1)
    elif not x_c:
        planes, w = [x], torch.stack([kr, ki]).unsqueeze(1)   # (2, 1, T)
    else:
        planes = [x.re, x.im]
        w = torch.stack([torch.stack([kr, -ki]),
                         torch.stack([ki, kr])])              # (2, 2, T)
    lead, n = ref.shape[:-1], ref.shape[-1]
    xb = torch.stack(planes, dim=-2).reshape(-1, len(planes), n)
    with full_f32():
        y = F.conv1d(xb, w, stride=stride)
    y = y.reshape(lead + (w.shape[0], y.shape[-1]))
    if ki is None:
        return y[..., 0, :]
    return Complex(y[..., 0, :], y[..., 1, :])


def _n_taps(taps) -> int:
    """T of numpy taps, a tap tensor or a Complex of tap planes."""
    if isinstance(taps, Complex):
        return taps.re.shape[-1]
    if isinstance(taps, torch.Tensor):
        return taps.shape[-1]
    return int(np.asarray(taps).shape[0])


def fir_overlap_save(taps, x, tail, stride: int = 1, offset: int = 0):
    """One overlap-save FIR block step.

    Args:
      taps: (T,) filter taps (numpy real or complex, or their tensors on
        x's device).
      x: (..., B) input block (real tensor or planar Complex).
      tail: (..., T-1) last samples of the previous block (zeros initially).
      stride: output decimation.
      offset: index of the first input sample that produces an output.

    Returns:
      (y, new_tail): y has trailing length ``(B - offset - 1)//stride + 1``;
      new_tail is the last T-1 samples of ``concat(tail, x)``.
    """
    t = _n_taps(taps)
    if t <= 1:
        return _conv1d(x[..., offset:], taps, stride), tail
    if (isinstance(x, Complex) and x.re.device.type == "cuda"
            and stride > 1):
        from libsdr_tpu_torch.ops.fir_mxu import fir_offset_supported
        if offset == stride - 1 or fir_offset_supported(
                t, stride, offset, x.re.shape[-1], x.re.dtype):
            return _fir_kernel_block(taps, x, tail, stride, offset, t)
    xc = cplx.concatenate([tail, x], axis=-1)
    y = _conv1d(xc[..., offset:], taps, stride)
    return y, xc[..., xc.shape[-1] - (t - 1):]


def new_tail(x, tail, t: int):
    """The last t-1 samples of concat(tail, x), as a copy: a view of x would
    keep the whole block alive."""
    b = x.shape[-1]
    if b >= t - 1:
        return x[..., b - (t - 1):].map(torch.clone)
    xc = cplx.concatenate([tail.to(x.re.dtype), x], axis=-1)
    return xc[..., xc.shape[-1] - (t - 1):]


def _fir_kernel_block(taps, x: Complex, tail: Complex, stride: int,
                      offset: int, t: int):
    """fir_overlap_save through a FIR kernel (K1b at offset stride - 1,
    else K5): the leading channel axes flattened to one, and complex
    taps."""
    from libsdr_tpu_torch.ops import fir_fm, fir_mxu

    lead, b = x.re.shape[:-1], x.re.shape[-1]
    kr, ki = _taps_planes(taps, torch.float32, x.re.device)
    g = Complex(kr, torch.zeros_like(kr) if ki is None else ki)
    c = int(np.prod(lead, dtype=np.int64))
    # a channel group sliced from a bank is a strided view: the kernels
    # read contiguous planes
    xk = x.reshape(c, b).map(torch.Tensor.contiguous)
    tk = tail.reshape(c, t - 1)
    if offset == stride - 1:
        y = fir_fm.fir_exact(xk, g, stride, tk)
    else:
        y = fir_mxu.fir_offset(xk, g, stride, offset, tk)
    return y.reshape(lead + (y.re.shape[-1],)), new_tail(x, tail, t)


_PRECISION = "high"


def set_mxu_precision(mode: str) -> None:
    """Select the FIR kernels' arithmetic, as the JAX package's
    ``set_mxu_precision`` does: 'high' (the default) is float32-accurate;
    'fast' makes the tensor-core route (``csrc/fir_tc.cu``: mode fm of
    ``fir_fm_exact``, ``fir_fm_mxu``) run one bf16 pass, the TPU kernels'
    'x1'.  The staged and warp kernels, and every plain version, compute in
    float32 either way."""
    global _PRECISION
    if mode not in ("high", "fast"):
        raise ConfigError(f"set_mxu_precision: unknown mode {mode!r} "
                          "(use 'high' or 'fast')")
    _PRECISION = mode


def mxu_precision() -> str:
    """The mode last set by :func:`set_mxu_precision`."""
    return _PRECISION


class FIRFilter(Processor):
    """Streaming FIR filter node.

    Args:
      order: number of taps.
      kind: 'lowpass' | 'highpass' | 'bandpass' | 'bandstop' | 'custom'.
      fl, fu: band edges in Hz (lowpass uses fu, highpass uses fl).
      taps: explicit taps for kind='custom'.
      design: 'textbook' (default) or 'ref' (reference designer math; only
        lowpass).
      decim: integer output decimation (keep one in D after filtering).
      enabled: bypass flag.
    """

    def __init__(self, order: int, kind: str = "lowpass", fl: float = 0.0,
                 fu: float = 0.0, taps: Optional[Sequence] = None,
                 design: str = "textbook", decim: int = 1,
                 enabled: bool = True):
        super().__init__()
        self.order = max(1, int(order))
        self.kind = kind
        self.fl, self.fu = float(fl), float(fu)
        self.design = design
        self.decim = int(decim)
        self.enabled = enabled
        self._custom_taps = None if taps is None else np.asarray(taps)
        self.taps: Optional[np.ndarray] = None
        self._taps_dev = {}

    def _design_taps(self, fs: float) -> np.ndarray:
        if self.kind == "custom":
            return self._custom_taps
        if self.design == "ref":
            if self.kind != "lowpass":
                raise ConfigError(
                    "the reference-parity designer exists only for lowpass")
            return firdesign.ref_lowpass(self.order, self.fu, fs)
        d = {
            "lowpass": lambda: firdesign.lowpass(self.order, self.fu, fs),
            "highpass": lambda: firdesign.highpass(self.order, self.fl, fs),
            "bandpass": lambda: firdesign.bandpass(self.order, self.fl,
                                                   self.fu, fs),
            "bandstop": lambda: firdesign.bandstop(self.order, self.fl,
                                                   self.fu, fs),
        }
        if self.kind not in d:
            raise ConfigError(f"Unknown FIR kind {self.kind!r}")
        return d[self.kind]()

    def _redesign(self) -> None:
        """New taps for the bound rate; the device copies are made anew."""
        if self.is_bound:
            self.taps = np.asarray(self._design_taps(self.in_spec.rate_hz))
            self._taps_dev = {}

    def set_freq(self, fl: float = None, fu: float = None) -> None:
        """Retune the band edges.  The next :meth:`apply` filters with the
        new taps; the carry keeps its shape."""
        if self.kind == "custom":
            raise ConfigError("set_freq: a custom-taps filter has no "
                              "designer to retune")
        if fl is not None:
            self.fl = float(fl)
        if fu is not None:
            self.fu = float(fu)
        self._redesign()

    def set_order(self, order: int) -> None:
        """Change the tap count.  The carry tail changes length with it, so
        call :meth:`init_carry` again afterwards."""
        if self.kind == "custom":
            raise ConfigError("set_order: a custom-taps filter has no "
                              "designer to re-run")
        self.order = max(1, int(order))
        self._redesign()

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        if self.decim > 1:
            in_spec.require_block_multiple("FIRFilter", self.decim)
        self.taps = np.asarray(self._design_taps(in_spec.rate_hz))
        self._taps_dev = {}
        out_dtype = in_spec.dtype
        if np.iscomplexobj(self.taps) and not in_spec.is_complex:
            out_dtype = torch.complex64
        # Narrow input planes (bf16) do not propagate: the output is
        # normalized to the full dtype.
        return in_spec.with_(
            dtype=out_dtype,
            plane_dtype=None,
            sample_rate=in_spec.sample_rate / self.decim,
            block_size=in_spec.block_size // self.decim)

    def _taps_on(self, x):
        """The taps for block x: numpy on the CPU; on a card, float32 planes
        made once per device (no host-to-device copy per block)."""
        dev = (x.re if isinstance(x, Complex) else x).device
        if dev.type == "cpu":
            return self.taps
        if dev not in self._taps_dev:
            self._taps_dev[dev] = cplx.constant(self.taps, torch.float32,
                                                dev)
        return self._taps_dev[dev]

    def _init_carry(self, device):
        t = self.taps.shape[0]
        shape = self.in_spec.channels + (t - 1,)
        if self.in_spec.is_complex:
            return cplx.zeros(shape, self.in_spec.real_dtype, device)
        return torch.zeros(shape, dtype=self.in_spec.dtype, device=device)

    def apply(self, carry, x):
        if not self.enabled:
            return carry, x
        y, tail = fir_overlap_save(
            self._taps_on(x), x, carry, stride=self.decim,
            offset=self.decim - 1)
        want = self.out_spec.real_dtype
        if isinstance(y, Complex):
            if y.re.dtype != want:
                y = y.to(want)
        elif y.dtype != want and y.dtype.is_floating_point:
            y = y.to(want)
        return tail, y
