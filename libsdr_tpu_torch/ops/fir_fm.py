"""Fused decimating FIR + quadrature FM discriminator (+ de-emphasis): the
counterpart of ``libsdr_tpu.ops.pallas_fir_mxu.fir_fm_exact`` in mode 'fm'.

For a block x (C, B) of planar IQ, the (C, T-1) carry ``tail`` and complex
taps g (T,), with ``xc = concat(tail, x)``:

    y[j]   = sum_i g[i] * xc[j*D + D-1 + i]      (window ends at x[(j+1)D-1])
    audio  = gain * atan2_poly(y[j] * conj(y[j-1]) * rot),  y[-1] = prev
    out[j] = a*out[j-1] + b*audio[j]             (if deemph_ab; out[-1] = dstate)

:func:`fir_fm_exact` dispatches on the device of its input: a CPU tensor
takes the plain PyTorch version :func:`fir_fm_exact_plain`; a CUDA tensor
launches the hand-written kernel ``csrc/fir_fm_exact.cu`` or raises.

Each channel's B/D outputs are cut into K chunks of at least 4096 outputs,
K as large as the card's resident block slots allow in one wave, and each
chunk is one block of the kernel.  The de-emphasis state crosses chunk
edges through two small follow-up kernels: a per-channel scan of the
chunk-end values and a fix-up of each later chunk's head.

The kernel's shape gate.  The kernel takes any C with C*K < 2^31, any
T >= 1, any D >= 1 and any B that is a multiple of D, with one limit: a
block of 256 threads stages one segment of 256*R outputs (R = 4, 2 or 1,
the largest that fits) in shared memory, polyphase with one pad slot after
every R samples (none for R = 1), which takes about

    8*D*ceil(T/D) + 2*D*Q*(1 + 1/R)*itemsize + 144   bytes,
    Q = 256*R + (T-1)//D,

itemsize 4 for float32 planes and 2 for bfloat16.  With R = 1 this must
fit in the card's opt-in shared memory per block (232,448 bytes on an
H100), so roughly 256*D + 2*T <= 29,000 for float32 planes.  The bench
configuration (T = 67, D = 4) runs at R = 4 in 42 KB.  A shape outside the
gate raises ``ValueError``; the plain version takes every shape.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops.fir import _conv1d, full_f32
from libsdr_tpu_torch.ops.iir import iir_first_order

_PLANE_DTYPES = (torch.float32, torch.bfloat16)


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Full-quadrant atan2 from an odd minimax polynomial, |err| < 2e-5 rad
    (the polynomial of the TPU kernel and of the CUDA kernel)."""
    ax, ay = x.abs(), y.abs()
    mx, mn = torch.maximum(ax, ay), torch.minimum(ax, ay)
    t = mn / mx.clamp_min(1e-30)
    s = t * t
    p = torch.full_like(t, -0.0117212)
    for c in (0.05265332, -0.11643287, 0.19354346, -0.33262347, 0.99997726):
        p = p * s + c
    r = t * p
    r = torch.where(ay > ax, np.float32(np.pi / 2) - r, r)
    r = torch.where(x < 0, np.float32(np.pi) - r, r)
    return torch.where(y < 0, -r, r)


def fir_fm_exact_plain(x: Complex, taps: Complex, stride: int,
                       tail: Complex, prev: Complex, rot: complex,
                       gain: float, deemph_ab=None, dstate=None):
    """Plain PyTorch version of :func:`fir_fm_exact` (same arguments and
    results), in float32."""
    d = int(stride)
    # The tail is stored in the plane dtype (it is a slice of the input).
    xc = Complex(torch.cat([tail.re.to(x.re.dtype), x.re], -1).float(),
                 torch.cat([tail.im.to(x.im.dtype), x.im], -1).float())
    y = _conv1d(xc[..., d - 1:], taps, d)
    yp = Complex(torch.cat([prev.re[..., None].float(), y.re[..., :-1]], -1),
                 torch.cat([prev.im[..., None].float(), y.im[..., :-1]], -1))
    zr = y.re * yp.re + y.im * yp.im
    zi = y.im * yp.re - y.re * yp.im
    rot = complex(rot)
    zr2 = zr * rot.real - zi * rot.imag
    zi2 = zr * rot.imag + zi * rot.real
    out = float(gain) * atan2_poly(zi2, zr2)
    if deemph_ab is not None:
        with full_f32():
            out, _ = iir_first_order(out, deemph_ab[0], deemph_ab[1],
                                     dstate.float())
    return out, y[..., -1]


def fir_fm_exact(x: Complex, taps: Complex, stride: int, tail: Complex,
                 prev: Complex, rot: complex, gain: float, deemph_ab=None,
                 dstate=None):
    """Fused FIR + FM discriminator (+ de-emphasis) over one block.

    Args:
      x: Complex (C, B) planes, float32 or bfloat16, B a multiple of stride.
      taps: Complex (T,) float32 taps g on x's device.
      stride: decimation D.
      tail: Complex (C, T-1), the last T-1 input samples before x.
      prev: Complex (C,) float32, y[-1].
      rot: complex rotation folded into the discriminator.
      gain: audio scale.
      deemph_ab: (a, b) of the de-emphasis, or None.
      dstate: (C,) float32 de-emphasis state out[-1] (with deemph_ab).

    Returns:
      (out (C, B/D) float32, y_last Complex (C,) float32).
    """
    dev = x.re.device
    if dev.type == "cpu":
        return fir_fm_exact_plain(x, taps, stride, tail, prev, rot, gain,
                                  deemph_ab, dstate)
    if dev.type != "cuda":
        raise ValueError(f"fir_fm_exact: no kernel for device {dev}")
    return _launch(x, taps, int(stride), tail, prev, complex(rot),
                   float(gain), deemph_ab, dstate)


fir_fm_exact.launches = 0  # kernel launches, counted where they happen


def _launch(x, taps, d, tail, prev, rot, gain, deemph_ab, dstate):
    from libsdr_tpu_torch import _build

    xr, xi = x.re, x.im
    if xr.dtype not in _PLANE_DTYPES or xi.dtype != xr.dtype:
        raise ValueError(f"fir_fm_exact: planes must be float32 or "
                         f"bfloat16, got {xr.dtype}/{xi.dtype}")
    if xr.ndim != 2 or xi.shape != xr.shape:
        raise ValueError(f"fir_fm_exact: planes must be (C, B), got "
                         f"{tuple(xr.shape)}")
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError("fir_fm_exact: planes must be contiguous")
    dev = xr.device
    c, b = xr.shape
    t = taps.re.shape[-1]
    if d < 1 or b % d or b < d:
        raise ValueError(f"fir_fm_exact: block {b} must be a positive "
                         f"multiple of the stride {d}")

    def small(v, dtype, shape):
        v = v.to(dev, dtype).contiguous()
        if tuple(v.shape) != shape:
            raise ValueError(f"fir_fm_exact: carry shape {tuple(v.shape)}, "
                             f"expected {shape}")
        return v

    tr = small(tail.re, xr.dtype, (c, t - 1))
    ti = small(tail.im, xr.dtype, (c, t - 1))
    gr = small(taps.re, torch.float32, (t,))
    gi = small(taps.im, torch.float32, (t,))
    pr = small(prev.re, torch.float32, (c,))
    pi = small(prev.im, torch.float32, (c,))
    a, bc = (0.0, 0.0) if deemph_ab is None else map(float, deemph_ab)
    ds = None if deemph_ab is None else small(dstate, torch.float32, (c,))
    lib = _build.library()
    bf16 = int(xr.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        k = lib.sdr_fir_fm_exact_chunks(c, b, t, d, bf16)
    if k == -1:
        raise ValueError(f"fir_fm_exact: shape outside the kernel's gate "
                         f"(C={c}, B={b}, T={t}, D={d}, {xr.dtype}); see "
                         f"the module docstring")
    if k < -1:
        msg = lib.sdr_cuda_error_string(-2 - k).decode()
        raise RuntimeError(f"fir_fm_exact: device query failed: {msg}")
    ends = (torch.empty((c, k), dtype=torch.float32, device=dev)
            if k > 1 and deemph_ab is not None else None)
    out = torch.empty((c, b // d), dtype=torch.float32, device=dev)
    ylr = torch.empty((c,), dtype=torch.float32, device=dev)
    yli = torch.empty((c,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_fir_fm_exact(
            xr.data_ptr(), xi.data_ptr(), tr.data_ptr(), ti.data_ptr(),
            gr.data_ptr(), gi.data_ptr(), pr.data_ptr(), pi.data_ptr(),
            None if ds is None else ds.data_ptr(),
            out.data_ptr(), ylr.data_ptr(), yli.data_ptr(),
            None if ends is None else ends.data_ptr(),
            c, b, t, d, k, rot.real, rot.imag, gain, a, bc,
            int(deemph_ab is not None), bf16, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.sdr_cuda_error_string(rc).decode()
        raise RuntimeError(f"fir_fm_exact: kernel launch failed: {msg}")
    fir_fm_exact.launches += 1
    return out, Complex(ylr, yli)
