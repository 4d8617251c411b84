"""The fused polyphase channelizer (+ FM discriminator bank): the
counterpart of ``libsdr_tpu.ops.pallas_pfb``.

For x (..., F, M) planar frames of a wideband block, the carried frames
hist (..., P, M) and the folded taps taps3 (P+1, M)
(``ops/channelizer.py::fold_commutator``), with X[t] = x[t] for t >= 0 and
hist[P + t] for -P <= t < 0:

    u[t, q]   = sum_{k=0..P} taps3[k, q] * X[t - k, q]
    Y[t, ch]  = sum_q u[t, q] * exp(-2 pi i q ch / M)

and the demod variant ``audio[t] = gain * atan2_poly(Y[t] * conj(Y[t-1]))``
with Y[-1] = prev, exporting Y[F-1] and Y[0].  The output is time-major
with channel ch on lane ``lane_of_channel(M)[ch]``, the JAX kernel's
layout.

:func:`pfb_mxu` dispatches on the device of its input: a CPU tensor takes
:func:`pfb_plain` (the MAC in PyTorch, ``ops/fft.py``, the lane permutation
and the discriminator); a CUDA tensor launches the kernel K4 of
``csrc/pfb.cu`` or raises.  It counts its launches in ``pfb_mxu.launches``.

The kernel's gate (:func:`pfb_supported`): float32 or bfloat16 planes, any
leading stream axes and any F >= 1 (also F < P), 1 <= M <= 8192 (an FFT for
M = a 2^k with a in {1, 3, 5, 7}, a direct DFT for any other M) and
1 <= P <= 32.  The JAX kernel took M = 128 n2 with n2 <= 8 and F >= P on a
single stream.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops.fft import fft
from libsdr_tpu_torch.ops.fir_fm import _check, _plain, _small, atan2_poly

_LANES = 128
MAX_CHANNELS = 8192
MAX_TAPS_PER_BRANCH = 32
_PLANE_DTYPES = (torch.float32, torch.bfloat16)


def lane_of_channel(m: int) -> np.ndarray:
    """perm[c] = output lane carrying channel c (center freq c*fs/M): lane
    ``128 (c mod n2) + c // n2`` for M = 128 n2 with n2 > 1, else the
    identity."""
    if m <= _LANES or m % _LANES:
        return np.arange(m)
    n2 = m // _LANES
    c = np.arange(m)
    return _LANES * (c % n2) + c // n2


def channel_of_lane(m: int) -> np.ndarray:
    """The inverse map: chan[L] = channel index on output lane L."""
    if m <= _LANES or m % _LANES:
        return np.arange(m)
    n2 = m // _LANES
    lane = np.arange(m)
    return n2 * (lane % _LANES) + lane // _LANES


def pfb_supported(m: int, f_total: int, p: int,
                  dtype=torch.float32) -> bool:
    """Whether the kernel takes this shape (both variants have one gate)."""
    return (dtype in _PLANE_DTYPES and 1 <= m <= MAX_CHANNELS
            and 1 <= p <= MAX_TAPS_PER_BRANCH and f_total >= 1)


def pfb_frames_plain(x: Complex, hist: Complex, taps3) -> Complex:
    """Y (..., F, M) float32 in channel order: the MAC over the frames
    (terms added k = 0..P in order, as the JAX channelizer adds them) and
    the DFT of each frame."""
    p = hist.re.shape[-2]
    f = x.re.shape[-2]
    taps3 = torch.as_tensor(taps3, dtype=torch.float32, device=x.re.device)
    histf = Complex(torch.cat([hist.re.float(), x.re.float()], dim=-2),
                    torch.cat([hist.im.float(), x.im.float()], dim=-2))
    acc = None
    for k in range(p + 1):
        seg = histf[..., p - k:p - k + f, :]
        term = seg * taps3[k]
        acc = term if acc is None else acc + term
    return fft(acc)


def fm_demod_lanes(y: Complex, prev: Complex, gain: float) -> torch.Tensor:
    """``gain * atan2_poly(y * conj(prev))`` elementwise: the kernel's
    demod epilogue, op for op."""
    zr = y.re * prev.re + y.im * prev.im
    zi = y.im * prev.re - y.re * prev.im
    return float(gain) * atan2_poly(zi, zr)


def pfb_plain(x: Complex, hist: Complex, taps3, m: int, gain: float = 1.0,
              prev: Complex = None, demod: bool = False, twiddles=None):
    """Plain PyTorch version of :func:`pfb_mxu` (same arguments and
    results; ``twiddles`` is the kernel's and unused here), in float32."""
    y = pfb_frames_plain(x, hist, taps3)
    chan = torch.as_tensor(channel_of_lane(m), device=x.re.device)
    y = Complex(y.re[..., chan], y.im[..., chan])
    if not demod:
        return y
    if prev is None:
        prev = _unit_prev(x, m)
    f = y.re.shape[-2]
    shifted = Complex(
        torch.cat([prev.re.float(), y.re[..., :f - 1, :]], dim=-2),
        torch.cat([prev.im.float(), y.im[..., :f - 1, :]], dim=-2))
    audio = fm_demod_lanes(y, shifted, gain)
    return audio, y[..., f - 1:f, :], y[..., 0:1, :]


def _unit_prev(x: Complex, m: int) -> Complex:
    lead = tuple(x.re.shape[:-2])
    return Complex(torch.ones(lead + (1, m), device=x.re.device),
                   torch.zeros(lead + (1, m), device=x.re.device))


def pfb_mxu(x: Complex, hist: Complex, taps3, m: int, gain: float = 1.0,
            prev: Complex = None, demod: bool = False, twiddles=None):
    """Fused PFB channelizer over framed wideband blocks.

    Args:
      x: Complex (..., F, M) frames, float32 or bfloat16 planes.
      hist: Complex (..., P, M), the carried last P raw frames.
      taps3: (P+1, M) folded-commutator taps (numpy or a float32 tensor).
      m: the channel count M.
      gain: the demod's audio gain.
      prev: Complex (..., 1, M) float32 Y[-1] per lane (demod; default
        the unit phasor).
      demod: False -> Complex (..., F, M) float32 channel samples; True ->
        (audio (..., F, M) float32, y_last Complex (..., 1, M), y_first
        Complex (..., 1, M)), the exports per lane.
      twiddles: the kernel's table, :func:`pfb_twiddles` on the input's
        device; made for the call when not given (an op that runs K4 every
        block keeps its own).

    Output lanes are channel-permuted: lane L carries channel
    ``channel_of_lane(m)[L]``; row t is frame t.
    """
    if _plain(x, "pfb_mxu"):
        return pfb_plain(x, hist, taps3, m, gain, prev, demod)
    return _launch(x, hist, taps3, m, gain, prev, demod, twiddles)


pfb_mxu.launches = 0


def pfb_twiddles(m: int, dev) -> tuple:
    """The kernel's table exp(-2 pi i j / M), j < M, as a pair of float32
    planes: computed in float64 on ``dev`` and rounded once."""
    ang = torch.arange(m, dtype=torch.float64, device=dev) * (-2 * np.pi / m)
    return torch.cos(ang).float(), torch.sin(ang).float()


def _launch(x, hist, taps3, m, gain, prev, demod, twiddles):
    """One launch of csrc/pfb.cu's sdr_pfb."""
    from libsdr_tpu_torch import _build

    name = "pfb_mxu"
    xr, xi = x.re, x.im
    if xr.dtype not in _PLANE_DTYPES or xi.dtype != xr.dtype:
        raise ValueError(f"{name}: planes must be float32 or bfloat16, got "
                         f"{xr.dtype}/{xi.dtype}")
    if xr.ndim < 2 or xi.shape != xr.shape or xr.shape[-1] != m:
        raise ValueError(f"{name}: planes must be (..., F, {m}), got "
                         f"{tuple(xr.shape)}")
    lead = tuple(xr.shape[:-2])
    f = xr.shape[-2]
    p = hist.re.shape[-2]
    c = int(np.prod(lead, dtype=np.int64))
    if not pfb_supported(m, f, p, xr.dtype) or c < 1:
        raise ValueError(
            f"{name}: shape outside the kernel's gate (C={c}, F={f}, M={m}, "
            f"P={p}, {xr.dtype}): 1 <= M <= {MAX_CHANNELS}, 1 <= P <= "
            f"{MAX_TAPS_PER_BRANCH}, F >= 1; see ops/pfb.py")
    dev = xr.device
    small = _small(name, dev)
    xr = xr.reshape(c, f, m).contiguous()
    xi = xi.reshape(c, f, m).contiguous()
    hr = small(hist.re.reshape(c, p, m), torch.float32, (c, p, m))
    hi = small(hist.im.reshape(c, p, m), torch.float32, (c, p, m))
    taps = small(torch.as_tensor(taps3), torch.float32, (p + 1, m))
    twr, twi = pfb_twiddles(m, dev) if twiddles is None else twiddles
    if twr.device != dev or twr.shape != (m,):
        raise ValueError(f"{name}: twiddles must be pfb_twiddles({m}) on "
                         f"{dev}")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    out_r = empty(c, f, m)
    out_i = pr = pi = ylr = yli = y0r = y0i = None
    if demod:
        if prev is None:
            prev = _unit_prev(x, m)
        pr = small(prev.re.reshape(c, m), torch.float32, (c, m))
        pi = small(prev.im.reshape(c, m), torch.float32, (c, m))
        ylr, yli, y0r, y0i = (empty(c, m) for _ in range(4))
    else:
        out_i = empty(c, f, m)

    def ptr(v):
        return None if v is None else v.data_ptr()

    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_pfb(xr.data_ptr(), xi.data_ptr(), hr.data_ptr(),
                         hi.data_ptr(), taps.data_ptr(), twr.data_ptr(),
                         twi.data_ptr(), ptr(pr), ptr(pi), out_r.data_ptr(),
                         ptr(out_i), ptr(ylr), ptr(yli), ptr(y0r), ptr(y0i),
                         c, f, m, p, float(gain), int(bool(demod)),
                         int(xr.dtype == torch.bfloat16),
                         ctypes.c_void_p(stream))
    _check(name, lib, rc)
    pfb_mxu.launches += 1
    if not demod:
        return Complex(out_r.reshape(lead + (f, m)),
                       out_i.reshape(lead + (f, m)))
    return (out_r.reshape(lead + (f, m)),
            Complex(ylr.reshape(lead + (1, m)), yli.reshape(lead + (1, m))),
            Complex(y0r.reshape(lead + (1, m)), y0i.reshape(lead + (1, m))))
