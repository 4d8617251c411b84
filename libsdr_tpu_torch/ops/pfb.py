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
``csrc/pfb.cu`` or raises.  It counts its launches in ``pfb_mxu.launches``
and by route in ``pfb_mxu.routes``: ``stream`` for M in {16, 64, 256,
1024} with P = 8 (:func:`stream_route`; every path's shape), ``generic``
for any other shape.  The shape alone decides, in C (``sdr_pfb`` reports
the route it took; ``sdr_pfb_route`` is the same gate).

:func:`pfb_split` emulates the stream route's decomposition on the CPU (the
tile split with its halo and recomputed frame, the N x N register FFT with
the kernel's constants and twiddle table, the lane-permuted store); the
tests hold it against :func:`pfb_plain` and the JAX kernel.  Nothing on a
path calls it.

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
from libsdr_tpu_torch.utils.profiling import spanned

_LANES = 128
MAX_CHANNELS = 8192
MAX_TAPS_PER_BRANCH = 32
_PLANE_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("generic", "stream")
STREAM_N = (4, 8, 16, 32)   # the stream route's M = N * N
STREAM_P = 8

# W_32^j = exp(-2 pi i j / 32), j < 16, float64 rounded once: the stream
# route's literals (csrc/pfb.cu::w32_re, w32_im).
_ANG32 = 2 * np.pi * np.arange(16) / 32
W32 = (np.cos(_ANG32).astype(np.float32), (-np.sin(_ANG32)).astype(np.float32))


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


def stream_route(m: int, p: int) -> bool:
    """Whether a card launch of this shape takes the stream route (the
    C gate ``csrc/pfb.cu::stream_log2n``, mirrored)."""
    return p == STREAM_P and m in tuple(n * n for n in STREAM_N)


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


@spanned("wrapper:pfb_mxu")
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


def reset_counts() -> None:
    """Set :func:`pfb_mxu`'s launch counts to 0."""
    pfb_mxu.launches = 0
    pfb_mxu.routes = dict.fromkeys(ROUTES, 0)


reset_counts()


def pfb_twiddles(m: int, dev) -> tuple:
    """The kernel's table exp(-2 pi i j / M), j < M, as a pair of float32
    planes: computed in float64 on ``dev`` and rounded once."""
    ang = torch.arange(m, dtype=torch.float64, device=dev) * (-2 * np.pi / m)
    return torch.cos(ang).float(), torch.sin(ang).float()


def _aligned(v: torch.Tensor) -> torch.Tensor:
    """v, or a copy of it when its data does not start 16-byte aligned (a
    view at an odd offset; a fresh tensor always is)."""
    return v if v.data_ptr() % 16 == 0 else v.clone()


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
    # the stream route copies whole frames by cp.async.bulk and loads
    # lanes in pairs: 16-byte aligned planes
    xr, xi = (_aligned(v.reshape(c, f, m).contiguous()) for v in (xr, xi))
    hr = _aligned(small(hist.re.reshape(c, p, m), torch.float32, (c, p, m)))
    hi = _aligned(small(hist.im.reshape(c, p, m), torch.float32, (c, p, m)))
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
    route = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_pfb(xr.data_ptr(), xi.data_ptr(), hr.data_ptr(),
                         hi.data_ptr(), taps.data_ptr(), twr.data_ptr(),
                         twi.data_ptr(), ptr(pr), ptr(pi), out_r.data_ptr(),
                         ptr(out_i), ptr(ylr), ptr(yli), ptr(y0r), ptr(y0i),
                         c, f, m, p, float(gain), int(bool(demod)),
                         int(xr.dtype == torch.bfloat16),
                         ctypes.c_void_p(stream), ctypes.byref(route))
    _check(name, lib, rc)
    pfb_mxu.launches += 1
    pfb_mxu.routes[ROUTES[route.value]] += 1
    if not demod:
        return Complex(out_r.reshape(lead + (f, m)),
                       out_i.reshape(lead + (f, m)))
    return (out_r.reshape(lead + (f, m)),
            Complex(ylr.reshape(lead + (1, m)), yli.reshape(lead + (1, m))),
            Complex(y0r.reshape(lead + (1, m)), y0i.reshape(lead + (1, m))))


# -- the stream route's decomposition, emulated on the CPU -------------------

def _bitrev(logn: int) -> np.ndarray:
    return np.array([int(f"{v:0{logn}b}"[::-1], 2)
                     for v in range(1 << logn)])


def fft_reg(re: torch.Tensor, im: torch.Tensor, logn: int):
    """The kernel's in-register N-point DFT along the last axis (N =
    2^logn), butterfly for butterfly in float32: radix-2 decimation in
    frequency, the difference of pair i at span h times W_32^(i 16 / h) (1
    and -i without a product); returns the outputs in bit-reversed order,
    as the kernel's registers hold them."""
    n = 1 << logn
    re, im = list(re.unbind(-1)), list(im.unbind(-1))
    for st in range(logn):
        h = (n // 2) >> st
        for b in range(n // 2):
            i = b % h
            lo = (b // h) * 2 * h + i
            hi = lo + h
            ar, ai, br, bi = re[lo], im[lo], re[hi], im[hi]
            re[lo], im[lo] = ar + br, ai + bi
            dr, di = ar - br, ai - bi
            j = i * (16 // h)
            if j == 0:
                re[hi], im[hi] = dr, di
            elif j == 8:
                re[hi], im[hi] = di, -dr
            else:
                c, s = float(W32[0][j]), float(W32[1][j])
                re[hi], im[hi] = dr * c - di * s, dr * s + di * c
    return torch.stack(re, -1), torch.stack(im, -1)


def stream_fft(u: Complex, twiddles=None) -> Complex:
    """The stream route's M = N x N DFT of u (..., M) float32, four-step as
    the kernel runs it: lane n2 takes the column u[n2 + N n1], an N-point
    :func:`fft_reg`, times W_M^(n2 k1) from the twiddle table, the
    transpose, the second :func:`fft_reg`; Y[k1 + N k2] in channel
    order."""
    m = u.re.shape[-1]
    n = int(round(np.sqrt(m)))
    logn = n.bit_length() - 1
    rev = torch.as_tensor(_bitrev(logn))
    twr, twi = pfb_twiddles(m, "cpu") if twiddles is None else twiddles
    lead = tuple(u.re.shape[:-1])
    # (..., n2, n1): column n2 of each frame
    ar = u.re.reshape(lead + (n, n)).transpose(-1, -2)
    ai = u.im.reshape(lead + (n, n)).transpose(-1, -2)
    ar, ai = fft_reg(ar, ai, logn)           # register r holds k1 = rev[r]
    n2 = torch.arange(n)[:, None]
    w = (n2 * rev[None, :]).reshape(-1)      # W_M^(n2 k1) at [n2][r]
    cr = twr.cpu()[w].reshape(n, n)
    ci = twi.cpu()[w].reshape(n, n)
    ar, ai = ar * cr - ai * ci, ar * ci + ai * cr
    # transpose: lane k1 takes row entries (n2 = 0..N-1) at column k1
    br = ar[..., rev].transpose(-1, -2)      # (..., k1, n2)
    bi = ai[..., rev].transpose(-1, -2)
    br, bi = fft_reg(br, bi, logn)           # register r holds k2 = rev[r]
    yr = br[..., rev].transpose(-1, -2)      # (..., k2, k1)
    yi = bi[..., rev].transpose(-1, -2)
    return Complex(yr.reshape(lead + (m,)), yi.reshape(lead + (m,)))


def stream_store(y: Complex) -> Complex:
    """The kernel's lane-permuted store: Y (..., M) in channel order goes
    to the frame's row at k2 (N + 1) + k1 (ch = k1 + N k2), and lane L
    reads it back at channel ``channel_of_lane(M)[L]``."""
    m = y.re.shape[-1]
    n = int(round(np.sqrt(m)))
    ch = np.arange(m)
    pos = torch.as_tensor(ch + ch // n)
    lead = tuple(y.re.shape[:-1])
    rows = [torch.zeros(lead + (n * (n + 1),)) for _ in range(2)]
    rows[0][..., pos] = y.re
    rows[1][..., pos] = y.im
    at = pos[torch.as_tensor(channel_of_lane(m))]
    return Complex(rows[0][..., at], rows[1][..., at])


def pfb_split(x: Complex, hist: Complex, taps3, m: int, gain: float = 1.0,
              prev: Complex = None, demod: bool = False, tt: int = None,
              twiddles=None):
    """CPU emulation of csrc/pfb.cu's stream route (same arguments and
    results as :func:`pfb_plain`), for :func:`stream_route` shapes.

    The block is cut into tiles of ``tt`` frames (default: one tile), as
    the kernel's blocks cut it.  A tile's MAC reads its P-frame halo from
    the frames before it or from hist, and adds the terms k = 0..P in
    order; a demod tile after the first recomputes the frame before it for
    Y[t - 1] and writes nothing for it.  Each frame's DFT is
    :func:`stream_fft`, stored through :func:`stream_store`.  The kernel's
    groups of 256 / N frames change no number: a frame's u and Y depend on
    the frame alone, and Y[t - 1] is the frame before whichever group holds
    it."""
    p = hist.re.shape[-2]
    if not stream_route(m, p):
        raise ValueError(f"pfb_split: M={m}, P={p} is not a stream-route "
                         "shape")
    lead = tuple(x.re.shape[:-2])
    f = x.re.shape[-2]
    c = int(np.prod(lead, dtype=np.int64))
    tt = f if tt is None else int(tt)
    taps = torch.as_tensor(taps3, dtype=torch.float32).cpu()
    xs = [torch.cat([h.reshape(c, p, m).float().cpu(),
                     v.reshape(c, f, m).float().cpu()], dim=1)
          for h, v in ((hist.re, x.re), (hist.im, x.im))]
    if demod and prev is None:
        prev = _unit_prev(Complex(x.re.cpu(), x.im.cpu()), m)
    outs, firsts = [], []
    for t0 in range(0, f, tt):
        t_end = min(t0 + tt, f)
        s = t0 - 1 if demod and t0 > 0 else t0
        # X[t - k] at row p + t - k of the stream's frames
        acc = None
        for k in range(p + 1):
            term = Complex(xs[0][:, p + s - k:p + t_end - k, :] * taps[k],
                           xs[1][:, p + s - k:p + t_end - k, :] * taps[k])
            acc = term if acc is None else acc + term
        y = stream_store(stream_fft(acc, twiddles))
        if not demod:
            outs.append(y)
            continue
        if t0 == 0:
            q = Complex(prev.re.reshape(c, 1, m).float().cpu(),
                        prev.im.reshape(c, 1, m).float().cpu())
            head = y
        else:
            q, head = y[:, :1, :], y[:, 1:, :]
        shifted = Complex(torch.cat([q.re, head.re[:, :-1, :]], dim=1),
                          torch.cat([q.im, head.im[:, :-1, :]], dim=1))
        outs.append(fm_demod_lanes(head, shifted, gain))
        firsts.append(head)
    if not demod:
        return Complex(torch.cat([o.re for o in outs], 1).reshape(
            lead + (f, m)), torch.cat([o.im for o in outs], 1).reshape(
            lead + (f, m)))
    audio = torch.cat(outs, 1).reshape(lead + (f, m))
    y_first, y_last = firsts[0][:, :1, :], firsts[-1][:, -1:, :]
    return (audio,
            Complex(y_last.re.reshape(lead + (1, m)),
                    y_last.im.reshape(lead + (1, m))),
            Complex(y_first.re.reshape(lead + (1, m)),
                    y_first.im.reshape(lead + (1, m))))
