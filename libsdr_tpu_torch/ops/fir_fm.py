"""Fused decimating FIR + demodulator: the counterpart of
``libsdr_tpu.ops.pallas_fir_mxu.fir_fm_exact`` in its modes 'fm', 'am' and
'usb', of ``pallas_fir_mxu.fir_exact`` (mode 'fir') and of
``pallas_fir_mxu.fir_afsk_exact`` (mode 'afsk').

For a block x (C, B) of planar IQ, the (C, T-1) carry ``tail`` and complex
taps g (T,), with ``xc = concat(tail, x)``, every entry computes

    y[j]   = sum_i g[i] * xc[j*D + D-1 + i]      (window ends at x[(j+1)D-1])

and then:

* :func:`fir_fm_exact`: ``audio = gain * atan2_poly(y[j] * conj(y[j-1]) *
  rot)`` with y[-1] = prev, then optionally the de-emphasis
  ``out[j] = a*out[j-1] + b*audio[j]`` (out[-1] = dstate);
* :func:`fir_exact`: y itself;
* :func:`fir_am_exact`: ``sig = |y|``;
* :func:`fir_usb_exact`: ``sig = (re + im)/2`` of ``y[j] * (a0 * ramp[j])``
  with a0 the carried unit phasor and ramp the host-exact NCO ramp;
* :func:`fir_afsk_exact`: the audio of :func:`fir_fm_exact` (no
  de-emphasis), then the dual-tone FSK correlator ``disc[j] = |s_m[j]|^2 -
  |s_s[j]|^2`` with ``s_m[j]`` the sum of ``audio[k] * mark[(n0 + k) mod
  L]`` over the L samples k ending at j (the first reaching back into the
  carried last L-1 products) and ``s_s`` the same with space;

and for the AM and USB modes ``out = gain * sig`` or, with the AGC,
``sd[j] = lam*sd[j-1] + (1-lam)*|sig[j]|`` (sd[-1] = sd) and
``out = gain * sig / sd``; they return the last sd as the AGC carry.

Each entry dispatches on the device of its input: a CPU tensor takes its
plain PyTorch version (``*_plain``, beside it); a CUDA tensor launches the
hand-written kernels of ``csrc/`` or raises.  Each entry counts its kernel
launches in ``<entry>.launches`` and, by the kernel that ran, in
``<entry>.routes`` (``{"tc": n, "staged": n, "warp": n}``).

Three kernels, by shape (``csrc/fir_common.cuh::route_of``).  Every mode
takes the tensor-core kernel (``csrc/fir_tc.cu``) at the strides of its cut
(``tc_stride``), where its plan fits in shared memory: the FIR as the TPU
kernel's frame matmul on bf16 tensor cores, f32-accurate in three passes
(two for bfloat16 planes; one after ``set_mxu_precision('fast')``,
``ops/fir_tc.py``), mode afsk's window sums in float32 on the CUDA cores,
modes am's and usb's AGC in the same follow-up passes as on the other
kernels.  The cuts, float32 / bfloat16 planes: mode fm (:func:`fir_fm_exact`)
D = 4-16 / 4-40; afsk (:func:`fir_afsk_exact`) 2-16 / 2-40; fir
(:func:`fir_exact`) 2-40 but 3, 6, 8, 9, 12, 24, 32 and 34-39 / 2-40; am
(:func:`fir_am_exact`) 13-40 but 32 and 34-39 / 2-40; usb
(:func:`fir_usb_exact`) 4, 13-16, 23, 25-31 and 33 / 2-61 and the
multiples of 4 from 64 to 120 but 84 and 108.  Every other launch
takes the staged kernel at strides up to 40 in modes fm, usb and afsk and
up to 16 in modes fir and am, and the warp-per-output kernel above.  The
cuts are where the kernels' times on an H100 cross, each stride timed
twice (``tools/fir_paths.py``; PERF.md): mode fm at D = 2..40, 64 ch x
2^24, T = 32 + D - 1 (at D = 4, 4.5 ms against the staged kernel's 5.9
with float32 planes, 3.5 against 5.5 with bfloat16); afsk at 64 ch x 2^21,
T = 48 + D - 1, L = 40 (D = 4: 0.83 against 1.20, 0.70 against 1.25); fir
at 64 ch x 2^24, T = 64 + D - 1 (the DDC bank's D = 4: 4.53 against 5.26,
3.33 against 7.06); am with the AGC at 64 ch x 16,777,200, T = 32 + D - 1
(the AM bank's D = 40: 4.60 against the warp kernel's 4.92, 2.13 against
5.46); usb with the AGC at 64 ch x 16,777,200, T = 64 + D - 1 (the USB
bank's D = 80: 2.79 against the warp kernel's 3.66 with bfloat16 planes,
6.21 against 3.45 with float32, whose plan holds 32 outputs a tile).

Chunks.  Each channel's B/D outputs are cut into K chunks, K as large as the
card's resident slots allow in one wave, and each chunk is one block of the
tensor-core or the staged kernel (chunks of at least 4096 outputs) or one
warp of the warp kernel (at least 64 outputs).  The de-emphasis state
crosses chunk edges through two small follow-up kernels: a per-channel scan
of the chunk-end values and a fix-up of each later chunk's head.  The AGC
runs after the FIR kernel in three launches of its own (``csrc/agc.cu``).

The kernels' shape gate.  They take any C with C*K < 2^31, any T >= 1, any
D >= 1 and any B that is a multiple of D, with one limit on shared memory
(232,448 bytes a block on an H100):

* the tensor-core kernel: two raw stages and the converted span of a tile
  of 16-64 frames, and the band of the tap matrix (``ops/fir_tc.tc_plan``);
  the main path (T = 67, D = 4) plans frames of 14 outputs, 64 a tile, in
  106 KB with float32 planes (two blocks an SM); mode afsk adds the
  templates and 64*((L-1)//4 + 1) bytes of history (the AX.25 bank, T =
  51, D = 4, L = 40: 103 KB, two blocks an SM).  Where no plan fits (T in
  the thousands) the launch takes the staged kernel;
* the staged kernel: a block of 256 threads stages one segment of 256*R
  outputs (R = 4, 2 or 1, the largest that fits) polyphase with one pad
  slot after every R samples (none for R = 1), about

      8*D*ceil(T/D) + 2*D*Q*(1 + 1/R)*itemsize + 144   bytes,
      Q = 256*R + (T-1)//D,

  itemsize 4 for float32 planes and 2 for bfloat16; with float32 planes
  this holds for T up to about 12,000 at D = 16 and 9,400 at D = 40.
* the warp kernel: the taps and eight per-warp staging buffers of
  max(512, T) samples, 8*T + 16*max(512, T)*itemsize bytes, so
  T <= 3,228 for float32 planes and T <= 5,811 for bfloat16.

So every stride up to 256 with up to 512 taps (the rx app's chains) is
inside the gate.  Mode afsk adds the correlator's products to shared
memory (16*(L-1 + 256R) bytes in the staged kernel, 32 KB of per-warp rings
in the warp kernel) and takes windows 2 <= L <= 256.  A shape outside the
gate raises ``ValueError``; the plain versions take every shape.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops.fir import _conv1d, full_f32
from libsdr_tpu_torch.ops.fsk import window_sum
from libsdr_tpu_torch.ops.iir import iir_first_order
from libsdr_tpu_torch.utils.profiling import spanned

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


def _fir_y(x: Complex, taps: Complex, d: int, tail: Complex) -> Complex:
    """y of every mode, in float32 (in float64 for float64 planes, mode
    afsk's): the decimating FIR over tail + x."""
    # The tail is stored in the plane dtype (it is a slice of the input).
    w = torch.float64 if x.re.dtype == torch.float64 else torch.float32
    xc = Complex(torch.cat([tail.re.to(x.re.dtype), x.re], -1).to(w),
                 torch.cat([tail.im.to(x.im.dtype), x.im], -1).to(w))
    return _conv1d(xc[..., d - 1:], taps, d)


def _agc_plain(sig, gain, agc_ab, sd):
    """``gain * sig``, or the AGC ``gain * sig / sd`` and the last sd."""
    if agc_ab is None:
        return sig * float(gain), None
    with full_f32():
        sdv, sd_last = iir_first_order(sig.abs(), agc_ab[0], agc_ab[1],
                                       sd.float())
    return float(gain) * sig / sdv, sd_last


def _fm_plain(y: Complex, prev: Complex, rot: complex, gain: float,
             deemph_ab=None, dstate=None) -> torch.Tensor:
    """The FM epilogue of the plain versions, in float32: ``gain *
    atan2_poly(y[j] * conj(y[j-1]) * rot)`` with y[-1] = prev (C,), then
    optionally the de-emphasis from dstate (C,)."""
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
    return out


def fir_fm_exact_plain(x: Complex, taps: Complex, stride: int,
                       tail: Complex, prev: Complex, rot: complex,
                       gain: float, deemph_ab=None, dstate=None):
    """Plain PyTorch version of :func:`fir_fm_exact` (same arguments and
    results), in float32."""
    y = _fir_y(x, taps, int(stride), tail)
    return _fm_plain(y, prev, rot, gain, deemph_ab, dstate), y[..., -1]


@spanned("wrapper:fir_fm_exact")
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
    if _plain(x, "fir_fm_exact"):
        return fir_fm_exact_plain(x, taps, stride, tail, prev, rot, gain,
                                  deemph_ab, dstate)
    out, _, y_last, _ = _launch(fir_fm_exact, _MODE_FM, x, taps, int(stride),
                                tail, gain, deemph_ab, dstate, prev,
                                complex(rot))
    return out, y_last


def fir_exact_plain(x: Complex, taps: Complex, stride: int,
                    tail: Complex) -> Complex:
    """Plain PyTorch version of :func:`fir_exact`, in float32."""
    return _fir_y(x, taps, int(stride), tail)


@spanned("wrapper:fir_exact")
def fir_exact(x: Complex, taps: Complex, stride: int,
              tail: Complex) -> Complex:
    """Decimating complex FIR over one block: Complex (C, B/D) float32 y
    (arguments as for :func:`fir_fm_exact`)."""
    if _plain(x, "fir_exact"):
        return fir_exact_plain(x, taps, stride, tail)
    out, out_i, _, _ = _launch(fir_exact, _MODE_FIR, x, taps, int(stride),
                               tail)
    return Complex(out, out_i)


def fir_am_exact_plain(x: Complex, taps: Complex, stride: int,
                       tail: Complex, gain: float, agc_ab=None, sd=None):
    """Plain PyTorch version of :func:`fir_am_exact`, in float32."""
    return _agc_plain(_fir_y(x, taps, int(stride), tail).abs(), gain,
                     agc_ab, sd)


@spanned("wrapper:fir_am_exact")
def fir_am_exact(x: Complex, taps: Complex, stride: int, tail: Complex,
                 gain: float, agc_ab=None, sd=None):
    """Fused FIR + AM envelope (+ AGC) over one block.

    Args:
      x, taps, stride, tail: as for :func:`fir_fm_exact`.
      gain: output scale (``target/4`` with the AGC).
      agc_ab: (lam, 1 - lam) of the AGC envelope, or None.
      sd: (C,) float32 AGC envelope state sd[-1] (with agc_ab).

    Returns:
      (out (C, B/D) float32, sd_last (C,) float32 or None).
    """
    if _plain(x, "fir_am_exact"):
        return fir_am_exact_plain(x, taps, stride, tail, gain, agc_ab, sd)
    out, _, _, sd_last = _launch(fir_am_exact, _MODE_AM, x, taps,
                                 int(stride), tail, gain, agc_ab, sd)
    return out, sd_last


def _usb_sig(y: Complex, phasor: Complex, ramp: Complex) -> torch.Tensor:
    """The USB mode's sample of each output: (re + im)/2 of y[j] * (a0 *
    ramp[j])."""
    z = y * (phasor * ramp)
    return (z.re + z.im) * 0.5


def fir_usb_exact_plain(x: Complex, taps: Complex, stride: int,
                        tail: Complex, phasor: Complex, ramp: Complex,
                        gain: float, agc_ab=None, sd=None):
    """Plain PyTorch version of :func:`fir_usb_exact`, in float32."""
    return _agc_plain(_usb_sig(_fir_y(x, taps, int(stride), tail), phasor,
                               ramp), gain, agc_ab, sd)


@spanned("wrapper:fir_usb_exact")
def fir_usb_exact(x: Complex, taps: Complex, stride: int, tail: Complex,
                  phasor: Complex, ramp: Complex, gain: float, agc_ab=None,
                  sd=None):
    """Fused FIR + exact NCO rotation + SSB demod (+ AGC) over one block.

    Args:
      x, taps, stride, tail, gain, agc_ab, sd: as for :func:`fir_am_exact`.
      phasor: Complex () float32 unit phasor a0 of this block.
      ramp: Complex (B/D,) float32, ``exp(-i theta j)`` from the host.

    Returns:
      (out (C, B/D) float32, sd_last (C,) float32 or None).
    """
    if _plain(x, "fir_usb_exact"):
        return fir_usb_exact_plain(x, taps, stride, tail, phasor, ramp,
                                   gain, agc_ab, sd)
    out, _, _, sd_last = _launch(fir_usb_exact, _MODE_USB, x, taps,
                                 int(stride), tail, gain, agc_ab, sd,
                                 phasor=phasor, ramp=ramp)
    return out, sd_last


def fir_afsk_exact_plain(x: Complex, taps: Complex, stride: int,
                         tail: Complex, prev: Complex, rot: complex,
                         gain: float, mark: Complex, space: Complex, n0,
                         um_tail: Complex, us_tail: Complex):
    """Plain PyTorch version of :func:`fir_afsk_exact`, in float32 except
    y: summed in float64 and rounded once, as the staged kernel sums it
    without rounding its products and partial sums (the discriminator
    divides by |y|, so at a deep fade the FIR's float32 rounding would
    dominate disc).  Each window is summed oldest first, as the kernels
    sum it."""
    y = _fir_y(x.to(torch.float64), taps, int(stride),
               tail.to(torch.float64)).to(torch.float32)
    audio, y_last = _fm_plain(y, prev, rot, gain), y[..., -1]
    L = mark.re.shape[-1]
    dev = audio.device
    n0 = torch.as_tensor(n0, device=dev)
    idx = (n0.to(torch.int64) + torch.arange(audio.shape[-1],
                                             device=dev)) % L
    sums, tails = [], []
    for tone, tail_u in ((mark, um_tail), (space, us_tail)):
        full = cplx.concatenate([tail_u.to(dev, torch.float32),
                                 tone.to(dev, torch.float32)[idx] * audio])
        s = full.map(lambda v: window_sum(v, L))
        sums.append(s.re * s.re + s.im * s.im)
        tails.append(full[..., full.shape[-1] - (L - 1):].map(torch.clone))
    return sums[0] - sums[1], y_last, tails[0], tails[1]


@spanned("wrapper:fir_afsk_exact")
def fir_afsk_exact(x: Complex, taps: Complex, stride: int, tail: Complex,
                   prev: Complex, rot: complex, gain: float, mark: Complex,
                   space: Complex, n0, um_tail: Complex, us_tail: Complex):
    """Fused FIR + FM discriminator + dual-tone FSK correlator over one
    block: the AFSK front end in one pass, so neither the baseband nor the
    audio reaches device memory.

    Args:
      x, taps, stride, tail, prev, rot, gain: as for :func:`fir_fm_exact`.
      mark, space: Complex (L,) float32 tone templates over one period of
        the window L (2 <= L <= 256 on the card).
      n0: int32 scalar tensor (or int), the template phase of the block's
        first output, in [0, L).
      um_tail, us_tail: Complex (C, L-1) float32, the last L-1 products of
        each tone before the block.

    Returns:
      (disc (C, B/D) float32, y_last Complex (C,), um_tail', us_tail').
    """
    if _plain(x, "fir_afsk_exact"):
        return fir_afsk_exact_plain(x, taps, stride, tail, prev, rot, gain,
                                    mark, space, n0, um_tail, us_tail)
    out, _, y_last, tails = _launch(
        fir_afsk_exact, _MODE_AFSK, x, taps, int(stride), tail, gain,
        prev=prev, rot=complex(rot),
        afsk=(mark, space, n0, um_tail, us_tail))
    return out, y_last, tails[0], tails[1]


# Kernel launches, counted where they happen, in all and by route.
_ROUTES = ("staged", "warp", "tc")   # csrc/fir_common.cuh::Route


def reset_counts(entry) -> None:
    """Set an entry's launch counts to 0."""
    entry.launches = 0
    entry.routes = dict.fromkeys(_ROUTES, 0)


for _entry in (fir_fm_exact, fir_exact, fir_am_exact, fir_usb_exact,
               fir_afsk_exact):
    reset_counts(_entry)

# The C interface's modes (csrc/fir_common.cuh: Mode).
_MODE_FM, _MODE_FIR, _MODE_AM, _MODE_USB, _MODE_AFSK = 0, 1, 2, 3, 4


def _plain(x, name: str) -> bool:
    """True for a CPU block (a tensor or a Complex); False for a CUDA
    block; raises otherwise."""
    dev = getattr(x, "re", x).device
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return False


def _checked_planes(name, x):
    """The planes of x, checked: (C, B), contiguous, float32 or
    bfloat16."""
    xr, xi = x.re, x.im
    if xr.dtype not in _PLANE_DTYPES or xi.dtype != xr.dtype:
        raise ValueError(f"{name}: planes must be float32 or bfloat16, got "
                         f"{xr.dtype}/{xi.dtype}")
    if xr.ndim != 2 or xi.shape != xr.shape:
        raise ValueError(f"{name}: planes must be (C, B), got "
                         f"{tuple(xr.shape)}")
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError(f"{name}: planes must be contiguous")
    return xr, xi


def _operands(name, x, taps, d, tail):
    """Checked planes of x, the tail in the plane dtype and the taps."""
    xr, xi = _checked_planes(name, x)
    c, b = xr.shape
    t = taps.re.shape[-1]
    if d < 1 or b % d or b < d:
        raise ValueError(f"{name}: block {b} must be a positive multiple of "
                         f"the stride {d}")
    small = _small(name, xr.device)
    return (xr, xi, small(tail.re, xr.dtype, (c, t - 1)),
            small(tail.im, xr.dtype, (c, t - 1)),
            small(taps.re, torch.float32, (t,)),
            small(taps.im, torch.float32, (t,)), c, b, t)


def _small(name, dev):
    """A checker that moves a small operand to ``dev`` and ``dtype``,
    contiguous, and raises unless it has ``shape``."""
    def small(v, dtype, shape):
        v = v.to(dev, dtype).contiguous()
        if tuple(v.shape) != shape:
            raise ValueError(f"{name}: operand shape {tuple(v.shape)}, "
                             f"expected {shape}")
        return v
    return small


def _chunks(name, lib, mode, c, n_out, t, d, ell, xr, cut_mode=None):
    """(K, route name) for a launch of n_out outputs a channel, or
    ValueError outside the gate; ``cut_mode``: the mode whose cut of the
    tensor-core kernel the entry takes, the mode's own by default
    (csrc/fir_fm_exact.cu::route_of)."""
    route = ctypes.c_int(-1)
    cut_mode = mode if cut_mode is None else cut_mode
    with torch.cuda.device(xr.device):
        k = lib.sdr_fir_chunks(mode, cut_mode, c, n_out, t, d, ell,
                               int(xr.dtype == torch.bfloat16), _fast(),
                               ctypes.byref(route))
    if k == -1:
        raise ValueError(f"{name}: shape outside the kernel's gate (C={c}, "
                         f"{n_out} outputs, T={t}, D={d}, L={ell}, "
                         f"{xr.dtype}); see ops/fir_fm.py")
    if k < -1:
        msg = lib.sdr_cuda_error_string(-2 - k).decode()
        raise RuntimeError(f"{name}: device query failed: {msg}")
    return k, _ROUTES[route.value]


def _fast() -> int:
    """1 after set_mxu_precision('fast'): the tensor-core route's one
    bf16 pass."""
    from libsdr_tpu_torch.ops.fir import mxu_precision
    return int(mxu_precision() == "fast")


def _count(entry, route: str) -> None:
    entry.launches += 1
    entry.routes[route] += 1


def _check(name, lib, rc):
    if rc == -1:
        raise ValueError(f"{name}: arguments outside the kernel's gate")
    if rc != 0:
        msg = lib.sdr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg}")


def _ptr(v):
    return None if v is None else v.data_ptr()


def _iir_operands(name, lib, mode, c, n, k, iir_ab, state, dev):
    """(a, b, s_in, s_out, ends, K_agc) of the C entries for mode fm's
    de-emphasis (ends: (C, K) scratch when K > 1) or the AGC of modes am
    and usb (s_out: the state export; ends: (C, K_agc) scratch); zeros and
    None without ``iir_ab``."""
    if iir_ab is None:
        return 0.0, 0.0, None, None, None, 0
    a, bc = map(float, iir_ab)
    s_in = _small(name, dev)(state, torch.float32, (c,))

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    if mode == _MODE_FM:
        return a, bc, s_in, None, empty(c, k) if k > 1 else None, 0
    with torch.cuda.device(dev):
        k_agc = lib.sdr_agc_chunks(c, n)
    if k_agc < 1:
        msg = lib.sdr_cuda_error_string(-2 - k_agc).decode()
        raise RuntimeError(f"{name}: device query failed: {msg}")
    return a, bc, s_in, empty(c), empty(c, k_agc), k_agc


def _launch(entry, mode, x, taps, d, tail, gain=1.0, iir_ab=None,
            state=None, prev=None, rot=0j, phasor=None, ramp=None,
            afsk=None):
    """One launch of a mode: the FIR kernel, then the mode's IIR (mode fm's
    de-emphasis, or the AGC of modes am and usb) when iir_ab is given with
    its state.  Mode afsk takes ``afsk = (mark, space, n0, um_tail,
    us_tail)``.  Returns (out, out_i, y_last, sd_last), None where the mode
    has no such result; mode afsk returns its two new tails in place of
    sd_last."""
    from libsdr_tpu_torch import _build

    name = entry.__name__
    xr, xi, tr, ti, gr, gi, c, b, t = _operands(name, x, taps, d, tail)
    dev = xr.device
    small = _small(name, dev)
    n = b // d

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    pr = pi = ylr = yli = rr = ri = phr = phi = None
    ell, ops, u_out = 0, None, None
    if mode in (_MODE_FM, _MODE_AFSK):
        pr = small(prev.re, torch.float32, (c,))
        pi = small(prev.im, torch.float32, (c,))
        ylr, yli = empty(c), empty(c)
    if mode == _MODE_USB:
        rr = small(ramp.re, torch.float32, (n,))
        ri = small(ramp.im, torch.float32, (n,))
        phr = small(phasor.re, torch.float32, ())
        phi = small(phasor.im, torch.float32, ())
    if mode == _MODE_AFSK:
        mark, space, n0, um, us = afsk
        ell = mark.re.shape[-1]
        u_out = [empty(c, ell - 1) for _ in range(4)]
        tpl = [small(v, torch.float32, (ell,))
               for v in (mark.re, mark.im, space.re, space.im)]
        u_in = [small(v, torch.float32, (c, ell - 1))
                for v in (um.re, um.im, us.re, us.im)]
        n0 = small(torch.as_tensor(n0), torch.int32, ())
        ops = (ctypes.c_void_p * 13)(*[v.data_ptr() for v in (
            tpl + [n0] + u_in + u_out)])
    lib = _build.library()
    k, route = _chunks(name, lib, mode, c, n, t, d, ell, xr)
    out = empty(c, n)
    out_i = empty(c, n) if mode == _MODE_FIR else None
    a, bc, s_in, s_out, ends, k_agc = _iir_operands(
        name, lib, mode, c, n, k, iir_ab, state, xr.device)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_fir_exact(
            mode, xr.data_ptr(), xi.data_ptr(), tr.data_ptr(), ti.data_ptr(),
            gr.data_ptr(), gi.data_ptr(), _ptr(pr), _ptr(pi), _ptr(rr),
            _ptr(ri), _ptr(phr), _ptr(phi), out.data_ptr(), _ptr(out_i),
            _ptr(ylr), _ptr(yli), _ptr(s_in), _ptr(s_out), _ptr(ends), c, b,
            t, d, k, k_agc, rot.real, rot.imag, float(gain), a, bc,
            int(iir_ab is not None), ops, ell, _fast(),
            int(xr.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    _check(name, lib, rc)
    _count(entry, route)
    y_last = None if ylr is None else Complex(ylr, yli)
    if mode == _MODE_AFSK:
        return out, None, y_last, (Complex(*u_out[:2]), Complex(*u_out[2:]))
    return out, out_i, y_last, s_out
