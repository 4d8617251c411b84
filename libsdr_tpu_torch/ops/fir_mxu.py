"""The v1 decimating FIR with any window offset, and its FM and AM
epilogues: the counterparts of ``libsdr_tpu.ops.pallas_fir_mxu.fir_mxu``
(K5) and ``fir_fm_mxu`` (K6).

For a block x (C, B) of planar IQ, B a whole number of frames of 128*D
samples, complex taps g (T,) and a window offset s0 >= 0, every entry
computes the n_out = B/D outputs

    y[j] = sum_i g[i] * v[s0 + j*D + i],   v[n] = x[n]            (n < B)
                                                  = x[n - 128*D]   (n >= B)

The windows of the last ``nsp = 128`` outputs may reach past the block:
those outputs need the next block's samples and are declared invalid, as
in the JAX contract.  Their values are still the JAX kernel's, whose halo
clamps to the block's last frame, so every returned output equals it.

* :func:`fir_mxu` (K5) returns (y, nsp);
* :func:`fir_fm_mxu` (K6), mode ``'fm'``: ``audio = gain *
  atan2_poly(y[j] * conj(y[j-1]) * rot)`` with y[-1] = ``lead_last``, then
  optionally the de-emphasis ``out = a*out[-1] + b*audio`` from
  ``deemph_lead``; returns (audio, nsp);
* :func:`fir_fm_mxu`, mode ``'am'``: ``gain * |y|``, or with ``deemph_ab =
  (a, b)`` the AGC ``sd = a*sd[-1] + b*|y|`` from ``deemph_lead`` and
  ``gain * |y| / sd``, returning (audio, sd after the last output, nsp).

:func:`fir_offset` runs K5's kernel in the overlap-save form:
``fir_overlap_save`` (``ops/fir.py``) sends a CUDA block with any offset
other than ``stride - 1`` to it, one launch a block, with windows that
start in the (C, T-1) carry tail.

Each entry dispatches on the device of its input: a CPU tensor takes its
plain PyTorch version (``*_plain``, beside it); a CUDA tensor launches a
kernel with the caller's window start (C entries ``sdr_fir_mxu`` and
``sdr_fir_fm_mxu``; the AGC is ``csrc/agc.cu``'s passes), or raises
``ValueError`` naming the limit it is outside.  Both take the
tensor-core kernel of ``csrc/fir_tc.cu`` where their cut says so and its
plan fits (``ops/fir_tc.py``: the split emulation of K5 is
``fir_mxu_split``; one bf16 pass after ``set_mxu_precision('fast')``),
else the staged or warp kernel of ``csrc/fir_fm_exact.cu`` and
``csrc/fir_warp.cu``: K5 at the strides of mode fir's cut in
``ops/fir_fm.py`` (so that at K1b's window start, offset ``stride - 1``,
it is K1b bit for bit), K6 in both modes at mode fm's.  K5's launches, from
:func:`fir_mxu` and :func:`fir_offset`, count in ``fir_mxu.launches``;
K6's in ``fir_fm_mxu.launches``; both by route in ``.routes``.

The gate, re-derived for Hopper (:func:`mxu_fir_supported`): the TPU's
MXU rows, 8/16-row alignment and VMEM budget do not apply, since the CUDA
kernels take any channel count.  What stays is the output contract:
stride > 1, B a positive multiple of 128*stride, s0 >= 0, and
``ceil((T-1+s0)/stride) <= 128``, so that only the last 128 outputs reach
past the block.  Add the kernels' shared-memory limit, T <= 3,228 (the warp
kernel's taps and staging buffers with float32 planes; ops/fir_fm.py), and
float32 or bfloat16 planes.  Accumulation is float32 either way.
"""

from __future__ import annotations

import ctypes

import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops.fir import _conv1d, _n_taps, _taps_planes
from libsdr_tpu_torch.ops.fir_fm import (_MODE_AM, _MODE_FIR, _MODE_FM,
                                         _PLANE_DTYPES, _agc_plain, _check,
                                         _checked_planes, _chunks, _count,
                                         _fast, _fm_plain, _iir_operands,
                                         _plain, _ptr, _small, reset_counts)
from libsdr_tpu_torch.utils.profiling import spanned

_S = 128        # outputs per frame
_NSP = 128      # invalid outputs at the end of fir_mxu's and fir_fm_mxu's y
_MAX_TAPS = 3228  # 8*T + 16*max(512, T)*4 bytes <= 232,448 (fir_warp.cu)
_MODES = ("fm", "am")


def mxu_fir_supported(taps_len: int, stride: int, offset: int,
                      channels: int, block: int,
                      dtype=torch.float32) -> bool:
    """Whether :func:`fir_mxu` and :func:`fir_fm_mxu` take these shapes on
    the card (see the module docstring)."""
    sd = _S * stride
    return (dtype in _PLANE_DTYPES and stride > 1 and channels >= 1
            and 1 <= taps_len <= _MAX_TAPS and offset >= 0
            and block >= sd and block % sd == 0
            and -(-(taps_len - 1 + offset) // stride) <= _NSP)


def fir_offset_supported(taps_len: int, stride: int, offset: int,
                         block: int, dtype=torch.float32) -> bool:
    """Whether :func:`fir_offset` takes these shapes on the card: at least
    one output (offset < block), T <= 3,228 and float32 or bfloat16
    planes."""
    return (dtype in _PLANE_DTYPES and stride >= 1
            and 1 <= taps_len <= _MAX_TAPS and 0 <= offset < block)


def _gate(name, t, d, offset, c, b, dtype):
    if not mxu_fir_supported(t, d, offset, c, b, dtype):
        raise ValueError(
            f"{name}: outside the kernel's gate (T={t}, stride={d}, "
            f"offset={offset}, C={c}, B={b}, {dtype}): it takes stride > 1, "
            f"B a positive multiple of {_S}*stride, offset >= 0, "
            f"ceil((T-1+offset)/stride) <= {_NSP}, T <= {_MAX_TAPS} and "
            "float32 or bfloat16 planes")


def _y_plain(x: Complex, taps, stride: int, offset: int) -> Complex:
    """The v1 y of every output in float32, the last frame's windows reading
    past the block into the frame before it."""
    b = x.re.shape[-1]
    sd = _S * stride
    n_out = (b // sd) * _S
    past = offset + (n_out - 1) * stride + _n_taps(taps) - b
    xf = x.map(torch.Tensor.float)
    if past > 0:
        xf = cplx.concatenate([xf, xf[..., b - sd:b - sd + past]], axis=-1)
    return _conv1d(xf[..., offset:], taps, stride)[..., :n_out]


def fir_mxu_plain(x: Complex, taps, stride: int, offset: int):
    """Plain PyTorch version of :func:`fir_mxu`, in float32."""
    return _y_plain(x, taps, int(stride), int(offset)), _NSP


@spanned("wrapper:fir_mxu")
def fir_mxu(x: Complex, taps, stride: int, offset: int):
    """All in-block FIR outputs, window start ``offset + j*stride``, of a
    (C, B) planar block (K5).

    Args:
      x: Complex (C, B) planes, float32 or bfloat16.
      taps: (T,) complex or real taps: numpy, or a Complex of tap tensors.
      stride: decimation D > 1.
      offset: window start s0 >= 0 of output 0.

    Returns:
      (y, nsp): y Complex (C, (B // (128 D)) * 128) float32, of which the
      last nsp = 128 are invalid (they need the next block).
    """
    if _plain(x, "fir_mxu"):
        return fir_mxu_plain(x, taps, stride, offset)
    d, s0 = int(stride), int(offset)
    xr, xi = _checked_planes("fir_mxu", x)
    c, b = xr.shape
    t = _n_taps(taps)
    _gate("fir_mxu", t, d, s0, c, b, xr.dtype)
    return _launch_fir("fir_mxu", x, taps, d, s0, b // d, _S * d), _NSP


def fir_offset_plain(x: Complex, taps, stride: int, offset: int,
                     tail: Complex) -> Complex:
    """Plain PyTorch version of :func:`fir_offset`, in float32."""
    xc = Complex(torch.cat([tail.re.to(x.re.dtype), x.re], -1).float(),
                 torch.cat([tail.im.to(x.im.dtype), x.im], -1).float())
    return _conv1d(xc[..., int(offset):], taps, int(stride))


def fir_offset(x: Complex, taps, stride: int, offset: int,
               tail: Complex) -> Complex:
    """``fir_overlap_save``'s outputs at any offset through K5's kernel, one
    launch: ``y[j] = sum_i g[i] * xc[offset + j*D + i]`` over ``xc =
    concat(tail, x)`` for ``j < (B - offset - 1)//D + 1``.

    Args:
      x: Complex (C, B) planes, float32 or bfloat16 (any B > offset).
      taps: (T,) taps, as for :func:`fir_mxu`.
      stride: decimation D.
      offset: index in xc of output 0's window, >= 0.
      tail: Complex (C, T-1), the last T-1 input samples before x.

    Returns:
      Complex (C, (B - offset - 1)//D + 1) float32.
    """
    if _plain(x, "fir_offset"):
        return fir_offset_plain(x, taps, stride, offset, tail)
    d, off = int(stride), int(offset)
    xr, xi = _checked_planes("fir_offset", x)
    c, b = xr.shape
    t = _n_taps(taps)
    if not fir_offset_supported(t, d, off, b, xr.dtype):
        raise ValueError(
            f"fir_offset: outside the kernel's gate (T={t}, stride={d}, "
            f"offset={off}, B={b}, {xr.dtype}): it takes 0 <= offset < B, "
            f"T <= {_MAX_TAPS} and float32 or bfloat16 planes")
    return _launch_fir("fir_offset", x, taps, d, off - (t - 1),
                       (b - off - 1) // d + 1, 0, tail)


def _launch_fir(name, x, taps, d, s0, n_out, wrap, tail=None) -> Complex:
    """One launch of K5's kernel (C entry ``sdr_fir_mxu``) with window
    start s0 (in the tail when negative) and n_out outputs a channel."""
    from libsdr_tpu_torch import _build

    xr, xi = x.re, x.im
    dev = xr.device
    c, b = xr.shape
    t = _n_taps(taps)
    small = _small(name, dev)
    gr, gi = _tap_planes(taps, t, dev, small)
    tr = ti = None
    if tail is not None:
        tr = small(tail.re, xr.dtype, (c, t - 1))
        ti = small(tail.im, xr.dtype, (c, t - 1))
    lib = _build.library()
    k, route = _chunks(name, lib, _MODE_FIR, c, n_out, t, d, 0, xr)
    out = torch.empty((c, n_out), dtype=torch.float32, device=dev)
    out_i = torch.empty_like(out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_fir_mxu(
            xr.data_ptr(), xi.data_ptr(), _ptr(tr), _ptr(ti), gr.data_ptr(),
            gi.data_ptr(), out.data_ptr(), out_i.data_ptr(), c, b, t, d, s0,
            n_out, wrap, k, _fast(), int(xr.dtype == torch.bfloat16),
            ctypes.c_void_p(stream))
    _check(name, lib, rc)
    _count(fir_mxu, route)
    return Complex(out, out_i)


def _tap_planes(taps, t, dev, small):
    """Taps as two float32 (T,) planes on ``dev`` (zeros for real taps)."""
    gr, gi = _taps_planes(taps, torch.float32, dev)
    if gi is None:
        gi = torch.zeros_like(gr)
    return small(gr, torch.float32, (t,)), small(gi, torch.float32, (t,))


def fir_fm_mxu_plain(x: Complex, taps, stride: int, offset: int,
                     lead_last: Complex, rot: complex, gain: float,
                     deemph_ab=None, deemph_lead=None, mode: str = "fm"):
    """Plain PyTorch version of :func:`fir_fm_mxu`, in float32."""
    if mode not in _MODES:
        raise ValueError(f"fir_fm_mxu: mode {mode!r} is not one of "
                         f"{_MODES}")
    y = _y_plain(x, taps, int(stride), int(offset))
    c = y.re.shape[0]
    state = None if deemph_ab is None else deemph_lead.reshape(c)
    if mode == "am":
        audio, sd = _agc_plain(y.abs(), gain, deemph_ab, state)
        if deemph_ab is None:
            return audio, _NSP
        return audio, sd[:, None], _NSP
    prev = lead_last.reshape(c)
    return _fm_plain(y, prev, rot, gain, deemph_ab, state), _NSP


@spanned("wrapper:fir_fm_mxu")
def fir_fm_mxu(x: Complex, taps, stride: int, offset: int,
               lead_last: Complex, rot: complex, gain: float,
               deemph_ab=None, deemph_lead=None, mode: str = "fm"):
    """The v1 FIR with the FM discriminator (+ de-emphasis) or the AM
    envelope (+ AGC) over a (C, B) planar block (K6).

    Args:
      x, taps, stride, offset: as for :func:`fir_mxu`.
      lead_last: Complex (C, 1), y[-1] (mode 'fm'; ignored by 'am').
      rot: complex rotation folded into the discriminator ('fm').
      gain: output scale (``target/4`` with the AGC).
      deemph_ab: (a, b) of the de-emphasis ('fm') or the AGC ('am'), or
        None.
      deemph_lead: (C, 1) float32, their state before the block.
      mode: 'fm' or 'am'.

    Returns:
      (audio, nsp), or with mode 'am' and ``deemph_ab`` (audio, sd_state
      (C, 1), nsp): audio is (C, (B // (128 D)) * 128) float32, the last
      nsp = 128 invalid; sd_state is the AGC state after the last output,
      the invalid ones included (the next block's ``deemph_lead``).
    """
    if _plain(x, "fir_fm_mxu"):
        return fir_fm_mxu_plain(x, taps, stride, offset, lead_last, rot,
                                gain, deemph_ab, deemph_lead, mode)
    from libsdr_tpu_torch import _build

    name = "fir_fm_mxu"
    if mode not in _MODES:
        raise ValueError(f"{name}: mode {mode!r} is not one of {_MODES}")
    d, s0 = int(stride), int(offset)
    xr, xi = _checked_planes(name, x)
    c, b = xr.shape
    t = _n_taps(taps)
    _gate(name, t, d, s0, c, b, xr.dtype)
    dev = xr.device
    small = _small(name, dev)
    gr, gi = _tap_planes(taps, t, dev, small)
    n_out = b // d
    kmode = _MODE_FM if mode == "fm" else _MODE_AM

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    pr = pi = ylr = yli = None
    if mode == "fm":
        pr = small(lead_last.re.reshape(c), torch.float32, (c,))
        pi = small(lead_last.im.reshape(c), torch.float32, (c,))
        ylr, yli = empty(c), empty(c)   # y[n_out - 1]: not returned
    lib = _build.library()
    k, route = _chunks(name, lib, kmode, c, n_out, t, d, 0, xr,
                       cut_mode=_MODE_FM)
    out = empty(c, n_out)
    a, bc, s_in, s_out, ends, k_agc = _iir_operands(
        name, lib, kmode, c, n_out, k, deemph_ab,
        None if deemph_ab is None else deemph_lead.reshape(c), dev)
    rot = complex(rot)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_fir_fm_mxu(
            kmode, xr.data_ptr(), xi.data_ptr(), gr.data_ptr(),
            gi.data_ptr(), _ptr(pr), _ptr(pi), out.data_ptr(), _ptr(ylr),
            _ptr(yli), _ptr(s_in), _ptr(s_out), _ptr(ends), c, b, t, d, s0,
            k, k_agc, rot.real, rot.imag, float(gain), a, bc,
            int(deemph_ab is not None), _fast(),
            int(xr.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    _check(name, lib, rc)
    _count(fir_fm_mxu, route)
    if mode == "am" and deemph_ab is not None:
        return out, s_out[:, None], _NSP
    return out, _NSP


# Kernel launches, counted where they happen, in all and by route: K5
# (fir_mxu, fir_offset) and K6.
reset_counts(fir_mxu)
reset_counts(fir_fm_mxu)
