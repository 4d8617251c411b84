"""Fixed-point parity ops (counterpart of ``libsdr_tpu.ops.fixedpoint``;
reference: src/math.hh, src/operators.hh).

The reference computes in Q-format integers; these ops reproduce its int16
receive chain bit for bit (the quirks included: the first decimation group
absorbs decim + 1 samples, ``first_block_pad``, ``ref_block_quirk``), with
the semantics of the JAX package's int32 arithmetic: addition, subtraction
and multiplication wrap modulo 2^32 (computed here in int64 and wrapped,
which is the same result), ``>>`` is an arithmetic shift, ``//`` and ``%``
round toward minus infinity, and :func:`_div_trunc` truncates toward zero.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import ConfigError, StreamSpec
from libsdr_tpu_torch.ops.fir_fm import _check, _plain
from libsdr_tpu_torch.utils.profiling import spanned


def _w32(a: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (the int32 result of
    the same additions, subtractions and products)."""
    return (((a + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _wrap16(a: torch.Tensor) -> torch.Tensor:
    """int32 -> int16 wraparound (the C++ int32->int16 conversion)."""
    return ((a + (1 << 15)) & 0xFFFF) - (1 << 15)


def _div_trunc(a: torch.Tensor, b) -> torch.Tensor:
    """C-style integer division (truncate toward zero) of int32 tensors:
    ``sign(a) * sign(b) * (|a| // |b|)``, as the JAX package computes it."""
    if isinstance(b, int):
        return torch.sign(a) * ((b > 0) - (b < 0)) * (a.abs() // abs(b))
    return torch.sign(a) * torch.sign(b) * (a.abs() // b.abs())


def fast_atan2_i16(a, b) -> torch.Tensor:
    """The reference's integer atan2 approximation (reference:
    src/math.hh:31-40, fast_atan2<int16_t,int16_t>): the angle on an int16
    scale with pi == 1<<14 (pi/4 == 1<<12).

    Args:
      a, b: integer tensors (int16 range); returns int32 angles.
    """
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b).to(torch.int32)
    pi4, pi34 = 1 << 12, 3 * (1 << 12)
    aabs = a.abs()
    # Each branch's divisor is nonzero wherever that branch is taken (b >= 0:
    # b + |a| = 0 only at (0, 0), which is 0 below; b < 0: |a| - b > 0); the
    # other lanes divide by 1 and are discarded.
    dpos = b + aabs
    dneg = aabs - b
    one = torch.ones_like(a)
    angle_pos = pi4 - _div_trunc(pi4 * (b - aabs),
                                 torch.where(dpos == 0, one, dpos))
    angle_neg = pi34 - _div_trunc(pi4 * (b + aabs),
                                  torch.where(dneg == 0, one, dneg))
    angle = torch.where(b >= 0, angle_pos, angle_neg)
    angle = torch.where(a >= 0, angle, -angle)
    return torch.where((a == 0) & (b == 0), torch.zeros_like(angle), angle)


def ref_q14_kernel(order: int, ff: float, width: float, fs: float
                   ) -> np.ndarray:
    """The reference's Q14 integer band-pass kernel, bit-exact
    (reference: src/baseband.hh:239-262 _update_filter_kernel): Blackman-
    windowed sinc shifted to -Ff, normalized by sum(|alpha|), scaled by
    2^14 and TRUNCATED toward zero per component (the C++ double ->
    int32 conversion)."""
    w = (np.pi * width) / fs
    m = order / 2.0
    i = np.arange(order, dtype=np.float64)
    alpha = np.where(order == 2 * i, 4 * (w / np.pi),
                     np.sin(w * (i - m)) / (w * (i - m)))
    alpha = alpha.astype(np.complex128)
    alpha *= np.exp(-2j * np.pi * ff * i / fs)
    alpha *= (0.42 - 0.5 * np.cos(2 * np.pi * i / order)
              + 0.08 * np.cos(4 * np.pi * i / order))
    norm = np.abs(alpha).sum()
    k = (float(1 << 14) * alpha) / norm
    return (np.trunc(k.real).astype(np.int64)
            + 1j * np.trunc(k.imag).astype(np.int64)).astype(np.complex128)


def ref_nco_lut(shift: int = 16, size: int = 128) -> np.ndarray:
    """The reference's integer NCO LUT, bit-exact (reference:
    src/freqshift.hh:27-36): 2^shift * exp(-2 pi i k/size), truncated per
    component (C++ double -> int32)."""
    k = np.arange(size)
    v = float(1 << shift) * np.exp(-2j * np.pi * k / size)
    return np.trunc(v.real) + 1j * np.trunc(v.imag)


class IQBaseBandInt(Processor):
    """Bit-exact integer IQBaseBand<int16_t> (reference:
    src/baseband.hh:198-236 _process + _filter_ring, src/freqshift.hh:58-87
    applyFrequencyShift): Q14 ring FIR with arithmetic >>14, the 128-entry
    Q16 LUT NCO with the 8.8 fixed-point phase counter, and the averaging
    decimator, with the reference's off-by-one: the FIRST group ever
    averaged absorbs ``decim+1`` samples, so the first block emits
    ``B/decim - 1`` samples (its last slot is padding, ``first_block_pad``)
    and every later block ``B/decim``.

    Input: planar complex int32 planes holding int16-range samples.
    Output: planar complex int32 planes holding int16-range values, in a
    spec of dtype int32, as in the JAX package (bind each stage of the
    chain on its own spec).
    """

    def __init__(self, fc: float, width: float, order: int, decim: int,
                 ff: float = None):
        super().__init__()
        self.fc = float(fc)
        self.ff = self.fc if ff is None else float(ff)
        self.width = float(width)
        self.order = max(1, int(order))
        self.decim = max(1, int(decim))

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("IQBaseBandInt")
        in_spec.require_block_multiple("IQBaseBandInt", self.decim)
        fs = in_spec.rate_hz
        k = ref_q14_kernel(self.order, self.ff, self.width, fs)
        # Reference tap order: kernel[order-1] multiplies the NEWEST sample.
        self._k_np = (k.real.astype(np.int64), k.imag.astype(np.int64))
        lut = ref_nco_lut()
        self._lut_np = (lut.real.astype(np.int64), lut.imag.astype(np.int64))
        # 8.8 phase increment, truncated (src/freqshift.hh:85).
        self._lut_inc = int(128 * 256 * abs(self.fc) / fs)
        self._neg = self.fc < 0
        self._consts = {}
        return in_spec.with_(
            dtype=torch.int32,  # planar int32 planes, int16-range values
            sample_rate=in_spec.sample_rate / self.decim,
            block_size=in_spec.block_size // self.decim)

    def _on(self, device):
        """(taps re, im, LUT re, im) as int64 tensors on ``device``."""
        key = str(device)
        if key not in self._consts:
            self._consts[key] = tuple(
                torch.as_tensor(v, device=device)
                for v in self._k_np + self._lut_np)
        return self._consts[key]

    def _init_carry(self, device):
        ch = self.in_spec.channels
        return dict(
            tail=cplx.zeros(ch + (self.order - 1,), torch.int32, device),
            lut_count=torch.zeros((), dtype=torch.int32, device=device),
            acc=cplx.zeros(ch, torch.int32, device),  # partial since emit
            emitted=torch.zeros((), dtype=torch.int32, device=device))

    def apply(self, carry, x):
        d = self.decim
        b = x.re.shape[-1]
        dev = x.re.device
        kr, ki, lut_r, lut_i = self._on(dev)
        xcr = torch.cat([carry["tail"].re, x.re.to(torch.int32)], dim=-1)
        xci = torch.cat([carry["tail"].im, x.im.to(torch.int32)], dim=-1)
        # FIR: y[n] = (sum_i k[i] * xc[n+i]) >> 14, int32 wraparound MACs.
        wr, wi = xcr.to(torch.int64), xci.to(torch.int64)
        accr = torch.zeros(wr.shape[:-1] + (b,), dtype=torch.int64,
                           device=dev)
        acci = torch.zeros_like(accr)
        for i in range(self.order):
            sr, si = wr[..., i:i + b], wi[..., i:i + b]
            accr = accr + kr[i] * sr - ki[i] * si
            acci = acci + kr[i] * si + ki[i] * sr
        yr = _w32(accr) >> 14
        yi = _w32(acci) >> 14
        # NCO (skipped entirely when the increment is 0, like the C++).
        if self._lut_inc:
            # (a mod 2^32) mod (128*256) == a mod (128*256): 2^15 divides
            # 2^32, so the int32 counter's wraparound is harmless.
            inc = self._lut_inc % (128 * 256)
            counts = (carry["lut_count"].to(torch.int64)
                      + torch.arange(b, dtype=torch.int64, device=dev) * inc
                      ) % (128 * 256)
            idx = counts >> 8
            if self._neg:
                idx = 127 - idx
            lr, li = lut_r[idx], lut_i[idx]
            y64r, y64i = yr.to(torch.int64), yi.to(torch.int64)
            zr = _w32(lr * y64r - li * y64i) >> 16
            zi = _w32(lr * y64i + li * y64r) >> 16
            new_count = ((carry["lut_count"] + (b * self._lut_inc)
                          % (128 * 256)) % (128 * 256)).to(torch.int32)
        else:
            zr, zi = yr, yi
            new_count = carry["lut_count"]
        new_tail = Complex(xcr[..., b:].clone(), xci[..., b:].clone())
        emitted = torch.ones((), dtype=torch.int32, device=dev)
        if d == 1:
            out = Complex(_wrap16(zr), _wrap16(zi))
            return dict(tail=new_tail, lut_count=new_count,
                        acc=carry["acc"], emitted=emitted), out
        # Averaging decimator with the reference's group phase: after the
        # first (decim+1)-sample group, emissions land every ``decim``
        # samples, at local indices 0, d, 2d, ... except in the first-ever
        # block, where the local-0 emission does not exist.
        n_out = b // d
        if n_out < 2:
            raise ConfigError("IQBaseBandInt: block must hold >= 2 output "
                              "groups (block >= 2*decim)")
        # inclusive sums, exact in int64: sum z[a..e] = cs[e] - cs[a-1]
        csr = torch.cumsum(zr.to(torch.int64), dim=-1)
        csi = torch.cumsum(zi.to(torch.int64), dim=-1)
        em = torch.arange(1, n_out, dtype=torch.int64, device=dev) * d
        gr_rest = _w32(csr[..., em] - csr[..., em - d])
        gi_rest = _w32(csi[..., em] - csi[..., em - d])
        gr0 = _w32(carry["acc"].re.to(torch.int64) + csr[..., 0])
        gi0 = _w32(carry["acc"].im.to(torch.int64) + csi[..., 0])
        first = carry["emitted"] == 0
        pad = torch.zeros_like(gr_rest[..., :1])
        gr_first = torch.cat([_w32(csr[..., d:d + 1]), gr_rest[..., 1:], pad],
                             -1)
        gi_first = torch.cat([_w32(csi[..., d:d + 1]), gi_rest[..., 1:], pad],
                             -1)
        gr_norm = torch.cat([gr0[..., None], gr_rest], dim=-1)
        gi_norm = torch.cat([gi0[..., None], gi_rest], dim=-1)
        sr = torch.where(first, gr_first, gr_norm)
        si = torch.where(first, gi_first, gi_norm)
        out = Complex(_wrap16(_div_trunc(sr, d)), _wrap16(_div_trunc(si, d)))
        # carried partial: z[b-d+1 .. b-1] = cs[b-1] - cs[b-d]
        new_acc = Complex(_w32(csr[..., b - 1] - csr[..., b - d]),
                          _w32(csi[..., b - 1] - csi[..., b - d]))
        return dict(tail=new_tail, lut_count=new_count, acc=new_acc,
                    emitted=emitted), out

    @property
    def first_block_pad(self) -> int:
        """The first block's final output slot is padding (the reference's
        first group absorbs decim+1 samples)."""
        return 1


class FMDemodInt(Processor):
    """Bit-faithful integer FM discriminator (reference:
    src/demod.hh:242-254 FMDemod<int16_t> _process): ``phi[n] =
    fast_atan2(re, im) / 2; y[n] = phi[n-1] - phi[n]`` with int16
    wraparound.

    Input: planar complex; integer planes are used as they are (the
    IQBaseBandInt chain), float planes scaled by ``scale`` onto the
    reference's integer grid.  Output: int32 (int16-range values).

    ``ref_block_quirk=True`` reproduces the reference's per-buffer
    behaviour: its loop starts at i=1, so sample 0 of EVERY buffer never
    enters the discriminator, and out[0] is the reinterpreted real part of
    the first input sample.
    """

    def __init__(self, scale: float = 32767.0, ref_block_quirk: bool = False):
        super().__init__()
        self.scale = float(scale)
        self.ref_block_quirk = bool(ref_block_quirk)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("FMDemodInt")
        return in_spec.with_(dtype=torch.int32)

    def _init_carry(self, device):
        return torch.zeros(self.in_spec.channels, dtype=torch.int32,
                           device=device)

    def apply(self, carry, x):
        if not x.re.is_floating_point():
            re = x.re.to(torch.int32)
            im = x.im.to(torch.int32)
        else:
            re = torch.clamp(torch.round(x.re * self.scale), -32768, 32767
                             ).to(torch.int32)
            im = torch.clamp(torch.round(x.im * self.scale), -32768, 32767
                             ).to(torch.int32)
        phi = _div_trunc(fast_atan2_i16(re, im), 2)
        if self.ref_block_quirk:
            # sample 0 is never demodulated: out[0] = in[0].real, and
            # out[1] uses the previous block's final phi
            prev = torch.cat([carry[..., None], phi[..., 1:-1]], dim=-1)
            y = torch.cat([_wrap16(re[..., :1]),
                           _wrap16(prev - phi[..., 1:])], dim=-1)
        else:
            prev = torch.cat([carry[..., None], phi[..., :-1]], dim=-1)
            # int16 wraparound of (prev - phi), as the C++ int16 does
            y = _wrap16(prev - phi)
        return phi[..., -1].clone(), y


class FMDeemphInt(Processor):
    """Bit-exact integer FM de-emphasis (reference: src/demod.hh:304-351
    FMDeemph<int16_t>): ``alpha = round(1/(1 - exp(-1/(Fs*75e-6))))``; per
    sample ``diff = x - avg`` (int16 wrap), then ``avg += (diff +- alpha/2)
    / alpha`` with C-truncating division.  Sequential in time:
    :func:`deemph_int` runs the block as one launch of ``csrc/fixedpoint.cu``
    on a card and as :func:`deemph_int_plain`, a loop over time, on the
    CPU.
    """

    def __init__(self, tau: float = 75e-6):
        super().__init__()
        self.tau = float(tau)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        fs = in_spec.rate_hz
        self._alpha = int(round(1.0 / (1.0 - math.exp(-1.0 / (fs * self.tau)))))
        return in_spec.with_(dtype=torch.int32)

    def _init_carry(self, device):
        return torch.zeros(self.in_spec.channels, dtype=torch.int32,
                           device=device)

    def apply(self, carry, x):
        return deemph_int(x, carry, self._alpha)


@spanned("wrapper:deemph_int")
def deemph_int(x: torch.Tensor, avg: torch.Tensor, alpha: int):
    """FMDeemphInt's recurrence over one block.

    Args:
      x: (..., T) integer samples (taken as int32).
      avg: (...) int32, the carry: the last output of the block before, on
        x's device.
      alpha: the divisor, an int >= 1 (``half = alpha // 2``).

    Returns:
      (avg' (...) int32, y (..., T) int32) on x's device.

    A CUDA block launches the kernel of ``csrc/fixedpoint.cu`` (one thread a
    channel, the carry in a register, one launch a block, counted in
    ``deemph_int.launches``); nothing in it reads the host, so a pipeline
    holding FMDeemphInt captures into a CUDA graph.  A CPU block takes
    :func:`deemph_int_plain`.  The two agree bit for bit.
    """
    if avg.device != x.device:
        raise ValueError(f"deemph_int: carry on {avg.device}, the block on "
                         f"{x.device}: move the carry "
                         "(interop.state_from_numpy)")
    alpha = int(alpha)
    if alpha < 1:
        raise ValueError(f"deemph_int: alpha must be >= 1, got {alpha}")
    if _plain(x, "deemph_int"):
        return deemph_int_plain(x, avg, alpha)
    return _launch_deemph(x, avg, alpha)


# Kernel launches, counted where they happen.
deemph_int.launches = 0


def deemph_int_plain(x: torch.Tensor, avg: torch.Tensor, alpha: int):
    """Plain version of :func:`deemph_int` (same arguments and results): a
    loop over the block's samples, each step vectorized over the
    channels."""
    half = alpha // 2
    x = x.to(torch.int32)
    ys = torch.empty_like(x)
    for t in range(x.shape[-1]):
        diff = _wrap16(x[..., t] - avg)
        upd = torch.where(diff > 0, _div_trunc(diff + half, alpha),
                          _div_trunc(diff - half, alpha))
        avg = _wrap16(avg + upd)
        ys[..., t] = avg
    return avg, ys


def _launch_deemph(x, avg, alpha):
    """One launch of csrc/fixedpoint.cu's sdr_deemph_int over the block."""
    from libsdr_tpu_torch import _build

    name = "deemph_int"
    lead, t = tuple(x.shape[:-1]), x.shape[-1]
    if tuple(avg.shape) != lead:
        raise ValueError(f"{name}: carry shape {tuple(avg.shape)}, expected "
                         f"{lead}")
    if alpha > 1 << 30:
        raise ValueError(f"{name}: alpha {alpha} outside the kernel's gate")
    dev = x.device
    n = math.prod(lead)
    if n == 0:
        return avg.to(torch.int32), x.to(torch.int32)
    xs = x.to(torch.int32).reshape(n, t).contiguous()
    a_in = avg.to(torch.int32).reshape(n).contiguous()
    y = torch.empty_like(xs)
    a_out = torch.empty_like(a_in)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_deemph_int(xs.data_ptr(), a_in.data_ptr(), y.data_ptr(),
                                a_out.data_ptr(), n, t, alpha,
                                alpha // 2, ctypes.c_void_p(stream))
    _check(name, lib, rc)
    deemph_int.launches += 1
    return a_out.reshape(lead), y.reshape(lead + (t,))
