"""Bit-clock recovery, majority vote + PLL, for a bank of lanes: the
counterpart of ``libsdr_tpu.ops.pallas_bitsync`` (``pll_pallas`` and
``pll_pallas_bank``).

For sym (M, T) uint8 symbols and each lane's carried state, every step runs
the recurrence of ``csrc/bitsync.cu``: the majority vote over the lane's
last L symbols (a windowed sign sum and its zero crossing), the phase
accumulator that samples one bit when it wraps past 1, and on each
crossing the bounded frequency nudge ``omega = fma(gain, 0.5 - phase,
omega)`` rounded once, as XLA's fused multiply-add rounds it in the JAX
package.  Every output byte packs the sampled bit (bit 0) and its valid
flag (bit 1).

Entries:

* :func:`pll`: every lane with the same parameters (the TPU kernel K2);
* :func:`pll_bank`: per-lane omega bounds, gain, bit mapping and window L
  (K3), so several BitStream configurations share one pass over time.

Each dispatches on the device of ``sym``: a CPU tensor takes its plain
PyTorch version (``*_plain``, beside it), a CUDA tensor launches the
kernels of ``csrc/bitsync.cu`` or raises; each counts its kernel launches
in ``<entry>.launches``.

Layout: lanes first, (M, T) and (M, L-1), the BitStream carry's own layout,
where the JAX kernels take time-major (T, M) and (L-1, M) and pad M to
128-lane rows; no padding here, any M.  The TPU kernels' scheduling knobs
(``set_variant``, ``groups=``) are not ported: this kernel always computes
the majority vote in a parallel pass before the serial loop (the JAX
'split' variant, bit-identical to its 'ring').
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libsdr_tpu_torch.ops.fir_fm import _check, _plain, _small

# The kernels' largest majority window (csrc/bitsync.cu, kMaxWindow).
MAX_WINDOW = 896


def _majority_plain(sym, signs, sym_sum, ell):
    """bn, crossed (M, T) and the last window sum (M,), vectorized over
    time: the windowed sign sums are exact int64 cumsum differences."""
    m, t = sym.shape
    r = signs.shape[1]
    new = torch.where(sym > 0, 1, -1).to(torch.int64)
    full = torch.cat([signs.to(torch.int64), new], dim=1)      # (M, R + T)
    cz = torch.cat([torch.zeros(m, 1, dtype=torch.int64, device=sym.device),
                    torch.cumsum(full, dim=1)], dim=1)
    hi = cz[:, r + 1:]                                         # (M, T)
    lo_idx = (r + 1 - ell.to(torch.int64))[:, None] + torch.arange(
        t, device=sym.device)[None, :]
    s = hi - torch.gather(cz, 1, lo_idx)
    last = torch.cat([sym_sum.to(torch.int64)[:, None], s[:, :-1]], dim=1)
    crossed = (last < 0) != (s < 0)
    return s > 0, crossed, s[:, -1].to(torch.int32), full[
        :, full.shape[1] - r:].to(torch.int32)


def _pll_plain(sym, signs, sym_sum, phase, omega, last_bits, omin, omax,
               gain, trans, ell):
    """The recurrence with per-lane parameter tensors (M,): the majority
    vote vectorized in PyTorch, then the loop over time, vectorized over
    lanes, on the host in numpy (a step of small PyTorch ops costs about
    five times as much).  The nudge is computed in float64 and rounded to
    float32 once, which equals the fused multiply-add except where the
    float64 sum falls exactly on a float32 rounding midpoint."""
    bn, crossed, ss, sg = _majority_plain(sym, signs, sym_sum, ell)
    dev = sym.device
    bn = bn.t().to(torch.int32).cpu().numpy()
    cr = crossed.t().cpu().numpy()
    t, m = bn.shape
    ph = phase.float().cpu().numpy().copy()
    om = omega.float().cpu().numpy().copy()
    lb = last_bits.to(torch.int32).cpu().numpy().copy()
    g = gain.to(torch.float64).cpu().numpy()
    lo, hi = omin.float().cpu().numpy(), omax.float().cpu().numpy()
    one, half = np.float32(1.0), np.float32(0.5)
    emits = np.empty((t, m), bool)
    lbs = np.empty((t, m), np.int32)
    for k in range(t):
        ph = ph + om
        e = ph >= one
        ph = np.where(e, ph - one, ph)
        lb = np.where(e, ((lb << 1) | bn[k]) & 0xFFFF, lb)
        emits[k] = e
        lbs[k] = lb
        nudged = (om.astype(np.float64) + g * (half - ph)).astype(np.float32)
        om = np.minimum(np.maximum(np.where(cr[k], nudged, om), lo), hi)
    bit = np.where(trans.bool().cpu().numpy()[None, :],
                   (lbs ^ (lbs >> 1) ^ 1) & 1, lbs & 1)
    out = (bit | (emits.astype(np.int32) << 1)).astype(np.uint8).T

    def back(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return back(out), sg, ss, back(ph), back(om), back(lb)


def _lanes(v, m, dtype, device):
    """A per-lane parameter: a scalar or an (M,) array-like, as an (M,)
    tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(device, dtype).reshape(m)
    a = np.asarray(v)
    if a.ndim == 0:
        return torch.full((m,), a.item(), dtype=dtype, device=device)
    return torch.as_tensor(a.reshape(m), dtype=dtype, device=device)


def pll_plain(sym, signs, sym_sum, phase, omega, last_bits, *, omega_min,
              omega_max, gain, transition):
    """Plain PyTorch version of :func:`pll` (same arguments and results)."""
    m = sym.shape[0]
    dev = sym.device
    return _pll_plain(sym, signs, sym_sum, phase, omega, last_bits,
                      _lanes(omega_min, m, torch.float32, dev),
                      _lanes(omega_max, m, torch.float32, dev),
                      _lanes(gain, m, torch.float32, dev),
                      _lanes(int(bool(transition)), m, torch.int32, dev),
                      _lanes(signs.shape[1] + 1, m, torch.int32, dev))


def pll(sym, signs, sym_sum, phase, omega, last_bits, *, omega_min: float,
        omega_max: float, gain: float, transition: bool):
    """Majority vote + PLL over one block, every lane alike.

    Args:
      sym: (M, T) uint8 symbols (nonzero = mark).
      signs: (M, L-1) int32, the lane's previous L-1 signs (+1/-1, or 0 at
        the start), oldest first; L is the majority window (at most
        MAX_WINDOW on the card).
      sym_sum: (M,) int32, the previous window sum.
      phase, omega: (M,) float32; last_bits: (M,) int32.
      omega_min, omega_max, gain: the PLL's bounds and nudge gain.
      transition: NRZI bit mapping (transition -> 0) instead of NRZ.

    Returns:
      (out (M, T) uint8 with bit 0 the sampled bit and bit 1 its valid
      flag, signs', sym_sum', phase', omega', last_bits').
    """
    if _plain(sym, "pll"):
        return pll_plain(sym, signs, sym_sum, phase, omega, last_bits,
                         omega_min=omega_min, omega_max=omega_max, gain=gain,
                         transition=transition)
    scal = (float(omega_min), float(omega_max), float(gain),
            int(bool(transition)), signs.shape[1] + 1)
    return _launch(pll, sym, signs, sym_sum, phase, omega, last_bits, None,
                   scal)


def pll_bank_plain(sym, signs, sym_sum, phase, omega, last_bits, *,
                   omega_min, omega_max, gain, transition, ell):
    """Plain PyTorch version of :func:`pll_bank`."""
    m = sym.shape[0]
    dev = sym.device
    ell = _lanes(_check_ell(ell, signs.shape[1]), m, torch.int32, dev)
    return _pll_plain(sym, signs, sym_sum, phase, omega, last_bits,
                      _lanes(omega_min, m, torch.float32, dev),
                      _lanes(omega_max, m, torch.float32, dev),
                      _lanes(gain, m, torch.float32, dev),
                      _lanes(transition, m, torch.int32, dev), ell)


def pll_bank(sym, signs, sym_sum, phase, omega, last_bits, *, omega_min,
             omega_max, gain, transition, ell):
    """Majority vote + PLL with per-lane parameters, in one pass over time.

    Args as for :func:`pll`, except:
      signs: (M, R) int32 with R = max(ell) - 1: each lane's previous signs
        in its LAST ell-1 columns, oldest first (the columns before them are
        not read).
      omega_min, omega_max, gain: (M,) float32 array-likes; transition and
        ell (the majority window, 1 <= ell <= R + 1, and at most
        MAX_WINDOW on the card): (M,) integer array-likes, checked on the
        host.

    Returns the tuple of :func:`pll`; signs' holds each lane's last R signs
    (the lane's own window in its last ell-1 columns).  Lane by lane this
    equals :func:`pll` run with that lane's parameters.
    """
    if _plain(sym, "pll_bank"):
        return pll_bank_plain(sym, signs, sym_sum, phase, omega, last_bits,
                              omega_min=omega_min, omega_max=omega_max,
                              gain=gain, transition=transition, ell=ell)
    m = sym.shape[0]
    ell = _check_ell(ell, signs.shape[1], MAX_WINDOW)
    dts = (torch.float32,) * 3 + (torch.int32,) * 2
    vec = tuple(_lanes(v, m, d, sym.device) for v, d in zip(
        (omega_min, omega_max, gain, transition, ell), dts))
    return _launch(pll_bank, sym, signs, sym_sum, phase, omega, last_bits,
                   vec, (0.0, 0.0, 0.0, 0, 0))


# Kernel launches, counted where they happen.
pll.launches = 0
pll_bank.launches = 0


def _check_ell(ell, r, most=None):
    """The per-lane windows as a host int32 array, within 1..R+1 and at
    most ``most``."""
    if isinstance(ell, torch.Tensor):
        ell = ell.cpu().numpy()
    ell = np.asarray(ell, np.int32)
    hi = r + 1 if most is None else min(r + 1, most)
    if ell.size and (ell.min() < 1 or ell.max() > hi):
        raise ValueError(f"pll_bank: windows {ell.min()}..{ell.max()} "
                         f"outside 1..{hi} (signs has {r} columns)")
    return ell


def _launch(entry, sym, signs, sym_sum, phase, omega, last_bits, vec, scal):
    """One call of csrc/bitsync.cu's sdr_pll: vec holds the per-lane
    vectors (omin, omax, gain, transition, ell) or is None for the scalars
    scal."""
    from libsdr_tpu_torch import _build

    name = entry.__name__
    if sym.dtype != torch.uint8 or sym.ndim != 2:
        raise ValueError(f"{name}: sym must be (M, T) uint8, got "
                         f"{tuple(sym.shape)} {sym.dtype}")
    m, t = sym.shape
    r = signs.shape[-1]
    dev = sym.device
    small = _small(name, dev)
    sym = sym.contiguous()
    sg = small(signs, torch.int32, (m, r))
    ss = small(sym_sum, torch.int32, (m,))
    ph = small(phase, torch.float32, (m,))
    om = small(omega, torch.float32, (m,))
    lb = small(last_bits, torch.int32, (m,))
    bncr = torch.empty((m, t), dtype=torch.uint8, device=dev)
    out = torch.empty((m, t), dtype=torch.uint8, device=dev)
    ss2 = torch.empty(m, dtype=torch.int32, device=dev)
    ph2 = torch.empty(m, dtype=torch.float32, device=dev)
    om2 = torch.empty(m, dtype=torch.float32, device=dev)
    lb2 = torch.empty(m, dtype=torch.int32, device=dev)
    ptrs = [None] * 5 if vec is None else [v.data_ptr() for v in vec]
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_pll(sym.data_ptr(), sg.data_ptr() if r else None,
                         ss.data_ptr(), ph.data_ptr(), om.data_ptr(),
                         lb.data_ptr(), *ptrs, *scal, bncr.data_ptr(),
                         out.data_ptr(), ss2.data_ptr(), ph2.data_ptr(),
                         om2.data_ptr(), lb2.data_ptr(), m, t, r,
                         ctypes.c_void_p(stream))
    _check(name, lib, rc)
    entry.launches += 1
    # The carried signs: the last R of concat(signs, this block's signs).
    new = torch.where(sym[:, max(0, t - r):] > 0, 1, -1).to(torch.int32)
    sg2 = torch.cat([sg[:, sg.shape[1] - (r - new.shape[1]):], new],
                    dim=1) if new.shape[1] < r else new
    return out, sg2, ss2, ph2, om2, lb2
