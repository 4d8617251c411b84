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
  (K3), so several BitStream configurations share one pass over time;
* :func:`window_pack`: the pager scanner's windowed compaction of those
  bytes, the windows in channel order (``csrc/window_pack.cu``).

Each dispatches on the device of ``sym``: a CPU tensor takes its plain
PyTorch version (``*_plain``, beside it), a CUDA tensor launches the
kernels of ``csrc/bitsync.cu`` (``csrc/window_pack.cu``) or raises; each
counts its calls of the kernels in ``<entry>.launches`` (one a call, for
the five kernels the PLL runs) and in ``<entry>.routes`` by the serial
pass's lanes per warp (by the window kernel's route).

:func:`pll_split` emulates the kernels' split on the CPU, step for step:
the majority pass's bit masks (bn and crossed, one 32-bit word per 32
steps), the serial pass that carries only phase and omega and writes an
emit mask, and the bits pass that rebuilds last_bits from per-word and
per-chunk summaries.  The tests hold it against the JAX kernels; nothing
on the card's path calls it.

Layout: lanes first, (M, T) and (M, L-1), the BitStream carry's own layout,
where the JAX kernels take time-major (T, M) and (L-1, M) and pad M to
128-lane rows; no padding here, any M.  The TPU kernels' scheduling knobs
(``set_variant``, ``groups=``) are not ported: the kernels always compute
the majority vote in a parallel pass before the serial loop (the JAX
'split' variant, bit-identical to its 'ring'); the serial pass's layout
on the card follows from M (:func:`lanes_per_warp`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libsdr_tpu_torch.core.ragged import Ragged, compact_windows
from libsdr_tpu_torch.ops.fir_fm import _check, _plain, _small
from libsdr_tpu_torch.utils.profiling import spanned

# The kernels' largest majority window (csrc/bitsync.cu, kMaxWindow).
MAX_WINDOW = 896
# Steps in a mask word and words in a chunk of the bits pass
# (csrc/bitsync.cu, kChunkWords).
WORD_STEPS = 32
CHUNK_WORDS = 32
# The serial pass's layouts: lanes per warp.
LANES_PER_WARP = (1, 2, 4, 8, 16, 32)
# window_pack's routes, by csrc/window_pack.cu's number: 16-byte vectors
# (T a multiple of 16, w a power of two up to 64), else a byte a load.
WINDOW_ROUTES = ("vector", "bytes")


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


def _to_words(bits, w):
    """(M, T) bool as (M, W) int64 mask words: bit k of word j is step
    32j + k, the steps past T zero."""
    m, t = bits.shape
    pad = torch.zeros(m, w * WORD_STEPS, dtype=torch.int64)
    pad[:, :t] = bits.to(torch.int64)
    shifts = torch.arange(WORD_STEPS, dtype=torch.int64)
    return (pad.view(m, w, WORD_STEPS) << shifts).sum(-1)


def _word_bits(words, t):
    """The inverse of :func:`_to_words`: (M, W) words as (M, T) bool."""
    shifts = torch.arange(WORD_STEPS, dtype=torch.int64)
    return ((words[..., None] >> shifts) & 1).flatten(1)[:, :t].bool()


def _summaries(e, b):
    """The summary of each word with emit mask e and bn mask b: its emit
    count n capped at 16 in bits 16-20, the bn bits of its last n emits in
    bits 0-15, the latest in bit 0."""
    n = torch.zeros_like(e)
    bits = torch.zeros_like(e)
    for k in range(WORD_STEPS - 1, -1, -1):
        take = (((e >> k) & 1) == 1) & (n < 16)
        bits = torch.where(take, bits | (((b >> k) & 1) << n), bits)
        n = n + take.to(torch.int64)
    return n << 16 | bits


def _compose(s1, s2):
    """The summary of run s1 followed by run s2."""
    n2 = s2 >> 16
    n = torch.clamp((s1 >> 16) + n2, max=16)
    return n << 16 | ((((s1 & 0xFFFF) << n2) | s2) & 0xFFFF)


def _apply(lb, s):
    """last_bits after a run with summary s, from lb before it."""
    n = s >> 16
    return torch.where(n == 0, lb, ((lb << n) | s) & 0xFFFF)


def _phase_chain(cr_w, t, phase, omega, omin, omax, gain):
    """The serial pass: phase and omega alone over the crossed mask words,
    the nudge (clamped) only at crossing steps and the clamp alone only at
    the block's first step; returns the emit mask words, phase', omega'."""
    cr = _word_bits(cr_w, t).t().numpy()
    m = cr.shape[1]
    ph = phase.float().cpu().numpy().copy()
    om = omega.float().cpu().numpy().copy()
    g = gain.to(torch.float64).cpu().numpy()
    lo, hi = omin.float().cpu().numpy(), omax.float().cpu().numpy()
    one, half = np.float32(1.0), np.float32(0.5)
    emits = np.empty((t, m), bool)
    for k in range(t):
        ph = ph + om
        e = ph >= one
        ph = np.where(e, ph - one, ph)
        emits[k] = e
        c = cr[k]
        if k == 0 or c.any():
            nudged = (om.astype(np.float64) + g * (half - ph)).astype(
                np.float32)
            clamped = np.minimum(np.maximum(np.where(c, nudged, om), lo), hi)
            om = clamped if k == 0 else np.where(c, clamped, om)
    emit_w = _to_words(torch.from_numpy(emits.T.copy()), cr_w.shape[1])
    return emit_w, torch.from_numpy(ph), torch.from_numpy(om)


def _bits_pass(emit_w, bn_w, lb_in, trans, t, chunk_words):
    """The bits pass: each word's summary composed over its chunk so far,
    the chunks' summaries scanned from lb_in, and each word's output bytes
    from the last_bits entering it.  Returns (out (M, T) uint8, lb')."""
    m, w = emit_w.shape
    nc = -(-w // chunk_words)
    s = torch.zeros(m, nc * chunk_words, dtype=torch.int64)
    s[:, :w] = _summaries(emit_w, bn_w)
    s = s.view(m, nc, chunk_words)
    scan = torch.empty_like(s)
    acc = torch.zeros(m, nc, dtype=torch.int64)
    for j in range(chunk_words):
        acc = _compose(acc, s[:, :, j])
        scan[:, :, j] = acc
    lb = lb_in.to(torch.int64).cpu()
    enter = torch.empty(m, nc, dtype=torch.int64)
    for c in range(nc):
        enter[:, c] = lb
        lb = _apply(lb, scan[:, c, -1])
    ent = enter[:, :, None].expand(m, nc, chunk_words).clone()
    ent[:, :, 1:] = _apply(ent[:, :, 1:], scan[:, :, :-1])
    x = ent.reshape(m, -1)[:, :w]
    tr = trans.cpu().bool()[:, None]
    out = torch.empty(m, w, WORD_STEPS, dtype=torch.int64)
    for k in range(WORD_STEPS):
        ek = (emit_w >> k) & 1
        x = torch.where(ek == 1, (x << 1) | ((bn_w >> k) & 1), x)
        bit = torch.where(tr, (x ^ (x >> 1) ^ 1) & 1, x & 1)
        out[:, :, k] = bit | ek << 1
    return out.flatten(1)[:, :t].to(torch.uint8), lb.to(torch.int32)


def pll_split(sym, signs, sym_sum, phase, omega, last_bits, *, omega_min,
              omega_max, gain, transition, ell=None,
              chunk_words=CHUNK_WORDS):
    """The kernels' decomposition emulated on the CPU: the majority pass's
    mask words, the serial pass over phase and omega writing emit words,
    and the bits pass through per-word and per-chunk summaries
    (``chunk_words`` words a chunk; the kernels take CHUNK_WORDS).  Same
    arguments and results as :func:`pll_bank` (``ell`` None: every lane's
    window is R + 1, as in :func:`pll`); parameters are scalars or (M,)
    array-likes."""
    m, t = sym.shape
    dev = sym.device
    r = signs.shape[1]
    ell = _check_ell(r + 1 if ell is None else ell, r)
    ell, omin, omax, gain, trans = (
        _lanes(v, m, d, "cpu") for v, d in (
            (ell, torch.int32), (omega_min, torch.float32),
            (omega_max, torch.float32), (gain, torch.float32),
            (transition, torch.int32)))
    bn, crossed, ss, sg = _majority_plain(sym.cpu(), signs.cpu(),
                                          sym_sum.cpu(), ell)
    w = -(-t // WORD_STEPS)
    bn_w, cr_w = _to_words(bn, w), _to_words(crossed, w)
    emit_w, ph, om = _phase_chain(cr_w, t, phase, omega, omin, omax, gain)
    out, lb = _bits_pass(emit_w, bn_w, last_bits, trans, t, chunk_words)
    return tuple(v.to(dev) for v in (out, sg, ss, ph, om, lb))


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


@spanned("wrapper:pll")
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


@spanned("wrapper:pll_bank")
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


# Kernel launches, counted where they happen, in all and by lanes per warp.
pll.launches = 0
pll_bank.launches = 0
pll.routes = dict.fromkeys(LANES_PER_WARP, 0)
pll_bank.routes = dict.fromkeys(LANES_PER_WARP, 0)


def window_pack_plain(out, window: int, rows=None):
    """Plain PyTorch version of :func:`window_pack` (same arguments and
    result): the bits and flags split, each window's masked sum and any
    (``core/ragged.compact_windows``), the row gather and the packing."""
    r = compact_windows(Ragged(out & 1, (out & 2) != 0), window)
    data, valid = (r.data, r.valid) if rows is None else (r.data[rows],
                                                          r.valid[rows])
    return data | (valid.to(torch.uint8) << 1)


@spanned("wrapper:window_pack")
def window_pack(out, window: int, rows=None):
    """The windows of the PLL's packed bytes, in one pass.

    Args:
      out: (M, T) uint8, lanes first, bit 0 the sampled bit and bit 1 its
        valid flag (:func:`pll`'s first result).
      window: w >= 1, dividing T.
      rows: None, or (C,) integer row map within 0..M-1: output row c
        reads input row ``rows[c]`` (on the card a map already there is
        not range-checked: that would wait for the card).

    Returns:
      (C, T/w) uint8 (C = M without ``rows``): byte (c, j) is the sum,
      wrapping mod 256, of bit * valid over the window's w steps of row
      ``rows[c]``, or-ed with (any valid) << 1.  Where the PLL's bit gap
      leaves at most one valid step a window (``core/ragged.min_valid_gap``)
      that is the window's bit and flag, packed as the PLL packs them.

    A CUDA tensor launches ``csrc/window_pack.cu`` (counted in
    ``window_pack.launches`` and ``window_pack.routes``); a CPU tensor
    takes :func:`window_pack_plain`.  The two agree bit for bit.
    """
    name = "window_pack"
    if out.dtype != torch.uint8 or out.ndim != 2:
        raise ValueError(f"{name}: out must be (M, T) uint8, got "
                         f"{tuple(out.shape)} {out.dtype}")
    m, t = out.shape
    w = int(window)
    if w < 1 or t % w:
        raise ValueError(f"{name}: window {w} must be >= 1 and divide "
                         f"T={t}")
    if rows is not None:
        rows = torch.as_tensor(rows)
        if rows.ndim != 1 or rows.dtype.is_floating_point or \
                rows.dtype == torch.bool:
            raise ValueError(f"{name}: rows must be a 1-D integer map, got "
                             f"{tuple(rows.shape)} {rows.dtype}")
        if rows.device.type == "cpu" and rows.numel() and (
                int(rows.min()) < 0 or int(rows.max()) >= m):
            raise ValueError(f"{name}: rows outside 0..{m - 1}")
        rows = rows.to(out.device, torch.int64)
    if _plain(out, name):
        return window_pack_plain(out, w, rows)
    return _launch_window_pack(out, w, rows)


# Kernel launches, counted where they happen, in all and by route.
window_pack.launches = 0
window_pack.routes = dict.fromkeys(WINDOW_ROUTES, 0)


def _launch_window_pack(out, w, rows):
    """One launch of csrc/window_pack.cu's sdr_window_pack."""
    from libsdr_tpu_torch import _build

    name = "window_pack"
    m, t = out.shape
    dev = out.device
    src = out.contiguous()
    c = m if rows is None else rows.shape[0]
    y = torch.empty((c, t // w), dtype=torch.uint8, device=dev)
    if y.numel() == 0:
        return y
    lib = _build.library()
    route = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_window_pack(src.data_ptr(),
                                 None if rows is None else rows.data_ptr(),
                                 y.data_ptr(), m, c, t, w,
                                 ctypes.c_void_p(stream), ctypes.byref(route))
    _check(name, lib, rc)
    window_pack.launches += 1
    window_pack.routes[WINDOW_ROUTES[route.value]] += 1
    return y


def lanes_per_warp(m: int) -> int:
    """The serial pass's lanes per warp for an M-lane call on the card
    (csrc/bitsync.cu's rule, sdr_pll_lanes_per_warp)."""
    from libsdr_tpu_torch import _build
    return _build.library().sdr_pll_lanes_per_warp(m)


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
    lib = _build.library()
    lanes = lanes_per_warp(m)
    scratch = torch.empty(lib.sdr_pll_scratch_words(m, t), dtype=torch.int32,
                          device=dev)
    out = torch.empty((m, t), dtype=torch.uint8, device=dev)
    ss2 = torch.empty(m, dtype=torch.int32, device=dev)
    ph2 = torch.empty(m, dtype=torch.float32, device=dev)
    om2 = torch.empty(m, dtype=torch.float32, device=dev)
    lb2 = torch.empty(m, dtype=torch.int32, device=dev)
    ptrs = [None] * 5 if vec is None else [v.data_ptr() for v in vec]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_pll(sym.data_ptr(), sg.data_ptr() if r else None,
                         ss.data_ptr(), ph.data_ptr(), om.data_ptr(),
                         lb.data_ptr(), *ptrs, *scal, scratch.data_ptr(),
                         out.data_ptr(), ss2.data_ptr(), ph2.data_ptr(),
                         om2.data_ptr(), lb2.data_ptr(), m, t, r,
                         ctypes.c_void_p(stream))
    _check(name, lib, rc)
    entry.launches += 1
    entry.routes[lanes] += 1
    # The carried signs: the last R of concat(signs, this block's signs).
    new = torch.where(sym[:, max(0, t - r):] > 0, 1, -1).to(torch.int32)
    sg2 = torch.cat([sg[:, sg.shape[1] - (r - new.shape[1]):], new],
                    dim=1) if new.shape[1] < r else new
    return out, sg2, ss2, ph2, om2, lb2
