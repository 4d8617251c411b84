"""The tensor-core route of the decimating FIR (``csrc/fir_tc.cu``): its
layout and a plain emulation of its arithmetic.

Every mode of K1 (``ops/fir_fm.py``: ``fir_fm_exact``, ``fir_exact``,
``fir_am_exact``, ``fir_usb_exact``, ``fir_afsk_exact``), K5 and K6
(``ops/fir_mxu.py``: ``fir_mxu`` / ``fir_offset``, ``fir_fm_mxu``) launch
the tensor-core kernel at the strides of their cuts where its plan fits in
shared memory (``csrc/fir_common.cuh::route_of`` and ``tc_stride``; the
cuts are listed in ``ops/fir_fm.py``); this module holds what that
kernel's arithmetic and layout are, in plain PyTorch, so that the CPU
tests reach them:

* :func:`tc_plan`: the kernel's plan of a shape, the rule of
  ``fir_tc.cu::tc_plan`` (frames of S outputs with S*D a multiple of 8,
  fewest ldmatrix bank conflicts, then the largest S; 64 frames a tile
  where two blocks fit an SM, else 32 or 16);
* :func:`tap_matrix`: the (2Kp, 2S) tap matrix ``[[Gr, Gi], [-Gi, Gr]]``,
  ``G[k, s] = g[k - s*D]``, columns interleaved (Re y, Im y) of each
  output; :func:`tap_blocks`: its band, split into bf16 hi and lo, in the
  kernel's shared-memory order;
* :func:`frames`: the GEMM rows, each frame's window of Kp samples of a
  span, real and imaginary planes side by side;
* :func:`fir_y_split`: y as the kernel computes it, the frame GEMM in 3, 2
  or 1 bf16 passes with float32 sums (``passes=None``: one float32 GEMM),
  and :func:`fm_exact_split`, :func:`fir_exact_split`,
  :func:`am_exact_split`, :func:`usb_exact_split`, :func:`fir_mxu_split`
  (over K5's span from any window start, :func:`span_k5`) and
  :func:`fm_mxu_split`, the results of K1a, K1b, K1c, K1d, K5 and K6 with
  it;
* mode afsk's correlator: :func:`blocked_sums` (the window sums in
  float32, blocked by the epilogue's four outputs a thread) and
  :func:`afsk_exact_split`, K1e's results, chunk by chunk from each
  chunk's L-early start.  The JAX kernel sums the windows as a 0/1 band
  product on its matrix unit (``pallas_fir_mxu.py::wmm``); on the tensor
  cores that band product, f32-accurate in three bf16 parts, measured
  slower than these sums (PERF.md).

The passes are the TPU kernel's (``libsdr_tpu/ops/pallas_fir_mxu.py::
_make_mm``): float32 planes ``x_hi*g_hi + x_hi*g_lo + x_lo*g_hi``, bfloat16
planes ``x*g_hi + x*g_lo``, and after ``set_mxu_precision('fast')`` one
pass ``x_hi*g_hi``.  :func:`passes_for` gives the count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops.fir import _n_taps, _taps_planes, full_f32

# Shared memory of an H100 (SXM): the most a block may opt in to, and an
# SM's (two blocks an SM each reserve 1 KB of it).
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
MAX_NT = 4      # n-tiles (8 columns, 4 outputs) a frame, at most
THREADS = 256   # a block
SLOTS = THREADS * 4   # epilogue outputs a tile (4 a thread)
HEADER = 128    # mbarriers, carried state, scan scratch


class TcPlan(NamedTuple):
    S: int      # outputs a frame
    F: int      # frames a tile: 64, 32 or 16
    Kp: int     # a frame's window, padded to a multiple of 16
    NTL: int    # n-tiles a frame
    KBW: int    # k-tiles of the widest n-tile band
    LA: int     # samples of each converted array
    CAP: int    # samples of a raw stage buffer of one plane
    bytes: int  # shared memory of a block


def passes_for(dtype, fast: bool) -> int:
    """bf16 passes of the kernel: 1 with 'fast', else 3 for float32 planes
    and 2 for bfloat16 planes (their samples are exact in bf16)."""
    if fast:
        return 1
    return 2 if dtype == torch.bfloat16 else 3


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def band(nt: int, s: int, d: int, t: int, kt: int) -> tuple[int, int]:
    """k-tiles [lo, hi) of n-tile nt's nonzero taps (outputs 4nt..4nt+3)."""
    s_hi = min(4 * nt + 3, s - 1)
    return (4 * nt * d) // 16, min(kt, -(-(s_hi * d + t) // 16))


def ldsm_ways(stride: int) -> int:
    """Bank-conflict degree of 8 ldmatrix rows ``stride`` bytes apart."""
    slots = [r * stride % 128 // 16 for r in range(8)]
    return max(slots.count(v) for v in slots)


def make_plan(t: int, d: int, itemsize: int, passes: int, s: int,
              f: int, ell: int = 0) -> TcPlan:
    kp = _round_up((s - 1) * d + t, 16)
    kt = kp // 16
    ntl = -(-s // 4)
    kbw = max(hi - lo for lo, hi in (band(nt, s, d, t, kt)
                                     for nt in range(ntl)))
    per = 16 // itemsize
    la = _round_up((f - 1) * s * d + kp, 8)
    cap = _round_up(max((f * s - 1) * d + t, la) + 2 * per, per)
    ys = 8 * (SLOTS - 1 + (SLOTS - 1) // 4 + 1)
    span = max((4 if passes == 3 else 2) * la * 2, ys)
    a_off = HEADER + 4 * cap * itemsize
    extra = 0
    if ell:
        # mode afsk: the prefix sums over the converted span behind the
        # epilogue's slots; their history and the templates after the taps
        hb = history_blocks(ell)
        p_rel = _round_up(a_off + ys, 16) - a_off
        span = max(span, p_rel + 4 * (hb + THREADS) * 16)
        extra = 4 * hb * 16 + 16 * ell
    total = a_off + _round_up(span, 16) + 2 * ntl * kbw * 512 + extra
    return TcPlan(s, f, kp, ntl, kbw, la, cap, total)


def tc_plan(t: int, d: int, itemsize: int, passes: int,
            smem_block: int = SMEM_BLOCK, smem_sm: int = SMEM_SM,
            ell: int = 0) -> Optional[TcPlan]:
    """The kernel's plan of a shape (``fir_tc.cu::tc_plan``; ell: mode
    afsk's window, 0 in the other modes), or None when none fits in shared
    memory (the launch then takes the staged or warp kernel)."""
    if t < 1 or d < 1:
        return None
    cands = sorted((s for s in range(4 * MAX_NT, 0, -1) if s * d % 8 == 0),
                   key=lambda s: (ldsm_ways(2 * s * d), -s))
    for limit in (smem_sm // 2 - 1024, smem_block):
        for mw in (4, 2, 1):
            for s in cands:
                plan = make_plan(t, d, itemsize, passes, s, 16 * mw, ell)
                if plan.bytes <= limit:
                    return plan
    return None


def mma_ops(t: int, d: int, plan: TcPlan, passes: int) -> float:
    """Tensor-core operations an output as the kernel runs them: each frame
    of S outputs takes, for each of the two plane halves and each n-tile,
    one m16n8k16 product (2*16*8*16 operations for 16 frames) per k-tile
    of the band and pass."""
    kt = plan.Kp // 16
    tiles = sum(hi - lo for lo, hi in (band(nt, plan.S, d, t, kt)
                                       for nt in range(plan.NTL)))
    return 2 * tiles * passes * (2 * 16 * 8 * 16) / 16 / plan.S


def split_bf16(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 values as float32 tensors holding bf16 numbers:
    hi = bf16(v) rounded to nearest, lo = bf16(v - hi)."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _taps(taps, device) -> tuple[torch.Tensor, torch.Tensor]:
    gr, gi = _taps_planes(taps, torch.float32, device)
    return gr, torch.zeros_like(gr) if gi is None else gi


def tap_matrix(taps, d: int, s: int, kp: int, device="cpu") -> torch.Tensor:
    """The (2Kp, 2S) float32 tap matrix: rows k < Kp multiply a frame's real
    samples, rows Kp + k its imaginary ones; column 2s is Re y[s] and 2s+1
    Im y[s]: ``[[Gr, Gi], [-Gi, Gr]]`` with ``G[k, s] = g[k - s*D]``."""
    gr, gi = _taps(taps, device)
    t = gr.shape[0]
    k = torch.arange(kp, device=device)[:, None]
    i = k - d * torch.arange(s, device=device)[None, :]
    inside = (i >= 0) & (i < t)
    ic = i.clamp(0, t - 1)
    g_r = torch.where(inside, gr[ic], 0.0)
    g_i = torch.where(inside, gi[ic], 0.0)
    m = torch.empty((2 * kp, 2 * s), dtype=torch.float32, device=device)
    m[:kp, 0::2], m[:kp, 1::2] = g_r, g_i
    m[kp:, 0::2], m[kp:, 1::2] = -g_i, g_r
    return m


def tap_blocks(taps, d: int, plan: TcPlan, device="cpu") -> torch.Tensor:
    """The tap matrix's band as the kernel stores it in shared memory:
    (2 halves, NTL n-tiles, KBW k-tiles, 2 (hi, lo), 2 (k 0-7, 8-15),
    8 columns, 8 k) bfloat16, block [h, nt, kb] holding rows
    16*(lo + kb) .. + 15 of half h and columns 8nt .. 8nt + 7, lo the band's
    first k-tile; zeros past the band."""
    t = _n_taps(taps)
    kt = plan.Kp // 16
    ntl, kbw = plan.NTL, plan.KBW
    dense = torch.zeros((2 * plan.Kp, 8 * ntl), dtype=torch.float32,
                        device=device)
    dense[:, :2 * plan.S] = tap_matrix(taps, d, plan.S, plan.Kp, device)
    hi, lo_part = split_bf16(dense)
    out = torch.zeros((2, ntl, kbw, 2, 2, 8, 8), dtype=torch.bfloat16,
                      device=device)
    for h in range(2):
        for nt in range(ntl):
            lo, top = band(nt, plan.S, d, t, kt)
            for kb in range(top - lo):
                rows = slice(h * plan.Kp + 16 * (lo + kb),
                             h * plan.Kp + 16 * (lo + kb) + 16)
                for hl, part in enumerate((hi, lo_part)):
                    blk = part[rows, 8 * nt:8 * nt + 8]   # (16 k, 8 n)
                    out[h, nt, kb, hl] = blk.reshape(2, 8, 8).transpose(
                        1, 2).to(torch.bfloat16)
    return out


def frames(span: Complex, s: int, d: int, kp: int, n_frames: int
           ) -> torch.Tensor:
    """The GEMM rows of a span (C, L) of samples starting at output 0's
    window: frame f's window is samples f*S*D .. f*S*D + Kp - 1 (zeros past
    the span), real then imaginary: (C, n_frames, 2Kp)."""
    need = (n_frames - 1) * s * d + kp
    pad = max(0, need - span.re.shape[-1])

    def rows(v):
        v = torch.nn.functional.pad(v.float(), (0, pad))[..., :need]
        return v.unfold(-1, kp, s * d)

    return torch.cat([rows(span.re), rows(span.im)], dim=-1)


def fir_y_split(span: Complex, taps, d: int, n_out: int,
                passes: Optional[int] = 3, s: Optional[int] = None
                ) -> Complex:
    """y[j] = sum_i g[i] * span[j*D + i] for j < n_out, as the frame GEMM
    of the tensor-core kernel: rows :func:`frames`, matrix
    :func:`tap_matrix`, in ``passes`` bf16 passes (3: a_hi*b_hi + a_hi*b_lo
    + a_lo*b_hi, 2: a_hi*b_hi + a_hi*b_lo, 1: a_hi*b_hi) with float32 sums,
    or with ``passes=None`` one float32 GEMM.  s: outputs a frame (the
    plan's by default)."""
    t = _n_taps(taps)
    dev = span.re.device
    if s is None:
        plan = tc_plan(t, d, 4, 3)
        s = plan.S if plan is not None else 8
    kp = _round_up((s - 1) * d + t, 16)
    n_frames = -(-n_out // s)
    a = frames(span, s, d, kp, n_frames)
    m = tap_matrix(taps, d, s, kp, dev)
    with full_f32():
        if passes is None:
            y = a @ m
        else:
            a_hi, a_lo = split_bf16(a)
            m_hi, m_lo = split_bf16(m)
            y = a_hi @ m_hi
            if passes >= 2:
                y = y + a_hi @ m_lo
            if passes == 3:
                y = y + a_lo @ m_hi
    lead = y.shape[:-2]
    y = y.reshape(lead + (n_frames * s, 2))[..., :n_out, :]
    return Complex(y[..., 0].contiguous(), y[..., 1].contiguous())


def span_k1(x: Complex, tail: Complex, d: int) -> Complex:
    """K1's span: window j starts at x[j*D + D - T], in the (C, T-1) carry
    tail for the first ones."""
    return cplx.concatenate([tail.to(x.re.dtype), x], axis=-1)[..., d - 1:]


def span_k6(x: Complex, t: int, d: int, offset: int) -> Complex:
    """K6's span from window start ``offset``: the block, the last frame's
    windows reading past it into the frame before it (x[n - 128*D])."""
    b = x.re.shape[-1]
    sd = 128 * d
    past = offset + (b // d - 1) * d + t - b
    if past > 0:
        x = cplx.concatenate([x, x[..., b - sd:b - sd + past]], axis=-1)
    return x[..., offset:]


def fm_exact_split(x: Complex, taps, stride: int, tail: Complex,
                   prev: Complex, rot: complex, gain: float, deemph_ab=None,
                   dstate=None, passes: int = 3):
    """K1a (``fir_fm_exact``) with y from :func:`fir_y_split`: (out, y_last)."""
    from libsdr_tpu_torch.ops.fir_fm import _fm_plain

    d = int(stride)
    y = fir_y_split(span_k1(x, tail, d), taps, d, x.re.shape[-1] // d,
                    passes)
    return _fm_plain(y, prev, rot, gain, deemph_ab, dstate), y[..., -1]


def span_k5(x: Complex, t: int, d: int, s0: int, n_out: int, wrap: int,
            tail: Optional[Complex] = None) -> Complex:
    """K5's span (the window form of ``csrc/fir_common.cuh``): v[n] for n
    in [s0, s0 + (n_out-1)*D + T), where v[n] is the (C, T-1) carry tail's
    tail[n + T-1] for n < 0, x[n] inside the block and x[n - wrap] past
    it."""
    b = x.re.shape[-1]
    lo, hi = s0, s0 + (n_out - 1) * d + t
    parts = []
    if lo < 0:
        parts.append(tail.to(x.re.dtype)[..., lo + t - 1:min(hi, 0) + t - 1])
    if hi > 0 and lo < b:
        parts.append(x[..., max(lo, 0):min(hi, b)])
    if hi > b:
        parts.append(x[..., max(lo, b) - wrap:hi - wrap])
    return cplx.concatenate(parts, axis=-1)


def fir_mxu_split(x: Complex, taps, stride: int, s0: int, n_out: int,
                  wrap: int = 0, tail: Optional[Complex] = None,
                  passes: int = 3, chunks: int = 1) -> Complex:
    """K5 (``ops/fir_mxu.py``: ``fir_mxu`` with s0 = offset, n_out = B/D
    and wrap = 128*D; ``fir_offset`` with s0 = offset - (T-1), the tail
    and wrap 0) as the tensor-core kernel computes it: Complex (C, n_out)
    y over :func:`span_k5`, each of ``chunks`` chunks of the outputs
    (ceil(n_out/chunks) each, the kernel's cut) from its own frame grid,
    frames of the plan's S outputs for the plane dtype and pass count, in
    ``passes`` bf16 passes (:func:`fir_y_split`).  No state crosses a
    chunk: y needs only the window."""
    d = int(stride)
    t = _n_taps(taps)
    plan = tc_plan(t, d, x.re.element_size(), passes)
    s = plan.S if plan is not None else 8
    span = span_k5(x, t, d, int(s0), n_out, wrap, tail)
    chunk = -(-n_out // chunks)
    return cplx.concatenate(
        [fir_y_split(span[..., k * d:], taps, d, min(n_out, k + chunk) - k,
                     passes, s=s) for k in range(0, n_out, chunk)], axis=-1)


def fir_exact_split(x: Complex, taps, stride: int, tail: Complex,
                    passes: int = 3, chunks: int = 1) -> Complex:
    """K1b (``fir_exact``, mode fir) as the tensor-core kernel computes it,
    with the same arguments and result, Complex (C, B/D) y: K5's split
    (:func:`fir_mxu_split`) at K1's window start D - T."""
    d = int(stride)
    return fir_mxu_split(x, taps, d, d - _n_taps(taps), x.re.shape[-1] // d,
                         0, tail, passes, chunks)


def am_exact_split(x: Complex, taps, stride: int, tail: Complex,
                   gain: float, agc_ab=None, sd=None, passes: int = 3,
                   chunks: int = 1):
    """K1c (``fir_am_exact``, mode am) as the tensor-core kernel computes
    it, with the same arguments and results: ``gain * |y|``, or with the
    AGC (its follow-up passes, ``csrc/agc.cu``, as the plain version runs
    them) ``gain * |y| / sd`` and the last sd; (out, sd_last or None)."""
    from libsdr_tpu_torch.ops.fir_fm import _agc_plain

    y = fir_exact_split(x, taps, stride, tail, passes, chunks)
    return _agc_plain(y.abs(), gain, agc_ab, sd)


def usb_exact_split(x: Complex, taps, stride: int, tail: Complex,
                    phasor: Complex, ramp: Complex, gain: float, agc_ab=None,
                    sd=None, passes: int = 3, chunks: int = 1):
    """K1d (``fir_usb_exact``, mode usb) as the tensor-core kernel computes
    it, with the same arguments and results: y of :func:`fir_exact_split`
    rotated by the exact NCO, ``(re + im)/2`` of ``y[j] * (a0 * ramp[j])``,
    then ``gain * sig``, or with the AGC (its follow-up passes,
    ``csrc/agc.cu``, as the plain version runs them) ``gain * sig / sd``
    and the last sd; (out, sd_last or None)."""
    from libsdr_tpu_torch.ops.fir_fm import _agc_plain, _usb_sig

    y = fir_exact_split(x, taps, stride, tail, passes, chunks)
    return _agc_plain(_usb_sig(y, phasor, ramp), gain, agc_ab, sd)


def fm_mxu_split(x: Complex, taps, stride: int, offset: int,
                 lead_last: Complex, rot: complex, gain: float,
                 deemph_ab=None, deemph_lead=None, mode: str = "fm",
                 passes: int = 3):
    """K6 (``fir_fm_mxu``) with y from :func:`fir_y_split`: its results."""
    from libsdr_tpu_torch.ops.fir_fm import _agc_plain, _fm_plain
    from libsdr_tpu_torch.ops.fir_mxu import _NSP

    d = int(stride)
    t = _n_taps(taps)
    y = fir_y_split(span_k6(x, t, d, int(offset)), taps, d,
                    x.re.shape[-1] // d, passes)
    c = y.re.shape[0]
    state = None if deemph_ab is None else deemph_lead.reshape(c)
    if mode == "am":
        audio, sd = _agc_plain(y.abs(), gain, deemph_ab, state)
        if deemph_ab is None:
            return audio, _NSP
        return audio, sd[:, None], _NSP
    return _fm_plain(y, lead_last.reshape(c), rot, gain, deemph_ab,
                     state), _NSP


# -- mode afsk: the correlator's window sums, blocked ------------------------

def history_blocks(ell: int) -> int:
    """Blocks of 4 products of history the kernel keeps before a tile:
    every window start of the tile's outputs lies in them or after."""
    return (ell - 1) // 4 + 1


def blocked_sums(u: torch.Tensor, ell: int) -> torch.Tensor:
    """The window sums of products u (..., L-1 + n), the L-1 history ones
    first, as the kernel adds them in float32: in blocks of 4 outputs from
    the first (the epilogue's 4 a thread), P_r the prefix sums of a block
    (u[4t] + .. + u[4t + r]) and B = P_3, with L - 1 = 4m + e,

        s[4t + r] = P_r[t] + (B[t-m] + .. + B[t-1])  (+ B[t-m-1] if r < e)
                    - P_{off-1}[start block]            (if off > 0),

    the window starting at offset off = r - e of block t - m, or r - e + 4
    of block t - m - 1; blocks before the history are zeros.  Returns
    (..., n)."""
    hb = history_blocks(ell)
    n = u.shape[-1] - (ell - 1)
    nb = -(-n // 4)
    full = torch.nn.functional.pad(
        u.float(), (4 * hb - (ell - 1), 4 * nb - n))
    blocks = full.reshape(full.shape[:-1] + (hb + nb, 4))
    pre = [blocks[..., 0]]
    for r in range(1, 4):
        pre.append(pre[-1] + blocks[..., r])
    b = pre[3]
    m, e = (ell - 1) // 4, (ell - 1) % 4
    t = torch.arange(hb, hb + nb, device=u.device)
    w = torch.zeros_like(b[..., t])
    for i in range(m, 0, -1):
        w = w + b[..., t - i]
    out = []
    for r in range(4):
        sv = pre[r][..., t] + w
        if r < e:
            sv = sv + b[..., t - m - 1]
            sv = sv - pre[r - e + 3][..., t - m - 1]
        elif r > e:
            sv = sv - pre[r - e - 1][..., t - m]
        out.append(sv)
    s_all = torch.stack(out, -1).reshape(b.shape[:-1] + (4 * nb,))
    return s_all[..., :n]


def afsk_exact_split(x: Complex, taps, stride: int, tail: Complex,
                     prev: Complex, rot: complex, gain: float,
                     mark: Complex, space: Complex, n0, um_tail: Complex,
                     us_tail: Complex, passes: int = 3, chunks: int = 1,
                     with_power: bool = False):
    """K1e (``fir_afsk_exact``) as the tensor-core kernel computes it, with
    the same arguments and results: each of ``chunks`` chunks of the
    block's outputs (the kernel's cut, ceil(n/chunks) each) from its own
    start, a later one L outputs early from y[-1] = 0 and zero products;
    in each, y from :func:`fir_y_split` (frames from the chunk's start, in
    ``passes`` bf16 passes), kFm's discriminator, the tone products and
    :func:`blocked_sums` in float32 (blocks from the chunk's start).  The
    first chunk starts from the carried y[-1] and products; the last
    exports y_last and the last L-1 products in float32.  with_power: the
    results end with |s_m|^2 + |s_s|^2, the scale of disc's round-off."""
    from libsdr_tpu_torch.ops.fir_fm import _fm_plain

    d = int(stride)
    n = x.re.shape[-1] // d
    ell = mark.re.shape[-1]
    t = _n_taps(taps)
    isz = x.re.element_size()
    plan = tc_plan(t, d, isz, passes, ell=ell)
    s = plan.S if plan is not None else 8
    span = span_k1(x, tail, d)
    dev = x.re.device
    n0 = int(torch.as_tensor(n0))
    tones = [v.to(dev, torch.float32) for v in (mark.re, mark.im, space.re,
                                                space.im)]
    carried = [v.to(dev, torch.float32) for v in (um_tail.re, um_tail.im,
                                                  us_tail.re, us_tail.im)]
    chunk = -(-n // chunks)
    disc = torch.empty(x.re.shape[:-1] + (n,), dtype=torch.float32,
                       device=dev)
    power = torch.empty_like(disc)
    for k in range(0, n, chunk):
        j_start = k - ell if k else 0
        j_end = min(n, k + chunk)
        y = fir_y_split(span[..., j_start * d:], taps, d, j_end - j_start,
                        passes, s=s)
        p0 = prev if k == 0 else cplx.zeros(prev.re.shape, torch.float32,
                                            dev)
        audio = _fm_plain(y, p0, rot, gain)
        idx = (n0 + j_start + torch.arange(j_end - j_start, device=dev)) % ell
        hist = [c if k == 0 else torch.zeros_like(c) for c in carried]
        us = [torch.cat([h, tone[idx] * audio], -1)
              for h, tone in zip(hist, tones)]
        sums = [blocked_sums(u, ell) for u in us]
        dk = (sums[0] * sums[0] + sums[1] * sums[1]) - \
            (sums[2] * sums[2] + sums[3] * sums[3])
        disc[..., k:j_end] = dk[..., k - j_start:]
        power[..., k:j_end] = sum(v * v for v in sums)[..., k - j_start:]
    tails = [u[..., u.shape[-1] - (ell - 1):].clone() for u in us]
    res = (disc, y[..., -1], Complex(tails[0], tails[1]),
           Complex(tails[2], tails[3]))
    return res + (power,) if with_power else res
