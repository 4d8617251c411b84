"""The sharded wideband receiver (counterpart of
``libsdr_tpu.parallel.wideband``): a time-sharded channelizer and a
channel-sharded demod bank over the n ranks of a 1-D mesh axis.

1. **Channelize and demodulate, time-sharded.**  Each rank runs the fused
   channelize + FM stage of the one-device path (K4's demod variant on a
   card, its plain version on the CPU; ``ops/wideband_rx.py``) on its B/n
   segment of the wideband block.  The P-frame filter history arrives from
   the left neighbour as a halo (:func:`halo.pass_right`).  The
   discriminator's seed at a segment's first frame is the left neighbour's
   last channelizer output, its ``y_last`` export, passed right; row 0 is
   demodulated again from it by the same K4 call on that one frame (on the
   CPU, by the plain version), so every audio sample comes from the
   kernel's own epilogue and the n > 1 stream is bit for bit the n == 1
   stream, on the card as on the CPU.
2. **Reshard.**  One all_to_all turns (t/n local time, M channels) into (t
   full time, M/n local channels): the decimated audio crosses once.
3. **Decode, channel-sharded** (:func:`build_scanner_step`): each rank owns
   M/n channels over the full block, so the bit-sync PLL's per-channel
   state stays local.

On one rank (no mesh, or a mesh axis of size 1) the build functions run the
one-device program on ``device`` (the card by default) and skip every
collective.  That program runs lane-major (K4's time-major (T, M) layout,
channel c on lane ``lane_of_channel(M)[c]``), and the scanner applies the
channel permutation to its decimated result.
"""

from __future__ import annotations

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops.channelizer import fold_commutator, prototype_lowpass
from libsdr_tpu_torch.ops.pfb import (lane_of_channel, pfb_frames_plain,
                                      pfb_mxu, pfb_twiddles)
from libsdr_tpu_torch.parallel.distributed import place_global, rank_device
from libsdr_tpu_torch.parallel.halo import (Axis, all_to_all,
                                            last_shard_tail, mesh_axis,
                                            pass_right)


def channelize_local(x_local: Complex, hist: Complex, taps3, m: int,
                     p: int, twiddles=None) -> Complex:
    """The channelize stage of a segment: the K4 kernel on a card
    (``ops/pfb.py``; ``twiddles`` its table, or None), on the CPU
    :func:`channelize_segment`.  Returns the (..., M, t) channel-major
    complex bank."""
    if x_local.re.device.type == "cpu":
        return channelize_segment(x_local, hist, taps3, m, p)
    lead = tuple(x_local.shape[:-1])
    t = x_local.shape[-1] // m
    y_lane = pfb_mxu(x_local.reshape(lead + (t, m)), hist, taps3, m,
                     twiddles=twiddles)
    lp = torch.as_tensor(lane_of_channel(m), device=x_local.re.device)
    return y_lane.map(lambda a: a[..., lp].transpose(-1, -2))


def channelize_segment(x_local: Complex, hist: Complex, taps3, m: int,
                       p: int) -> Complex:
    """Channelizer body on a time segment given its P-frame history: the
    commutator folded into ``taps3 = fold_commutator(...)`` and a forward
    DFT.  Returns (..., M, t) complex float32."""
    lead = tuple(x_local.shape[:-1])
    t = x_local.shape[-1] // m
    y = pfb_frames_plain(x_local.reshape(lead + (t, m)), hist, taps3)
    return y.map(lambda a: a.transpose(-1, -2))


def _lane_to_channel_cols(a: torch.Tensor, m: int) -> torch.Tensor:
    """The lane-permuted columns of a (..., t, M) array in channel order
    (out[..., c] = a[..., lane_of_channel(m)[c]])."""
    if m <= 128 or m % 128:
        return a
    return a[..., torch.as_tensor(lane_of_channel(m), device=a.device)]


def _validate(block: int, m: int, n: int, p: int) -> None:
    if block % (m * n):
        raise ValueError("block must divide by M * n_devices")
    if m % n:
        raise ValueError("channels must divide by n_devices")
    if block // (m * n) < p + 1:
        raise ValueError(
            "each device's segment must hold >= taps_per_branch + 1 frames "
            f"(block // (M*n) = {block // (m * n)} < P + 1 = {p + 1})")


def _taps(m: int, p: int) -> np.ndarray:
    return fold_commutator(prototype_lowpass(m, p), m, p)


def _segment_tail(x_local: Complex, m: int, p: int) -> Complex:
    """The segment's last P frames, (P, M), as a copy: a view would keep
    the whole block alive in the carry."""
    t_seg = x_local.shape[-1] // m
    return x_local[..., (t_seg - p) * m:].reshape((p, m)).map(torch.clone)


def _history(hist_g: Complex, x_local: Complex, m: int, p: int, ax: Axis):
    """(this segment's P-frame history, the next block's): the carried
    global history on rank 0, the left neighbour's tail elsewhere; the
    last rank's tail for the next block."""
    tail = _segment_tail(x_local, m, p)
    if ax.size == 1:
        return hist_g, tail
    halo = pass_right(tail, ax)
    return (hist_g if ax.index == 0 else halo), last_shard_tail(tail, ax)


def _wideband_body(carry, x_local, taps3, m: int, p: int, ax: Axis,
                   gain: float = 1.0, reorder: bool = True, twiddles=None):
    """The per-rank wideband stages of one block:

    1. the P-frame halo (the channelizer's history),
    2. the fused channelize + FM stage (ops/wideband_rx.wideband_fm_local:
       K4's demod variant on a card, its plain version on the CPU), then
       the left neighbour's ``y_last`` passed right and row 0 demodulated
       again from it by the same stage on the segment's first frame,
    3. lane -> channel reorder and the all_to_all of the float32 audio,
       time-sharded -> channel-sharded.  On one rank the reorder is a
       column permutation, and a lane-parallel chain downstream (the
       scanner's) passes ``reorder=False`` and permutes its decimated
       result instead.

    carry = (hist (P, M) raw frames, prev (1, M) lane y seed), both the
    global stream's.  Returns (new_carry, audio): (t_full, M/n) channel
    ordered columns, or (t, M) LANE-ordered on one rank with
    ``reorder=False``."""
    from libsdr_tpu_torch.ops.wideband_rx import wideband_fm_local

    hist_g, prev_g = carry
    hist, new_hist = _history(hist_g, x_local, m, p, ax)
    audio_lane, y_last, _ = wideband_fm_local(
        x_local, hist, prev_g, taps3, m, p, gain=gain, twiddles=twiddles)
    if ax.size == 1:
        if not reorder:
            return (new_hist, y_last), audio_lane
        return (new_hist, y_last), _lane_to_channel_cols(audio_lane, m)
    seed = pass_right(y_last, ax)
    if ax.index > 0:
        row0, _, _ = wideband_fm_local(x_local[..., :m], hist, seed, taps3,
                                       m, p, gain=gain, twiddles=twiddles)
        audio_lane = torch.cat([row0, audio_lane[..., 1:, :]], dim=-2)
    audio_cols = _lane_to_channel_cols(audio_lane, m)    # (t_seg, M)
    audio_cols = all_to_all(audio_cols, ax, split_axis=1, concat_axis=0)
    return (new_hist, last_shard_tail(y_last, ax)), audio_cols


def _wideband_carry_and_place(m: int, p: int, mesh, axis: str, dev,
                              plane_dtype=None):
    """(init_carry, place_input) shared by the wideband and scanner build functions.
    The carry is the global stream's, on every rank; ``place_input`` gives
    this rank its time segment of a global (B,) block
    (``parallel/distributed.place_global``)."""
    dtype = plane_dtype if plane_dtype is not None else torch.float32

    def init_carry():
        return (cplx.zeros((p, m), dtype, dev),
                cplx.full_like_phasor((1, m), torch.float32, dev))

    def place_input(x):
        return place_global(x, mesh, (axis,), dtype, dev)

    return init_carry, place_input


def _setup(mesh, axis, device, block, m, p):
    """(the rank's axis, its device, K4's taps and twiddles there)."""
    dev = rank_device(mesh, device)
    ax = mesh_axis(mesh, axis)
    _validate(block, m, ax.size, p)
    return (ax, dev, torch.from_numpy(_taps(m, p)).to(dev),
            pfb_twiddles(m, dev))


def build_wideband_step(n_channels: int, block: int, taps_per_branch: int = 8,
                        gain: float = 1.0, plane_dtype=None, mesh=None,
                        axis: str = "d", device=None):
    """Build (step, init_carry, place_input) for the wideband receiver.

    ``step(carry, x)`` consumes this rank's part of a global (B,) complex
    block (``place_input``) and returns the FM-demodulated float32 channel
    bank, (M, B/M) on one rank and this rank's (M/n, B/M) channels over the
    ``axis`` of ``mesh`` (a ``DeviceMesh``).  ``device``: the card by
    default; with a mesh, the rank's device (another raises)."""
    m, p = n_channels, taps_per_branch
    ax, dev, taps3, tw = _setup(mesh, axis, device, block, m, p)

    def step(carry, x):
        carry, audio_cols = _wideband_body(carry, x, taps3, m, p, ax, gain,
                                           twiddles=tw)
        return carry, audio_cols.transpose(-1, -2)

    init_carry, place_input = _wideband_carry_and_place(m, p, mesh, axis,
                                                        dev, plane_dtype)
    return step, init_carry, place_input


def build_scanner_step(n_channels: int, block: int, fs_hz: float,
                       taps_per_branch: int = 8, baud: float = 1200.0,
                       compact_window: int = 0, plane_dtype=None,
                       packed: bool = False, mesh=None, axis: str = "d",
                       device=None):
    """The whole-band pager scanner: the wideband stages, the ASK detector
    and the bit-sync PLL.  On one rank the whole chain runs lane-major
    (time-major (T, M)) and the channel permutation applies to the
    windowed bits; over n ranks each rank runs the chain on its M/n
    channels after the all_to_all, in channel order.

    ``step(carry, x)`` consumes this rank's part of a global (B,) complex
    block and returns a Ragged (M or M/n, T') uint8 bit stream (rows =
    channels, channel-major), or with ``packed`` one uint8 array with bit 0
    = data and bit 1 = valid.  T' = B/M, or B/M/compact_window when
    ``compact_window`` > 0: the PLL emits bits at least ``min_valid_gap``
    samples apart, so any window up to that gap losslessly decimates the
    bit stream on the device.  It must divide B/M and not exceed the
    gap."""
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.core.ragged import Ragged, min_valid_gap
    from libsdr_tpu_torch.ops import ASKDetector, BitStream

    m, p = n_channels, taps_per_branch
    ax, dev, taps3, tw = _setup(mesh, axis, device, block, m, p)
    t_full = block // m
    g = m // ax.size                # channels a rank after the reshard
    w = int(compact_window)
    ask = ASKDetector(invert=True)
    bs = BitStream(baud, mode="normal", time_major=True)
    bs.bind(ask.bind(L.StreamSpec(np.float32, fs_hz / m, t_full,
                                  channels=(g,))))
    if w:
        if t_full % w:
            raise ValueError(f"compact_window {w} must divide T={t_full}")
        if w > min_valid_gap(bs):
            raise ValueError(
                f"compact_window {w} exceeds the PLL's guaranteed bit gap "
                f"{min_valid_gap(bs)}: bits could be lost")
    # one rank: the channel permutation applies to the windowed bits
    cols = (torch.as_tensor(lane_of_channel(m), device=dev)
            if ax.size == 1 else slice(None))

    def window_rows(a, fill):
        # (T, C) time-major -> (T/w, C): at most one valid item a window
        if not w:
            return a
        aw = a.reshape((a.shape[0] // w, w) + tuple(a.shape[1:]))
        if a.dtype == torch.bool:
            return aw.any(dim=1)
        return torch.where(fill.reshape(aw.shape), aw,
                           torch.zeros((), dtype=a.dtype,
                                       device=a.device)).sum(dim=1).to(a.dtype)

    def step(carry, x):
        wb_carry, bsc = carry
        wb_carry, audio = _wideband_body(wb_carry, x, taps3, m, p, ax,
                                         reorder=False, twiddles=tw)
        _, sym = ask.apply((), audio)
        bsc, bits = bs.apply(bsc, sym)
        valid = bits.valid
        data = window_rows(bits.data, valid)[..., cols].transpose(0, 1)
        vw = window_rows(valid, valid)[..., cols].transpose(0, 1)
        if packed:
            return (wb_carry, bsc), data | (vw.to(torch.uint8) << 1)
        return (wb_carry, bsc), Ragged(data, vw)

    wb_init, place_input = _wideband_carry_and_place(m, p, mesh, axis, dev,
                                                     plane_dtype)

    def init_carry():
        return (wb_init(), bs.init_carry(dev))

    return step, init_carry, place_input
