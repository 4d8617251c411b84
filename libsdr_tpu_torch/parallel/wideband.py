"""The wideband receiver on one device (counterpart of
``libsdr_tpu.parallel.wideband``, its ``n == 1`` half).

:func:`build_wideband_step` is the fused channelizer + FM demod bank over a
wideband block; :func:`build_scanner_step` extends it with the ASK detector,
the bit-clock PLL and a windowed on-device bit compaction: the whole-band
pager scanner.  Both run lane-major (the K4 kernel's time-major (T, M)
layout, channel c on lane ``lane_of_channel(M)[c]``); the channel
permutation applies to the decimated result.  The JAX builders take a
device mesh; these take one ``device`` (default: the card).  The sharded
form (time-sharded channelizer, all_to_all reshard, channel-sharded decode)
is not ported yet: a group of more than one device raises
:class:`ConfigError`.
"""

from __future__ import annotations

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.graph import resolve_device
from libsdr_tpu_torch.core.stream import ConfigError
from libsdr_tpu_torch.ops.channelizer import fold_commutator, prototype_lowpass
from libsdr_tpu_torch.ops.pfb import (channel_of_lane, lane_of_channel,
                                      pfb_frames_plain, pfb_mxu,
                                      pfb_twiddles)


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


def _seed_from_frames(framesp1: Complex, taps3, m: int, p: int) -> Complex:
    """Y (..., 1, M) lane-major of the single frame ``framesp1[p]`` given its
    own P-frame history ``framesp1[:p]``: a segment's own last channelizer
    output, the discriminator seed of the segment after it."""
    y = pfb_frames_plain(framesp1[..., p:p + 1, :], framesp1[..., :p, :],
                         taps3)
    chan = torch.as_tensor(channel_of_lane(m), device=y.re.device)
    return y.map(lambda a: a[..., chan])


def _lane_to_channel_cols(a: torch.Tensor, m: int) -> torch.Tensor:
    """The lane-permuted columns of a (..., t, M) array in channel order
    (out[..., c] = a[..., lane_of_channel(m)[c]])."""
    if m <= 128 or m % 128:
        return a
    return a[..., torch.as_tensor(lane_of_channel(m), device=a.device)]


def _one_device(device):
    """The single device of a builder: ``device``, or a group of exactly one
    device; more raise ConfigError."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise ConfigError(
                f"{len(device)} devices: the sharded wideband paths "
                "(time-sharded channelizer, all_to_all reshard) are not "
                "ported yet (ROADMAP.md, slice 6); give one device")
        device = device[0]
    return resolve_device(device)


def _validate(block: int, m: int, p: int) -> None:
    if block % m:
        raise ValueError("block must divide by M")
    if block // m < p + 1:
        raise ValueError(
            "the block must hold >= taps_per_branch + 1 frames "
            f"(block // M = {block // m} < P + 1 = {p + 1})")


def _taps(m: int, p: int) -> np.ndarray:
    return fold_commutator(prototype_lowpass(m, p), m, p)


def _wideband_body(carry, x_local, taps3, m: int, p: int, gain: float = 1.0,
                   reorder: bool = True, twiddles=None):
    """The fused channelize + FM stage of one block: K4's demod variant on a
    card, its plain version on the CPU (ops/wideband_rx.wideband_fm_local).

    carry = (hist (P, M) raw frames, prev (1, M) lane y seed).  Returns
    (new_carry, audio): (t, M) channel-ordered columns, or LANE-ordered
    with ``reorder=False`` (for a lane-parallel chain downstream, which
    then permutes its decimated result instead of the (t, M) audio)."""
    from libsdr_tpu_torch.ops.wideband_rx import wideband_fm_local

    hist, prev = carry
    t_seg = x_local.shape[-1] // m
    # a copy: a view would keep the whole block alive in the carry
    new_hist = x_local[..., (t_seg - p) * m:].reshape((p, m)).map(
        torch.clone)
    audio_lane, y_last, _ = wideband_fm_local(x_local, hist, prev, taps3, m,
                                              p, gain=gain, twiddles=twiddles)
    if not reorder:
        return (new_hist, y_last), audio_lane
    return (new_hist, y_last), _lane_to_channel_cols(audio_lane, m)


def _wideband_carry_and_place(m: int, p: int, device, plane_dtype=None):
    """(init_carry, place_input) shared by the wideband/scanner builders."""
    dtype = plane_dtype if plane_dtype is not None else torch.float32

    def init_carry():
        return (cplx.zeros((p, m), dtype, device),
                cplx.full_like_phasor((1, m), torch.float32, device))

    def place_input(x):
        return cplx.as_block(x, dtype, device).to(device, dtype)

    return init_carry, place_input


def build_wideband_step(n_channels: int, block: int, taps_per_branch: int = 8,
                        gain: float = 1.0, plane_dtype=None, device=None):
    """Build (step, init_carry, place_input) for the wideband receiver.

    ``step(carry, x)`` consumes a (B,) complex block and returns the
    FM-demodulated (M, B/M) float32 channel bank on ``device`` (default:
    the card)."""
    device = _one_device(device)
    m, p = n_channels, taps_per_branch
    _validate(block, m, p)
    taps3 = torch.from_numpy(_taps(m, p)).to(device)
    tw = pfb_twiddles(m, device)

    def step(carry, x):
        carry, audio_cols = _wideband_body(carry, x, taps3, m, p, gain,
                                           twiddles=tw)
        return carry, audio_cols.transpose(-1, -2)

    init_carry, place_input = _wideband_carry_and_place(m, p, device,
                                                        plane_dtype)
    return step, init_carry, place_input


def build_scanner_step(n_channels: int, block: int, fs_hz: float,
                       taps_per_branch: int = 8, baud: float = 1200.0,
                       compact_window: int = 0, plane_dtype=None,
                       packed: bool = False, device=None):
    """The whole-band pager scanner: the fused channelize + FM stage, the
    ASK detector and the bit-sync PLL, all lane-major (time-major (T, M)),
    with the channel permutation applied to the windowed bits.

    ``step(carry, x)`` consumes a (B,) complex block and returns a Ragged
    (M, T') uint8 bit stream (rows = channels, channel-major), or with
    ``packed`` one uint8 array with bit 0 = data and bit 1 = valid.  T' =
    B/M, or B/M/compact_window when ``compact_window`` > 0: the PLL emits
    bits at least ``min_valid_gap`` samples apart, so any window up to that
    gap losslessly decimates the bit stream on the device.  It must divide
    B/M and not exceed the gap."""
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.core.ragged import Ragged, min_valid_gap
    from libsdr_tpu_torch.ops import ASKDetector, BitStream

    device = _one_device(device)
    m, p = n_channels, taps_per_branch
    _validate(block, m, p)
    taps3 = torch.from_numpy(_taps(m, p)).to(device)
    tw = pfb_twiddles(m, device)
    t_full = block // m
    w = int(compact_window)
    ask = ASKDetector(invert=True)
    bs = BitStream(baud, mode="normal", time_major=True)
    bs.bind(ask.bind(L.StreamSpec(np.float32, fs_hz / m, t_full,
                                  channels=(m,))))
    if w:
        if t_full % w:
            raise ValueError(f"compact_window {w} must divide T={t_full}")
        if w > min_valid_gap(bs):
            raise ValueError(
                f"compact_window {w} exceeds the PLL's guaranteed bit gap "
                f"{min_valid_gap(bs)}: bits could be lost")
    lp = torch.as_tensor(lane_of_channel(m), device=device)

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
        wb_carry, audio_lane = _wideband_body(wb_carry, x, taps3, m, p,
                                              reorder=False, twiddles=tw)
        _, sym = ask.apply((), audio_lane)
        bsc, bits = bs.apply(bsc, sym)
        valid = bits.valid
        data = window_rows(bits.data, valid)[..., lp].transpose(0, 1)
        vw = window_rows(valid, valid)[..., lp].transpose(0, 1)
        if packed:
            return (wb_carry, bsc), data | (vw.to(torch.uint8) << 1)
        return (wb_carry, bsc), Ragged(data, vw)

    wb_init, place_input = _wideband_carry_and_place(m, p, device,
                                                     plane_dtype)

    def init_carry():
        return (wb_init(), bs.init_carry(device))

    return step, init_carry, place_input
