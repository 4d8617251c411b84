"""Fused wideband receiver op: PFB channelizer + quadrature FM demod bank
(counterpart of ``libsdr_tpu.ops.wideband_rx``).

One Processor runs the whole wideband front end, on a card as one launch of
the K4 kernel in its demod variant (``ops/pfb.py``, ``csrc/pfb.cu``): the
wideband block is read once and only the float32 audio bank is written.

Layouts:
  * ``layout='lane'``: output (..., F, M) float32, time-major, with the
    channels lane-permuted -- lane L carries channel ``channel_of_lane(M)[L]``
    (center freq c*fs/M).  Per-channel ops downstream (ASK, the bit-sync
    PLL) are lane-parallel; use the maps for channel naming.
  * ``layout='channel'``: (..., M, F) channel-major, the output of
    [Channelizer -> FMDemod]; the fusion pass installs this layout.

The carry is (P history frames, y[-1] per lane): the information of the
Channelizer's carry plus the FMDemod's, so streamed block boundaries match
the unfused pair.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import ConfigError, StreamSpec
from libsdr_tpu_torch.ops.channelizer import fold_commutator, prototype_lowpass
from libsdr_tpu_torch.ops.pfb import (channel_of_lane, fm_demod_lanes,
                                      lane_of_channel, pfb_mxu, pfb_plain,
                                      pfb_supported, pfb_twiddles)


def fm_local_kernel_ok(x: Complex, m: int, p: int) -> bool:
    """Whether :func:`wideband_fm_local` (and, as
    ``parallel/wideband.py::channelize_kernel_ok``, the channelizer's
    ``channelize_local``) launches the K4 kernel for block ``x``: a block
    on a card whose shape is inside the kernel's gate (``pfb_supported``).
    Outside it the stage runs K4's plain version on the block's device, a
    card too, as the JAX package runs its XLA body outside its Pallas
    kernel.  The shape alone decides, before any launch."""
    return (x.re.device.type == "cuda"
            and pfb_supported(m, x.shape[-1] // m, p, x.re.dtype))


# One discriminator row per lane from (..., 1, M) ``y`` and ``prev`` (the
# JAX package's name): the op sequence of the kernel's demod epilogue, so
# a row patched with it matches the kernel's value.
fm_demod1 = fm_demod_lanes


def wideband_fm_local(x: Complex, hist: Complex, prev: Complex, taps3,
                      m: int, p: int, gain: float = 1.0, twiddles=None):
    """The fused channelize + FM stage of one segment.

    Args:
      x: (..., B) planar complex block (B % m == 0).
      hist: (..., P, M) planar carry frames preceding the block.
      prev: (..., 1, M) planar y[-1] per LANE (discriminator seed).
      taps3: folded-commutator taps (P+1, M), numpy or a float32 tensor.
      twiddles: K4's table (``ops/pfb.py::pfb_twiddles``), or None.

    Returns (audio_lane (..., F, M) float32 time-major lane-permuted,
    y_last (..., 1, M) -- the next segment's ``prev`` -- and y_first
    (..., 1, M), the first frame's channel samples).
    """
    lead = tuple(x.shape[:-1])
    f_total = x.shape[-1] // m
    run = pfb_mxu if fm_local_kernel_ok(x, m, p) else pfb_plain
    return run(x.reshape(lead + (f_total, m)), hist, taps3, m, gain=gain,
               prev=prev, demod=True, twiddles=twiddles)


class WidebandFM(Processor):
    """Fused channelizer + FM demod bank over a wideband stream.

    Args:
      n_channels: channel count M (output rate fs/M per channel).
      taps_per_branch: polyphase taps P per branch.
      gain: demod audio gain.
      prototype: optional custom prototype filter (length M*P).
      layout: 'lane' (time-major lane-permuted) or 'channel'
        ((..., M, F) channel-major, drop-in for Channelizer -> FMDemod).
    """

    def __init__(self, n_channels: int, taps_per_branch: int = 8,
                 gain: float = 1.0, prototype: Optional[np.ndarray] = None,
                 layout: str = "lane"):
        super().__init__()
        if layout not in ("lane", "channel"):
            raise ConfigError(f"WidebandFM: unknown layout {layout!r}")
        self.m = int(n_channels)
        self.p = int(taps_per_branch)
        self.gain = float(gain)
        self.layout = layout
        self._proto = prototype

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("WidebandFM")
        m, p = self.m, self.p
        in_spec.require_block_multiple("WidebandFM", m)
        # The carry is the last P raw frames of the block, so each block
        # must hold at least P frames.
        if in_spec.block_size // m < p:
            raise ConfigError(
                f"WidebandFM: block holds {in_spec.block_size // m} frames, "
                f"needs >= taps_per_branch = {p} (block_size >= M*P)")
        proto = (np.asarray(self._proto) if self._proto is not None
                 else prototype_lowpass(m, p))
        if len(proto) != m * p:
            raise ConfigError(
                f"WidebandFM: prototype length {len(proto)} != M*P = {m * p}")
        self._taps3 = fold_commutator(proto, m, p)
        self._lp = lane_of_channel(m)
        self._chan = channel_of_lane(m)
        self._dev = {}
        return in_spec.with_(
            dtype=torch.float32, plane_dtype=None,
            channels=in_spec.channels + (m,),
            sample_rate=in_spec.sample_rate / m,
            block_size=in_spec.block_size // m)

    @property
    def channel_of_lane(self) -> np.ndarray:
        """chan[L] = channel index carried by output lane L (layout='lane')."""
        return self._chan

    @property
    def lane_of_channel(self) -> np.ndarray:
        """lane[c] = output lane carrying channel c (layout='lane')."""
        return self._lp

    def _consts(self, device):
        """(taps3, lane_of_channel, K4's twiddles) on ``device``, made
        once."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (torch.from_numpy(self._taps3).to(device),
                              torch.as_tensor(self._lp, device=device),
                              pfb_twiddles(self.m, device))
        return self._dev[key]

    def _init_carry(self, device):
        m, p = self.m, self.p
        lead = self.in_spec.channels
        hist = cplx.zeros(lead + (p, m), self.in_spec.real_dtype, device)
        prev = cplx.full_like_phasor(lead + (1, m), torch.float32, device)
        return (hist, prev)

    def apply(self, carry, x):
        m, p = self.m, self.p
        hist, prev = carry       # hist (..., p, m); prev (..., 1, m) [lane]
        lead = tuple(x.shape[:-1])
        f_total = x.shape[-1] // m
        taps3, lp, tw = self._consts(x.re.device)
        audio_lane, new_prev, _ = wideband_fm_local(x, hist, prev, taps3, m,
                                                    p, gain=self.gain,
                                                    twiddles=tw)
        # a copy: a view would keep the whole block alive in the carry
        new_hist = x[..., (f_total - p) * m:].reshape(lead + (p, m)).map(
            torch.clone)
        if self.layout == "channel":
            audio = audio_lane[..., lp].transpose(-1, -2)
        else:
            audio = audio_lane
        return (new_hist, new_prev), audio
