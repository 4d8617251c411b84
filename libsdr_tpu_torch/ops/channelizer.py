"""Polyphase filterbank channelizer (counterpart of
``libsdr_tpu.ops.channelizer``).

The standard maximally decimated uniform PFB: one wideband complex stream
in, M critically sampled channel streams out, each at fs/M, channel c
centered at c*fs/M (negative bands at M-c).  The input is framed into
(frames, M) by the commutator; the polyphase branch filters are a tap matrix
applied over P+1 consecutive frames, and the channels are an M-point DFT
across branches.  Polyphase identity (channel c = decimate(h * (x e^{-2i pi
c n/M}))):

    u_p[t]  = sum_k h[kM + p] * x[(t-k)M - p]      (reverse commutator)
    y_c[t]  = sum_p u_p[t] * exp(+2i pi p c / M)

:func:`fold_commutator` folds the reverse commutator into the taps, so the
device computes an unscaled forward DFT over unreversed frame lanes: on a
card the kernel K4 (``ops/pfb.py``, ``csrc/pfb.cu``), on the CPU its plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.stream import ConfigError, StreamSpec
from libsdr_tpu_torch.ops import firdesign


def prototype_lowpass(n_channels: int, taps_per_branch: int,
                      cutoff_scale: float = 1.0) -> np.ndarray:
    """Prototype low-pass for an M-channel PFB: length M*P windowed sinc with
    cutoff fs/(2M), unity DC gain."""
    m, p = n_channels, taps_per_branch
    n = m * p
    return firdesign.lowpass(n, cutoff_scale * 0.5 / m, 1.0)


def fold_commutator(proto: np.ndarray, m: int, p: int) -> np.ndarray:
    """Fold the PFB reverse commutator into the tap matrix: returns taps3
    (P+1, M) float32 such that

        u'[t, q'] = sum_k taps3[k, q'] * histf[t + P - k, q']

    on unreversed frame lanes equals the commutated branch signals on
    reversed lanes, and channel synthesis becomes the unscaled forward DFT
    over q'."""
    taps = np.asarray(proto, np.float64).reshape(p, m)
    t3 = np.zeros((p + 1, m), np.float64)
    t3[:p, 0] = taps[:, 0]          # branch 0: frames t+1 .. t+P
    t3[1:, 1:] = taps[:, :0:-1]     # branch q' = M-q: frames t .. t+P-1
    return t3.astype(np.float32)


class Channelizer(Processor):
    """Maximally decimated uniform polyphase channelizer.

    Args:
      n_channels: number of uniform channels M (output rate = fs/M).
      taps_per_branch: polyphase taps P per branch (prototype length M*P).
      prototype: optional custom prototype filter (length M*P).

    Input (..., B) complex, B % M == 0; output (..., M, B/M) complex float32
    -- channel c at center frequency c*fs/M (negative bands at M-c).  The
    carry is the last P raw frames (..., P, M) in the input plane dtype.
    """

    def __init__(self, n_channels: int, taps_per_branch: int = 8,
                 prototype: np.ndarray = None):
        super().__init__()
        self.m = int(n_channels)
        self.p = int(taps_per_branch)
        self._proto = prototype

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("Channelizer")
        m, p = self.m, self.p
        in_spec.require_block_multiple("Channelizer", m)
        proto = (np.asarray(self._proto) if self._proto is not None
                 else prototype_lowpass(m, p))
        if len(proto) != m * p:
            raise ConfigError(
                f"Channelizer: prototype length {len(proto)} != M*P = {m * p}")
        self._taps3_np = fold_commutator(proto, m, p)
        self._taps_dev = {}
        return in_spec.with_(
            channels=in_spec.channels + (m,),
            plane_dtype=None,  # the synthesis DFT accumulates in float32
            sample_rate=in_spec.sample_rate / m,
            block_size=in_spec.block_size // m)

    def _consts(self, device):
        """(the folded taps (P+1, M) float32, K4's twiddles) on
        ``device``, made once."""
        from libsdr_tpu_torch.ops.pfb import pfb_twiddles

        key = str(device)
        if key not in self._taps_dev:
            self._taps_dev[key] = (
                torch.from_numpy(self._taps3_np).to(device),
                pfb_twiddles(self.m, device))
        return self._taps_dev[key]

    def _init_carry(self, device):
        # P previous raw frames (the reverse commutator needs one frame of
        # look-back on top of the P-1 filter history).
        shape = self.in_spec.channels + (self.p, self.m)
        return cplx.zeros(shape, self.in_spec.real_dtype, device)

    def apply(self, carry, x):
        from libsdr_tpu_torch.parallel.wideband import channelize_local

        m, p = self.m, self.p
        lead = tuple(x.shape[:-1])
        t = x.shape[-1] // m
        taps3, tw = self._consts(x.device)
        y = channelize_local(x, carry, taps3, m, p, twiddles=tw)
        if t >= p:
            # a copy: a view would keep the whole block alive in the carry
            new_carry = x[..., (t - p) * m:].reshape(lead + (p, m)).map(
                torch.clone)
        else:
            frames = x.reshape(lead + (t, m))
            new_carry = cplx.concatenate(
                [carry.to(x.re.dtype), frames], axis=-2)[..., t:, :]
        return new_carry, y
