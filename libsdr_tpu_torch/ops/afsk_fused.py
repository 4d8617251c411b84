"""Fused AFSK front end: IQBaseBand + FMDemod + FSKDetector as one op
(counterpart of ``libsdr_tpu.ops.afsk_fused``).

Installed by the fusion pass (core/fuse.py) when an IQBaseBand feeds a
quadrature FMDemod feeding an FSKDetector: the AX.25/APRS receive chain.
Each block is one call of ``ops/fir_fm.fir_afsk_exact``: the decimating
FIR, the FM discriminator, the audio-rate tone products and the
correlator's window sums in one pass (the kernel K1e on a card), so neither
the complex baseband nor the audio reaches device memory; only the
mark-vs-space power difference comes out, thresholded to the uint8 symbol
stream that a BitStream takes.
"""

from __future__ import annotations

import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.stream import StreamSpec
from libsdr_tpu_torch.ops.fir import new_tail
from libsdr_tpu_torch.ops.fir_fm import fir_afsk_exact
from libsdr_tpu_torch.ops.fm_fused import FMBasebandFused
from libsdr_tpu_torch.ops.fsk import FSKDetector, tone_tables


class AFSKFrontendFused(FMBasebandFused):
    """One-op AFSK receiver front end: raw IQ in, uint8 symbols out at the
    decimated audio rate.  Built by core/fuse.py from [IQBaseBand ->
    FMDemod -> FSKDetector].

    The carry is ``(tail, y_prev, n0, um_tail, us_tail)``: the FIR tail in
    the input plane dtype, y[-1] Complex (channels) float32, the template
    phase n0 (an int32 scalar) and the last L-1 products of each tone,
    Complex (channels + (L-1,)) float32 — the JAX op's carry, leaf for leaf.
    """

    def __init__(self, bb, demod, fsk: FSKDetector):
        super().__init__(bb, demod)
        self.fsk = fsk

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        spec = super()._bind(in_spec)
        audio_fs = spec.rate_hz
        self.corr_len = int(audio_fs / self.fsk.baud)
        self._tones = tone_tables(self.fsk.f_mark, self.fsk.f_space,
                                  audio_fs, self.corr_len)
        return spec.with_(dtype=torch.uint8)

    def _init_carry(self, device):
        tail, prev = super()._init_carry(device)
        u0 = self.in_spec.channels + (self.corr_len - 1,)
        return (tail, prev, torch.zeros((), dtype=torch.int32, device=device),
                cplx.zeros(u0, torch.float32, device),
                cplx.zeros(u0, torch.float32, device))

    def apply(self, carry, x):
        tail, prev, n0, um_tail, us_tail = carry
        ch, c, x2, tail2 = self._flat(x, tail)
        L = self.corr_len
        dev = x.device
        disc, y_last, um2, us2 = fir_afsk_exact(
            x2, self._taps(dev), self._decim, tail2, prev.reshape(c),
            self._rot, self._gain, self._on("mark", self._tones[0], dev),
            self._on("space", self._tones[1], dev), n0,
            um_tail.reshape(c, L - 1), us_tail.reshape(c, L - 1))
        n_audio = disc.shape[-1]
        sym = (disc > 0).to(torch.uint8).reshape(ch + (n_audio,))
        return (new_tail(x, tail, self._t), y_last.reshape(ch),
                (n0 + n_audio) % L, um2.reshape(ch + (L - 1,)),
                us2.reshape(ch + (L - 1,))), sym
