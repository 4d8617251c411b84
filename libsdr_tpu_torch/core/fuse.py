"""Graph peephole fusions run by ``Pipeline._bind`` before spec propagation
(counterpart of ``libsdr_tpu.core.fuse``).

Rules, each exact in exact arithmetic, on adjacent stages of one Pipeline:

1. ``FreqShift(f, exact) -> FMDemod(quadrature)``: the discriminator only
   sees ``x[n] * conj(x[n-1])``, where the mixer rotation ``e^(-i w n)``
   collapses to the constant ``e^(-i w)``.  The FreqShift is dropped and the
   demod folds the constant in.
2. ``FreqShift(f, exact) -> AMDemod``: ``|x|`` is rotation invariant; the
   FreqShift is dropped.
3. ``IQBaseBand -> FMDemod(quadrature) -> FSKDetector``: one
   :class:`AFSKFrontendFused` op computes the symbols straight from the raw
   IQ block through the fused FIR + FM + FSK correlator kernel.  Tried
   before rule 4, which would take the first two stages.
4. ``IQBaseBand -> FMDemod(quadrature) [-> FMDeemph]``: one
   :class:`FMBasebandFused` op computes the audio straight from the raw IQ
   block through the fused FIR + FM + de-emphasis kernel.
5. ``IQBaseBand -> USBDemod [-> AGC]``: one :class:`USBBasebandFused` op
   (FIR + exact NCO phasor + SSB demod + AGC in one kernel call).
6. ``IQBaseBand -> AMDemod [-> AGC]``: one :class:`AMBasebandFused` op
   (FIR + envelope + AGC in one kernel call).
7. ``Channelizer -> FMDemod(quadrature)``: one :class:`WidebandFM` op in
   the 'channel' layout (the pair's (..., M, t) output) runs the channelizer
   and the discriminator bank in one launch of the PFB kernel.  It needs
   blocks of at least P frames; on a smaller block its bind fails and
   ``Pipeline._bind`` restores the unfused stages.
8. ``IQBaseBand (fc != 0) -> FMDemod(quadrature) | AMDemod`` where no rule
   above took the pair (the real-input ``BaseBand``, whose type is not
   exactly ``IQBaseBand``): the baseband leaves its output-rate NCO out
   (``fold_nco``) and the FMDemod folds the rotation ``e^(-i w)`` in, or
   the AMDemod takes |x| of the unrotated output.

An AGC is absorbed only when it is enabled.  The JAX package gates rules
3-7 on a TPU backend; the fused ops here are exact on every device, so the
rules apply wherever they match.
"""

from __future__ import annotations

from typing import List


def reset_fusion_state(stages: List) -> None:
    """Clear the fusion state that :func:`fuse_stages` writes onto stage
    instances (rotations folded into an FMDemod, a baseband's left-out
    NCO)."""
    from libsdr_tpu_torch.ops.baseband import IQBaseBand
    from libsdr_tpu_torch.ops.demod import FMDemod

    for st in stages:
        if isinstance(st, FMDemod):
            st._pending_rot_freqs = []
        if isinstance(st, IQBaseBand):
            st.fold_nco = False


def fuse_stages(stages: List) -> List:
    """Return the rewritten stage list."""
    from libsdr_tpu_torch.ops.agc import AGC
    from libsdr_tpu_torch.ops.baseband import IQBaseBand
    from libsdr_tpu_torch.ops.demod import (AMDemod, FMDeemph, FMDemod,
                                            USBDemod)
    from libsdr_tpu_torch.ops.afsk_fused import AFSKFrontendFused
    from libsdr_tpu_torch.ops.channelizer import Channelizer
    from libsdr_tpu_torch.ops.fm_fused import (AMBasebandFused,
                                               FMBasebandFused,
                                               USBBasebandFused)
    from libsdr_tpu_torch.ops.fsk import FSKDetector
    from libsdr_tpu_torch.ops.nco import FreqShift
    from libsdr_tpu_torch.ops.wideband_rx import WidebandFM

    # Re-binding, or reusing a stage in another pipeline, must not inherit
    # a rotation folded by an earlier rewrite.
    reset_fusion_state(stages)

    def demod_takes_rot(d):
        return isinstance(d, FMDemod) and d.mode == "quadrature"

    def enabled_agc(st):
        return st if isinstance(st, AGC) and st.enabled else None

    out: List = []
    i = 0
    while i < len(stages):
        st = stages[i]
        nxt = stages[i + 1] if i + 1 < len(stages) else None
        nxt2 = stages[i + 2] if i + 2 < len(stages) else None
        exact_shift = (isinstance(st, FreqShift) and st.mode == "exact"
                       and st.freq != 0.0)
        if exact_shift and demod_takes_rot(nxt):
            nxt._pending_rot_freqs.append(st.freq)
            i += 1
            continue
        if exact_shift and isinstance(nxt, AMDemod):
            i += 1
            continue
        if (type(st) is Channelizer and demod_takes_rot(nxt)
                and not nxt._pending_rot_freqs):
            out.append(WidebandFM(st.m, st.p, gain=float(nxt.gain),
                                  prototype=st._proto, layout="channel"))
            i += 2
            continue
        if (isinstance(st, IQBaseBand) and type(st) is not IQBaseBand
                and st.fc != 0.0
                and (demod_takes_rot(nxt) or isinstance(nxt, AMDemod))):
            st.fold_nco = True
            if demod_takes_rot(nxt):
                nxt._pending_rot_freqs.append(st.fc)
            out.append(st)
            i += 1
            continue
        if type(st) is not IQBaseBand:
            out.append(st)
            i += 1
            continue
        if (demod_takes_rot(nxt) and not nxt._pending_rot_freqs
                and type(nxt2) is FSKDetector):
            out.append(AFSKFrontendFused(st, nxt, nxt2))
            i += 3
            continue
        if demod_takes_rot(nxt) and not nxt._pending_rot_freqs:
            fused = FMBasebandFused(st, nxt)
            i += 2
            if isinstance(nxt2, FMDeemph) and nxt2.enabled:
                fused.absorb_deemph(nxt2)
                i += 1
            out.append(fused)
            continue
        if isinstance(nxt, (USBDemod, AMDemod)):
            op = USBBasebandFused if isinstance(nxt, USBDemod) else \
                AMBasebandFused
            agc = enabled_agc(nxt2)
            out.append(op(st, agc))
            i += 3 if agc is not None else 2
            continue
        out.append(st)
        i += 1
    return out
