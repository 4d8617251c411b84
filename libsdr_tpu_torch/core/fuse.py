"""Graph peephole fusions run by ``Pipeline._bind`` before spec propagation
(counterpart of ``libsdr_tpu.core.fuse``).

Rules, each exact in exact arithmetic, on adjacent stages of one Pipeline:

1. ``FreqShift(f, exact) -> FMDemod(quadrature)``: the discriminator only
   sees ``x[n] * conj(x[n-1])``, where the mixer rotation ``e^(-i w n)``
   collapses to the constant ``e^(-i w)``.  The FreqShift is dropped and the
   demod folds the constant in.
2. ``IQBaseBand -> FMDemod(quadrature) [-> FMDeemph]``: one
   :class:`FMBasebandFused` op computes the audio straight from the raw IQ
   block through the fused FIR + FM + de-emphasis kernel.

The JAX package gates rule 2 on a TPU backend; the fused op here is exact on
every device, so the rule applies wherever it matches.
"""

from __future__ import annotations

from typing import List


def reset_fusion_state(stages: List) -> None:
    """Clear the fusion state that :func:`fuse_stages` writes onto stage
    instances (rotations folded into an FMDemod)."""
    from libsdr_tpu_torch.ops.demod import FMDemod

    for st in stages:
        if isinstance(st, FMDemod):
            st._pending_rot_freqs = []


def fuse_stages(stages: List) -> List:
    """Return the rewritten stage list."""
    from libsdr_tpu_torch.ops.baseband import IQBaseBand
    from libsdr_tpu_torch.ops.demod import FMDeemph, FMDemod
    from libsdr_tpu_torch.ops.fm_fused import FMBasebandFused
    from libsdr_tpu_torch.ops.nco import FreqShift

    # Re-binding, or reusing a stage in another pipeline, must not inherit
    # a rotation folded by an earlier rewrite.
    reset_fusion_state(stages)

    def demod_takes_rot(d):
        return isinstance(d, FMDemod) and d.mode == "quadrature"

    out: List = []
    i = 0
    while i < len(stages):
        st = stages[i]
        nxt = stages[i + 1] if i + 1 < len(stages) else None
        if (isinstance(st, FreqShift) and st.mode == "exact"
                and st.freq != 0.0 and demod_takes_rot(nxt)):
            nxt._pending_rot_freqs.append(st.freq)
            i += 1
            continue
        if (type(st) is IQBaseBand and demod_takes_rot(nxt)
                and not nxt._pending_rot_freqs):
            fused = FMBasebandFused(st, nxt)
            i += 2
            nxt2 = stages[i] if i < len(stages) else None
            if isinstance(nxt2, FMDeemph) and nxt2.enabled:
                fused.absorb_deemph(nxt2)
                i += 1
            out.append(fused)
            continue
        out.append(st)
        i += 1
    return out
