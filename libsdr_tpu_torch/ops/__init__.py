"""DSP ops of the FM receive chain.  Every op is a
:class:`~libsdr_tpu_torch.core.block.Processor` over blocks with time on the
trailing axis."""

from libsdr_tpu_torch.ops import firdesign, siggen
from libsdr_tpu_torch.ops.fir import FIRFilter, fir_overlap_save, set_mxu_precision
from libsdr_tpu_torch.ops.nco import FreqShift
from libsdr_tpu_torch.ops.baseband import IQBaseBand
from libsdr_tpu_torch.ops.demod import FMDemod, FMDeemph
from libsdr_tpu_torch.ops.iir import iir_first_order
from libsdr_tpu_torch.ops.fir_fm import fir_fm_exact

__all__ = [
    "firdesign", "siggen", "FIRFilter", "fir_overlap_save",
    "set_mxu_precision", "FreqShift", "IQBaseBand", "FMDemod", "FMDeemph",
    "iir_first_order", "fir_fm_exact",
]
