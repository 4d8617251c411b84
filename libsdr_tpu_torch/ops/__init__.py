"""DSP ops of the analog, digital and wideband receive chains.  Every op is a
:class:`~libsdr_tpu_torch.core.block.Processor` over blocks with time on the
trailing axis."""

from libsdr_tpu_torch.ops import firdesign, siggen
from libsdr_tpu_torch.ops.fir import FIRFilter, fir_overlap_save, set_mxu_precision
from libsdr_tpu_torch.ops.nco import FreqShift
from libsdr_tpu_torch.ops.baseband import BaseBand, IQBaseBand
from libsdr_tpu_torch.ops.demod import AMDemod, USBDemod, FMDemod, FMDeemph
from libsdr_tpu_torch.ops.agc import AGC
from libsdr_tpu_torch.ops.iir import iir_first_order
from libsdr_tpu_torch.ops.fir_fm import (fir_afsk_exact, fir_am_exact,
                                         fir_exact, fir_fm_exact,
                                         fir_usb_exact)
from libsdr_tpu_torch.ops.fsk import ASKDetector, FSKDetector, sliding_sum
from libsdr_tpu_torch.ops.pll import pll, pll_bank
from libsdr_tpu_torch.ops.bitsync import BitStream
from libsdr_tpu_torch.ops.psk31 import BPSK31
from libsdr_tpu_torch.ops.fft import fft
from libsdr_tpu_torch.ops.fftfilter import FFTFilterBank
from libsdr_tpu_torch.ops.channelizer import Channelizer
from libsdr_tpu_torch.ops.wideband_rx import WidebandFM
from libsdr_tpu_torch.ops.utils import (
    Scale, Cast, AutoCast, ToComplex, RealPart, ImagPart, IQBalance,
    UnsignedToSigned, SignedToUnsigned, Interleave, Deinterleave,
)
from libsdr_tpu_torch.ops.resample import (SubSample, FracSubSample,
                                           InpolSubSampler, Resampler)
from libsdr_tpu_torch.ops.fixedpoint import (FMDemodInt, FMDeemphInt,
                                              IQBaseBandInt, fast_atan2_i16)
from libsdr_tpu_torch.ops.debug import BitDump, DebugStore, TextDump

__all__ = [
    "firdesign", "siggen", "FIRFilter", "fir_overlap_save",
    "set_mxu_precision", "FreqShift", "IQBaseBand", "BaseBand", "AMDemod",
    "USBDemod",
    "FMDemod", "FMDeemph", "AGC", "iir_first_order", "fir_fm_exact",
    "fir_exact", "fir_am_exact", "fir_usb_exact", "fir_afsk_exact",
    "ASKDetector", "FSKDetector", "sliding_sum", "pll", "pll_bank",
    "BitStream", "BPSK31", "fft", "FFTFilterBank", "Channelizer",
    "WidebandFM", "Scale", "Cast",
    "AutoCast", "ToComplex", "RealPart", "ImagPart", "IQBalance",
    "UnsignedToSigned", "SignedToUnsigned", "Interleave", "Deinterleave",
    "SubSample", "FracSubSample", "InpolSubSampler", "Resampler",
    "FMDemodInt", "FMDeemphInt", "IQBaseBandInt", "fast_atan2_i16",
    "BitDump", "DebugStore", "TextDump",
]
