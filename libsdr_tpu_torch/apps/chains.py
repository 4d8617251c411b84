"""Receive chains shared by the app CLIs (counterpart of the analog chains
of ``libsdr_tpu.apps.chains``)."""

from __future__ import annotations

import numpy as np

from libsdr_tpu_torch.core.graph import Pipeline
from libsdr_tpu_torch.core.stream import StreamSpec
from libsdr_tpu_torch.ops import (AGC, AMDemod, FIRFilter, FMDeemph,
                                  FMDemod, IQBaseBand, USBDemod)


def fm_chain(fs: float, block: int, fc: float = 0.0, width: float = 200e3,
             order: int = 64, audio_rate: float = 48e3,
             deviation: float = 75e3, deemph: bool = True) -> Pipeline:
    """FM receiver: IQBaseBand -> FMDemod -> FMDeemph -> audio decimation.

    The discriminator must run at a rate covering the deviation (a WBFM
    signal demodulated below ~2.5x deviation aliases), so the baseband
    select decimates to an intermediate rate first and a low-pass FIR
    decimates the demodulated audio down to ``audio_rate``.
    """
    p = Pipeline(fm_stages(fs, fc, width, order, audio_rate, deviation,
                           deemph), name="fm_rx")
    p.bind(StreamSpec(np.complex64, fs, block))
    return p


def fm_stages(fs, fc=0.0, width=200e3, order=64, audio_rate=48e3,
              deviation=75e3, deemph=True):
    """Stage list for :func:`fm_chain` (reusable for live mode switching)."""
    demod_target = max(audio_rate, 2.5 * deviation)
    d1 = max(1, int(fs // demod_target))
    demod_rate = fs / d1
    d2 = max(1, round(demod_rate / audio_rate))
    stages = [
        IQBaseBand(fc=fc, width=width, order=order, decim=d1,
                   design="textbook"),
        FMDemod(gain=demod_rate / (2 * np.pi * deviation)),
    ]
    if deemph:
        stages.append(FMDeemph())
    if d2 > 1:
        stages.append(FIRFilter(order=33, kind="lowpass",
                                fu=0.4 * demod_rate / d2, decim=d2))
    return stages


def rx_stages(mode: str, fs: float, fc: float = 0.0):
    """Stage list for one receiver mode, used both to build a pipeline and
    to live-switch a running one (Pipeline.switch_stages)."""
    mode = mode.upper()
    if mode == "WFM":
        return fm_stages(fs, fc, width=200e3, audio_rate=48e3,
                         deviation=75e3)
    if mode == "NFM":
        return fm_stages(fs, fc, width=12.5e3, order=32, audio_rate=24e3,
                         deviation=4.5e3)
    if mode == "AM":
        return [IQBaseBand(fc=fc, width=10e3, order=32, out_rate=24e3,
                           design="textbook"), AMDemod(), AGC(tau=0.1)]
    if mode == "USB":
        # USB: the upper 3 kHz sideband
        return [IQBaseBand(fc=fc, ff=fc + 1500.0, width=3000.0, order=64,
                           out_rate=12e3, design="textbook"),
                USBDemod(), AGC(tau=0.1)]
    if mode == "LSB":
        return [IQBaseBand(fc=fc, ff=fc - 1500.0, width=3000.0, order=64,
                           out_rate=12e3, design="textbook"),
                USBDemod(), AGC(tau=0.1)]
    raise SystemExit(f"unknown mode {mode} (WFM/NFM/AM/USB/LSB)")


def rx_chain(mode: str, fs: float, block: int, fc: float = 0.0) -> Pipeline:
    """Multi-mode receiver: per-mode IQBaseBand parameters + demodulator."""
    p = Pipeline(rx_stages(mode, fs, fc), name=f"rx_{mode.upper()}")
    p.bind(StreamSpec(np.complex64, fs, block))
    return p
