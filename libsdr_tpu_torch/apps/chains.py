"""Receive chains shared by the app CLIs (counterpart of
``libsdr_tpu.apps.chains``)."""

from __future__ import annotations

import numpy as np

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.graph import Pipeline, resolve_device
from libsdr_tpu_torch.core.ragged import compact, concat_host
from libsdr_tpu_torch.core.runtime import stream_blocks
from libsdr_tpu_torch.core.stream import StreamSpec
from libsdr_tpu_torch.ops import (AGC, AMDemod, ASKDetector, BitStream,
                                  FIRFilter, FMDeemph, FMDemod, FSKDetector,
                                  IQBaseBand, USBDemod)


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


def pocsag_front_end(fs: float, block: int, fc: float = 0.0,
                     baud: float = 1200.0, channels=()) -> Pipeline:
    """POCSAG bit front end: IQBaseBand -> FMDemod -> ASKDetector ->
    BitStream(NORMAL); the fusion pass makes the first two one
    FMBasebandFused op."""
    p = Pipeline([
        IQBaseBand(fc=fc, width=12.5e3, order=32, out_rate=24e3,
                   design="textbook"),
        FMDemod(),
        ASKDetector(invert=True),  # POCSAG mark (1) = negative deviation
        BitStream(baud, mode="normal"),
    ], name="pocsag_fe")
    p.bind(StreamSpec(np.complex64, fs, block, channels=tuple(channels)))
    return p


def afsk_front_end(fs_audio: float, block: int, baud: float = 1200.0,
                   f_mark: float = 1200.0, f_space: float = 2200.0) -> Pipeline:
    """AFSK1200 bit front end from demodulated audio: FSKDetector ->
    BitStream(TRANSITION)."""
    p = Pipeline([
        FSKDetector(baud, f_mark, f_space),
        BitStream(baud, mode="transition"),
    ], name="afsk_fe")
    p.bind(StreamSpec(np.float32, fs_audio, block))
    return p


def rtty_front_end(fs_audio: float, block: int, baud: float = 45.45,
                   f_mark: float = 930.0, f_space: float = 1100.0) -> Pipeline:
    """RTTY front end: FSK at twice the baud rate (half-bits, for the
    1.5-stop-bit framing) -> BitStream(NORMAL)."""
    p = Pipeline([
        FSKDetector(2 * baud, f_mark, f_space),
        BitStream(2 * baud, mode="normal"),
    ], name="rtty_fe")
    p.bind(StreamSpec(np.float32, fs_audio, block))
    return p


def run_bit_chain(pipeline: Pipeline, samples: np.ndarray, device=None):
    """Stream samples through a bit front end on ``device`` (default: the
    card) and return the dense bit vector (a list of them for a bank)."""
    device = resolve_device(device)
    block = pipeline.in_spec.block_size
    step = pipeline.compile()
    carry = pipeline.init_carry(device)
    outs = []
    for blk in stream_blocks(samples, block):
        carry, y = step(carry, cplx.as_block(blk, pipeline.in_spec.real_dtype,
                                             device))
        outs.append(y.to_numpy())
    return compact(concat_host(outs))
