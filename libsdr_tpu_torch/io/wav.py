"""WAV file I/O (copied from ``libsdr_tpu.io.wav``, numpy only).

RIFF/PCM WAV (8/16/32-bit, 1-2 channels); stereo is read as I/Q pairs
(complex64).  The files written are those of the JAX package, bit for bit.
"""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np

from libsdr_tpu_torch.core.stream import RuntimeSDRError


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file.

    Returns:
      (samples, rate): samples is float32 in [-1, 1), shape (n,) for mono or
      (channels, n) for multi-channel.
    """
    with wave.open(path, "rb") as w:
        nch, sw, rate, nframes = (w.getnchannels(), w.getsampwidth(),
                                  w.getframerate(), w.getnframes())
        raw = w.readframes(nframes)
    if sw == 1:
        # 8-bit WAV is unsigned (reference: src/wavfile.cc:139-145)
        data = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        data = (data - 128.0) / 128.0
    elif sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise RuntimeSDRError(f"Unsupported WAV sample width {sw}")
    if nch > 1:
        data = data.reshape(-1, nch).T
    return np.ascontiguousarray(data), rate


def read_wav_iq(path: str) -> Tuple[np.ndarray, int]:
    """Read a 2-channel WAV as complex IQ (stereo = I/Q, the reference's
    convention, src/wavfile.cc:139-145)."""
    data, rate = read_wav(path)
    if data.ndim != 2 or data.shape[0] != 2:
        raise RuntimeSDRError("IQ WAV must have exactly 2 channels")
    return (data[0] + 1j * data[1]).astype(np.complex64), rate


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """Write float [-1,1) or int16 samples as 16-bit PCM WAV
    (reference: src/wavfile.hh:81-105 WavSink)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    nch = samples.shape[0]
    if samples.dtype != np.int16:
        clipped = np.clip(samples.astype(np.float64), -1.0, 32767.0 / 32768.0)
        samples = np.round(clipped * 32768.0).astype(np.int16)
    inter = np.ascontiguousarray(samples.T).reshape(-1)
    with wave.open(path, "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(2)
        w.setframerate(int(rate))
        w.writeframes(inter.tobytes())


def write_wav_iq(path: str, iq: np.ndarray, rate: int) -> None:
    """Write complex IQ as a stereo WAV (I=left, Q=right)."""
    iq = np.asarray(iq)
    write_wav(path, np.stack([iq.real, iq.imag]), rate)


class WavWriter:
    """Streaming WAV sink: append blocks as they are produced, header
    finalized on :meth:`close` (reference: src/wavfile.hh:81-105 WavSink,
    whose RIFF sizes are back-patched on close).  Context-manager friendly.
    """

    def __init__(self, path: str, rate: int, channels: int = 1):
        self._w = wave.open(path, "wb")
        self._w.setnchannels(channels)
        self._w.setsampwidth(2)
        self._w.setframerate(int(rate))
        self._channels = channels

    def write(self, samples: np.ndarray) -> None:
        """Append a block (float [-1,1) or int16; (n,) mono or (ch, n))."""
        samples = np.asarray(samples)
        if samples.ndim == 2:
            samples = samples.T.reshape(-1)  # interleave channels
        if samples.dtype != np.int16:
            samples = np.clip(np.asarray(samples, np.float32), -1.0,
                              32767.0 / 32768.0)
            samples = np.round(samples * 32768.0).astype(np.int16)
        self._w.writeframes(samples.tobytes())

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_raw_iq(path: str, dtype=np.uint8) -> np.ndarray:
    """Read raw interleaved IQ (e.g. rtl_sdr captures: u8 I,Q pairs,
    the wire format of the reference's RTLSource, src/rtlsource.cc:141-145)."""
    raw = np.fromfile(path, dtype=dtype)
    raw = raw.astype(np.float32)
    if np.issubdtype(dtype, np.unsignedinteger):
        half = float(1 << (np.iinfo(dtype).bits - 1))
        raw = (raw - half) / half
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)


def write_raw(path: str, samples: np.ndarray) -> None:
    """Raw sample serialization (reference: src/utils.hh:524-588
    StreamSource/StreamSink)."""
    np.asarray(samples).tofile(path)
