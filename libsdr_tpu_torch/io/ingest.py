"""Streaming ingest (counterpart of ``libsdr_tpu.io.ingest``): blocks from a
capture file through the native ring buffer and pump thread (the host-side
analog of the reference's Queue-fed sources; reference: src/queue.cc,
src/rtlsource.cc).

Every stream pads its final partial block: complex blocks with zeros, raw
u8 wire blocks with 128 (the wire's zero).
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.native import (FilePump, RingBuffer, s16_iq_to_planar,
                                     u8_iq_to_planar, u8_iq_to_planar_bf16)


def _ring_blocks(path: str, frame_bytes: int, block_bytes: int,
                 ring_bytes: int) -> Iterator[np.ndarray]:
    """Raw blocks of ``block_bytes`` from a file through a :class:`FilePump`;
    the last one holds the whole frames left (shorter, never empty)."""
    ring = RingBuffer(max(ring_bytes, 4 * block_bytes))
    pump = FilePump(path, ring)
    try:
        while True:
            raw = ring.take(block_bytes)
            if raw is not None:
                yield raw
                continue
            if ring.eos:
                n = ring.available
                n -= n % frame_bytes
                raw = ring.take(n) if n else None
                if raw is not None:
                    yield raw
                return
            time.sleep(0.0005)
    finally:
        pump.stop()
        ring.close()


def _bf16_planes(re_u16: np.ndarray, im_u16: np.ndarray,
                 pad_to: int = 0) -> Complex:
    """uint16 bit patterns -> a Complex of torch.bfloat16 planes (zero-padded
    to ``pad_to``); viewed through int16, which every torch version takes."""
    def plane(u):
        t = torch.from_numpy(np.ascontiguousarray(u).view(np.int16))
        t = t.view(torch.bfloat16)
        if len(t) < pad_to:
            t = torch.cat([t, torch.zeros(pad_to - len(t),
                                          dtype=torch.bfloat16)])
        return t
    return Complex(plane(re_u16), plane(im_u16))


def stream_raw_iq(path: str, block_size: int, dtype=np.uint8,
                  ring_bytes: int = 1 << 24) -> Iterator[np.ndarray]:
    """Yield complex64 IQ blocks from a raw interleaved capture file (the
    rtl_sdr wire format by default, reference: src/rtlsource.cc:141-145),
    a native ingest thread reading ahead."""
    dt = np.dtype(dtype)
    if dt == np.uint8:
        convert = u8_iq_to_planar
    elif dt == np.int16:
        convert = s16_iq_to_planar
    else:
        raise ValueError(
            f"stream_raw_iq: unsupported sample dtype {dt} "
            "(uint8 and int16 captures only)")
    frame = 2 * dt.itemsize
    for raw in _ring_blocks(path, frame, block_size * frame, ring_bytes):
        re, im = convert(raw.view(dt))
        blk = np.zeros(block_size, np.complex64)
        blk.real[:len(re)], blk.imag[:len(im)] = re, im
        yield blk


def u8_wire_to_planes(raw: torch.Tensor, plane_dtype=None) -> Complex:
    """Interleaved u8 IQ ``(..., 2N)`` -> planar :class:`Complex` ``(...,
    N)`` on the tensor's device: ``(u8 - 128) / 128`` cast to
    ``plane_dtype`` (default float32).

    On the card the raw wire is what crosses PCIe (2 B a sample: half the
    bytes of bf16 planes, a quarter of float32).  The values are exact in
    bf16, so the planes equal the host LUT's
    (:func:`libsdr_tpu_torch.native.u8_iq_to_planar_bf16`) bit for bit."""
    dt = torch.float32 if plane_dtype is None else plane_dtype
    v = raw.reshape(raw.shape[:-1] + (raw.shape[-1] // 2, 2))

    def plane(k):   # contiguous, as the kernels take their planes
        f = (v[..., k].to(torch.float32) - 128.0) * (1.0 / 128.0)
        return f.to(dt).contiguous()
    return Complex(plane(0), plane(1))


def stream_raw_iq_u8(path: str, block_size: int,
                     ring_bytes: int = 1 << 24) -> Iterator[np.ndarray]:
    """Yield the RAW interleaved u8 wire blocks (shape ``(2*block_size,)``)
    of a capture file: the host converts nothing; feed
    :func:`u8_wire_to_planes` on the card.  The final partial block is
    padded with 128."""
    for raw in _ring_blocks(path, 2, 2 * block_size, ring_bytes):
        if len(raw) < 2 * block_size:
            blk = np.full(2 * block_size, 128, np.uint8)
            blk[:len(raw)] = raw
            raw = blk
        yield raw


def stream_raw_iq_bf16(path: str, block_size: int,
                       ring_bytes: int = 1 << 24) -> Iterator[Complex]:
    """Like :func:`stream_raw_iq` for u8 captures, but the native converter
    writes bfloat16 planes (lossless for 8-bit sources, half the bytes):
    yields :class:`Complex` blocks of ``torch.bfloat16`` planes on the
    host, for a pipeline bound with ``plane_dtype=torch.bfloat16``."""
    for raw in _ring_blocks(path, 2, 2 * block_size, ring_bytes):
        yield _bf16_planes(*u8_iq_to_planar_bf16(raw), pad_to=block_size)
