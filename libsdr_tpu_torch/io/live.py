"""Live streaming ingest (counterpart of ``libsdr_tpu.io.live``): IQ or audio
blocks from a network socket or FIFO, through the native SPSC ring and a
native pump thread.

The analog of the reference's *live* sources, the rtl_sdr driver thread
(reference: src/rtlsource.cc:133-145) and the PortAudio callback
(reference: src/portaudio.cc:129-155): the radio front end lives across a
wire (classically an ``rtl_tcp`` server beside the antenna) and this module
terminates that wire.  A live source cannot block its sender, so the
overflow is dropped in whole frames and *counted*, the reference's
back-pressure-by-drop contract (reference: src/firfilter.hh:219-226).

URL forms:

- ``tcp://host:port``    connect and pull (the rtl_tcp topology)
- ``tcp-listen://:port`` accept one pushing client (port 0 = ephemeral)
- ``udp://:port``        datagram sink
- ``fifo:///path``       named local pipe (``fifo:///dev/stdin`` reads a
  shell pipeline, the reference's StreamSource on an istream, reference:
  src/utils.hh:524-588)

:class:`RTLTCPSource` speaks the rtl_tcp protocol (the 12-byte ``RTL0``
header, big-endian ``(cmd: u8, value: u32)`` commands), so a stock
``rtl_tcp`` server is a live front end (the reference's RTLSource tuning
API, src/rtlsource.cc:36-76).
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from libsdr_tpu_torch.io.ingest import _bf16_planes
from libsdr_tpu_torch.native import (LivePump, RingBuffer, s16_iq_to_planar,
                                     s16_to_f32, u8_iq_to_planar,
                                     u8_iq_to_planar_bf16, u8_to_f32)


@dataclass
class LiveStats:
    """Drop and throughput accounting of a live source (what the
    reference's overflow printouts gesture at, src/portaudio.cc:129-155)."""

    bytes_in: int = 0
    bytes_dropped: int = 0
    blocks: int = 0
    t0: float = 0.0
    port: int = -1   # bound port of listen/udp sources (resolves :0)

    @property
    def drop_fraction(self) -> float:
        return self.bytes_dropped / self.bytes_in if self.bytes_in else 0.0

    def sustained_msps(self, bytes_per_sample: int = 2) -> float:
        """Average delivered complex-sample rate since the stream started."""
        dt = time.perf_counter() - self.t0
        kept = self.bytes_in - self.bytes_dropped
        return kept / bytes_per_sample / dt / 1e6 if dt > 0 else 0.0


def _parse_url(url: str):
    kind, _, rest = url.partition("://")
    if kind == "fifo":
        return "fifo", rest, None
    host, _, port = rest.rpartition(":")
    if not port:
        raise ValueError(f"live url needs a port: {url!r}")
    return kind, host or "0.0.0.0", int(port)


def open_live_pump(url: str, ring: RingBuffer, frame: int = 2,
                   chunk: int = 1 << 18) -> LivePump:
    """Start the native ingest thread of a live URL (see the module's
    docstring)."""
    kind, host, port = _parse_url(url)
    if kind == "tcp":
        return LivePump.tcp_connect(host, port, ring, chunk=chunk,
                                    frame=frame)
    if kind == "tcp-listen":
        return LivePump.tcp_listen(port, ring, chunk=chunk, frame=frame)
    if kind == "udp":
        return LivePump.udp(port, ring, chunk=chunk, frame=frame)
    if kind == "fifo":
        return LivePump.fifo(host, ring, chunk=chunk, frame=frame)
    raise ValueError(f"unknown live source kind {kind!r} in {url!r}")


def _host_block(blk: np.ndarray, pad_to=None) -> np.ndarray:
    """A host block as it is, or a final partial one zero-padded to the
    pipeline's block size."""
    if pad_to is None or len(blk) >= pad_to:
        return blk
    z = np.zeros(pad_to, blk.dtype)
    z[:len(blk)] = blk
    return z


def _u8_block_to_c64(raw: np.ndarray) -> np.ndarray:
    """Interleaved u8 wire bytes -> one complex64 block."""
    re, im = u8_iq_to_planar(raw)
    blk = np.empty(len(re), np.complex64)
    blk.real, blk.imag = re, im
    return blk


def _block_loop(ring: RingBuffer, pump, block_size: int, itemsize: int,
                convert, stats: Optional[LiveStats],
                timeout: Optional[float], to_block,
                items_per_frame: int = 2, own: bool = True):
    """The take-and-convert loop of every live stream (``stream_raw_iq``'s
    end-of-stream handling, plus the idle timeout and the drop counts).

    ``items_per_frame``: wire items an output sample, 2 for interleaved IQ,
    1 for mono audio.  ``timeout`` is seconds with NO WIRE BYTES: it
    watches the pump's ``bytes_in``, so a healthy low-rate wire that takes
    longer than ``timeout`` to fill a block keeps streaming.  ``own``:
    False when the pump and ring belong to the caller (a reusable
    :class:`RTLTCPSource`) and outlive this generator."""
    frame = items_per_frame * itemsize
    bytes_per_block = block_size * frame

    def drain():
        """At the end (end of stream or idle timeout): what is buffered,
        whole blocks first and never more than a block a yield, then one
        zero-padded partial."""
        while True:
            n = min(ring.available, bytes_per_block)
            n -= n % frame
            if n == 0:
                return
            raw = ring.take(n)
            if raw is None:
                return
            yield to_block(convert(raw), pad_to=block_size)

    def count():
        if stats is not None:
            stats.bytes_in = pump.bytes_in
            stats.bytes_dropped = pump.bytes_dropped

    if stats is not None:
        stats.t0 = time.perf_counter()
    last_progress = time.perf_counter()
    last_bytes_in = pump.bytes_in
    try:
        while True:
            raw = ring.take(bytes_per_block)
            if raw is None:
                if ring.eos:
                    yield from drain()
                    break
                if timeout is not None:
                    got = pump.bytes_in
                    if got != last_bytes_in:
                        last_bytes_in = got
                        last_progress = time.perf_counter()
                    elif time.perf_counter() - last_progress > timeout:
                        yield from drain()   # the buffered tail decodes
                        break
                time.sleep(0.0005)
                continue
            count()
            if stats is not None:
                stats.blocks += 1
            yield to_block(convert(raw))
    finally:
        count()
        if own:
            pump.stop()
            count()
            ring.close()


def stream_live_iq(url: str, block_size: int, dtype=np.uint8,
                   ring_bytes: int = 1 << 24,
                   stats: Optional[LiveStats] = None,
                   timeout: Optional[float] = None) -> Iterator[np.ndarray]:
    """Yield complex64 IQ blocks from a live wire (see the module's
    docstring for the URLs).  ``stats`` (a :class:`LiveStats`) follows the
    pump's drop accounting; ``timeout`` (seconds with no data) ends an idle
    stream instead of blocking for ever."""
    dt = np.dtype(dtype)
    if dt == np.uint8:
        return (u8_wire_block(raw, block_size) for raw in stream_live_u8(
            url, block_size, ring_bytes, stats, timeout))
    if dt != np.int16:
        raise ValueError(f"stream_live_iq: unsupported sample dtype {dt}")

    def convert(raw):
        re, im = s16_iq_to_planar(raw.view(np.int16))
        blk = np.empty(len(re), np.complex64)
        blk.real, blk.imag = re, im
        return blk
    frame = 2 * dt.itemsize
    ring = RingBuffer(max(ring_bytes, 4 * block_size * frame))
    pump = open_live_pump(url, ring, frame=frame)
    if stats is not None:
        stats.port = pump.port
    return _block_loop(ring, pump, block_size, dt.itemsize, convert, stats,
                       timeout, _host_block)


def stream_live_iq_bf16(url: str, block_size: int,
                        ring_bytes: int = 1 << 24,
                        stats: Optional[LiveStats] = None,
                        timeout: Optional[float] = None) -> Iterator:
    """Like :func:`stream_live_iq` for u8 wires, but yields :class:`Complex`
    blocks of ``torch.bfloat16`` planes (lossless for 8-bit sources, half
    the bytes), for a pipeline bound with ``plane_dtype=torch.bfloat16``."""
    return (u8_wire_block(raw, block_size, bf16=True)
            for raw in stream_live_u8(url, block_size, ring_bytes, stats,
                                      timeout))


def stream_live_u8(url: str, block_size: int, ring_bytes: int = 1 << 24,
                   stats: Optional[LiveStats] = None,
                   timeout: Optional[float] = None) -> Iterator[np.ndarray]:
    """The raw bytes of a u8 IQ wire in chunks of ``block_size`` frames (2
    bytes each), the chunks :func:`stream_live_iq` and
    :func:`stream_live_iq_bf16` convert, unconverted and unpadded: the last
    chunk of a wire that ends or times out may be shorter.
    :func:`u8_wire_block` turns a chunk into their block, so a process that
    receives the chunks from the one that reads the wire
    (``parallel/halo.py::broadcast_chunks``) makes the same blocks."""
    ring = RingBuffer(max(ring_bytes, 8 * block_size))
    pump = open_live_pump(url, ring, frame=2)
    if stats is not None:
        stats.port = pump.port
    return _block_loop(ring, pump, block_size, 1, lambda raw: raw, stats,
                       timeout, lambda raw, pad_to=None: raw)


def u8_wire_block(raw: np.ndarray, block_size: int, bf16: bool = False):
    """One block of :func:`stream_live_iq` (complex64), or with ``bf16`` of
    :func:`stream_live_iq_bf16` (a Complex of bfloat16 planes), from a
    chunk of :func:`stream_live_u8`: the same conversion, zero-padded to
    ``block_size`` samples."""
    if bf16:
        return _bf16_planes(*u8_iq_to_planar_bf16(raw), pad_to=block_size)
    return _host_block(_u8_block_to_c64(raw), pad_to=block_size)


def stream_live_audio(url: str, block_size: int, dtype=np.int16,
                      ring_bytes: int = 1 << 22,
                      stats: Optional[LiveStats] = None,
                      timeout: Optional[float] = None) -> Iterator[np.ndarray]:
    """Yield float32 MONO audio blocks from a live wire of s16 or u8
    samples (the PortAudio source's analog, for demodulated-audio
    consumers such as the APRS service; reference: src/portaudio.cc)."""
    dt = np.dtype(dtype)
    if dt == np.int16:
        def conv(raw):
            return s16_to_f32(raw.view(np.int16))
    elif dt == np.uint8:
        conv = u8_to_f32
    else:
        raise ValueError(f"stream_live_audio: unsupported dtype {dt}")
    ring = RingBuffer(max(ring_bytes, 4 * block_size * dt.itemsize))
    pump = open_live_pump(url, ring, frame=dt.itemsize)
    if stats is not None:
        stats.port = pump.port
    return _block_loop(ring, pump, block_size, dt.itemsize, conv, stats,
                       timeout, _host_block, items_per_frame=1)


# ---------------------------------------------------------------------------
# TX side: samples INTO a wire (the ostream StreamSink's analog, reference:
# src/utils.hh:524-588), closing the live loop back: `tx --wire
# tcp://host:port` feeds `scanner --live tcp-listen://:port`.
# ---------------------------------------------------------------------------

def _open_wire_writer(url: str, timeout: float):
    """(send(bytes), close()) of a live URL, the sender's side; every
    socket operation waits ``timeout`` seconds at most."""
    import socket as _socket

    kind, host, port = _parse_url(url)
    if kind == "tcp":
        s = _socket.create_connection((host, port), timeout=timeout)
        return s.sendall, s.close
    if kind == "tcp-listen":
        ls = _socket.socket()
        ls.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        ls.bind(("", port))
        ls.listen(1)
        ls.settimeout(timeout)
        try:
            c, _ = ls.accept()
        finally:
            ls.close()
        c.settimeout(timeout)
        return c.sendall, c.close
    if kind == "udp":
        s = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        dest = (host if host != "0.0.0.0" else "127.0.0.1", port)

        def send(data, _mtu=32768):
            for off in range(0, len(data), _mtu):
                s.sendto(data[off:off + _mtu], dest)
        return send, s.close
    if kind == "fifo":
        f = open(host, "wb")

        def send(data):
            f.write(data)
            f.flush()
        return send, f.close
    raise ValueError(f"unknown live sink kind {kind!r} in {url!r}")


def iq_to_u8_wire(iq: np.ndarray) -> np.ndarray:
    """Complex IQ -> the u8 rtl_sdr wire (round(x * 128 + 128), clipped to
    0-255, interleaved), as :func:`send_live_iq` sends it."""
    iq = np.asarray(iq)
    inter = np.empty(2 * len(iq), np.float32)
    inter[0::2], inter[1::2] = iq.real, iq.imag
    return np.clip(np.round(inter * 128.0 + 128.0), 0, 255).astype(np.uint8)


def send_live_iq(url: str, iq: np.ndarray, rate: Optional[float] = None,
                 chunk: int = 1 << 16, timeout: float = 10.0) -> int:
    """Push complex IQ to a live wire in the u8 rtl_sdr format.  ``rate``:
    pace to that many complex samples/s (a radio's pace); None = as fast as
    the wire takes it.  Returns the bytes sent."""
    return send_live_bytes(url, iq_to_u8_wire(iq).tobytes(), rate, 2, chunk,
                           timeout)


def send_live_audio(url: str, audio: np.ndarray,
                    rate: Optional[float] = None, chunk: int = 1 << 16,
                    timeout: float = 10.0) -> int:
    """Push mono float audio to a live wire as s16 samples."""
    s16 = np.clip(np.asarray(audio, np.float32) * 32767.0,
                  -32768, 32767).astype(np.int16)
    return send_live_bytes(url, s16.tobytes(), rate, 2, chunk, timeout)


def send_live_bytes(url: str, data: bytes, rate: Optional[float] = None,
                    bytes_per_sample: int = 2, chunk: int = 1 << 16,
                    timeout: float = 10.0) -> int:
    """Push wire bytes as they are, paced to ``rate`` samples/s of
    ``bytes_per_sample`` when given."""
    send, close = _open_wire_writer(url, timeout)
    try:
        t0 = time.perf_counter()
        sent = 0
        for off in range(0, len(data), chunk):
            send(data[off:off + chunk])
            sent += min(chunk, len(data) - off)
            if rate is not None:
                ahead = (sent / bytes_per_sample / rate
                         - (time.perf_counter() - t0))
                if ahead > 0:
                    time.sleep(ahead)
        return sent
    finally:
        close()


# ---------------------------------------------------------------------------
# rtl_tcp client, the real-world remote RTL front end
# ---------------------------------------------------------------------------

class RTLTCPSource:
    """Client of a stock ``rtl_tcp`` server: a tunable live RTL2832 front
    end over TCP (the network mirror of the reference's RTLSource API,
    src/rtlsource.cc:36-76).

    On connect the server sends a 12-byte header, ``b"RTL0"``, the tuner
    type (u32be) and its gain count (u32be), then an endless u8
    interleaved IQ stream; the client sends 5-byte big-endian ``(cmd: u8,
    value: u32)`` commands (0x01 set_freq, 0x02 set_sample_rate, 0x03
    set_gain_mode, 0x04 set_gain, 0x08 set_agc_mode).  The stream goes
    through a native pump on the same connection (:meth:`LivePump.adopt`).
    """

    CMD_FREQ = 0x01
    CMD_RATE = 0x02
    CMD_GAIN_MODE = 0x03
    CMD_GAIN = 0x04
    CMD_AGC = 0x08

    def __init__(self, host: str, port: int = 1234,
                 sample_rate: float = 2.4e6, frequency: float = 100e6,
                 ring_bytes: int = 1 << 24, timeout: float = 5.0):
        import socket

        self.stats = LiveStats()
        self._ctrl = socket.create_connection((host, port), timeout=timeout)
        self._ctrl.settimeout(timeout)
        header = b""
        while len(header) < 12:
            got = self._ctrl.recv(12 - len(header))
            if not got:
                raise ConnectionError("rtl_tcp: server closed during header")
            header += got
        if header[:4] != b"RTL0":
            raise ConnectionError(
                f"rtl_tcp: bad magic {header[:4]!r} (not an rtl_tcp server)")
        self.tuner_type, self.tuner_gain_count = struct.unpack(
            ">II", header[4:12])
        self.sample_rate = float(sample_rate)
        self.frequency = float(frequency)
        self.set_sample_rate(sample_rate)
        self.set_frequency(frequency)
        self._ring = RingBuffer(ring_bytes)
        self._pump = LivePump.adopt(self._ctrl, self._ring, frame=2)

    def _cmd(self, cmd: int, value: int) -> None:
        self._ctrl.sendall(struct.pack(">BI", cmd, int(value) & 0xFFFFFFFF))

    def set_frequency(self, hz: float) -> None:
        """reference: src/rtlsource.cc:36-47 setFrequency."""
        self.frequency = float(hz)
        self._cmd(self.CMD_FREQ, int(hz))

    def set_sample_rate(self, hz: float) -> None:
        """reference: src/rtlsource.cc:58-69 setSampleRate."""
        self.sample_rate = float(hz)
        self._cmd(self.CMD_RATE, int(hz))

    def set_gain(self, tenths_db: int) -> None:
        self._cmd(self.CMD_GAIN_MODE, 1)
        self._cmd(self.CMD_GAIN, tenths_db)

    def enable_agc(self, on: bool = True) -> None:
        """reference: src/rtlsource.cc:71-76 enableAGC."""
        self._cmd(self.CMD_GAIN_MODE, 0 if on else 1)
        self._cmd(self.CMD_AGC, 1 if on else 0)

    def blocks(self, block_size: int,
               timeout: Optional[float] = None) -> Iterator[np.ndarray]:
        """Yield complex64 blocks from the live stream.  The pump and ring
        are this source's (``own=False``): the generator ending (timeout,
        break, garbage collection) leaves the connection, ring and tuner
        usable, so retune-then-restream works; only :meth:`close` tears
        the source down."""
        return _block_loop(self._ring, self._pump, block_size, 1,
                           _u8_block_to_c64, self.stats, timeout,
                           _host_block, own=False)

    def close(self) -> None:
        self._pump.stop()
        self._ring.close()
        self._ctrl.close()
