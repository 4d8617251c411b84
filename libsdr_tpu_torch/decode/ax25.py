"""AX.25 / HDLC frame decoder (reference: src/ax25.{hh,cc}).

Bit-stream deframer: 0x7E flag detection, bit-unstuffing (drop the 0 after
five 1s), abort on seven consecutive 1s, LSB-first byte assembly, CRC-CCITT
check, and address-field unpacking (callsign chars <<1 + SSID)
(reference: src/ax25.cc:100-161).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def _crc_ccitt_table():
    """Standard CRC-CCITT (X.25/HDLC, reflected, poly 0x8408) table."""
    table = []
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
        table.append(crc & 0xFFFF)
    return table


_CRC_TABLE = _crc_ccitt_table()


def crc_ccitt(data: bytes, init: int = 0xFFFF) -> int:
    crc = init
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc & 0xFFFF


def check_crc_ccitt(frame: bytes) -> bool:
    """Frame (incl. FCS) is valid iff the running CRC equals the HDLC "good"
    residual 0xF0B8 (reference: src/ax25.cc:45-52)."""
    return crc_ccitt(frame) == 0xF0B8


@dataclasses.dataclass
class AX25Address:
    call: str = ""
    ssid: int = 0

    def __str__(self) -> str:
        return f"{self.call}-{self.ssid}"


def _unpack_call(buf: bytes) -> Tuple[AX25Address, bool]:
    """reference: src/ax25.cc:54-64."""
    call = "".join(chr(b >> 1) for b in buf[:6]).replace(" ", "")
    ssid = (buf[6] & 0x1F) >> 1
    addr_ext = not (buf[6] & 0x01)
    return AX25Address(call, ssid), addr_ext


@dataclasses.dataclass
class AX25Message:
    """Parsed UI frame (reference: src/ax25.hh:40-60 AX25::Message)."""

    to: AX25Address = dataclasses.field(default_factory=AX25Address)
    frm: AX25Address = dataclasses.field(default_factory=AX25Address)
    via: List[AX25Address] = dataclasses.field(default_factory=list)
    payload: bytes = b""

    @classmethod
    def from_frame(cls, frame: bytes) -> "AX25Message":
        """Parse a CRC-stripped frame (reference: src/ax25.cc:228-245)."""
        buf = frame
        to, addr_ext = _unpack_call(buf)
        buf = buf[7:]
        frm, addr_ext = _unpack_call(buf)
        buf = buf[7:]
        via = []
        while addr_ext and len(buf) >= 7:
            v, addr_ext = _unpack_call(buf)
            buf = buf[7:]
            via.append(v)
        return cls(to=to, frm=frm, via=via, payload=bytes(buf))

    def __str__(self) -> str:
        s = f"{self.frm} > {self.to}"
        if self.via:
            s += " via " + ", ".join(map(str, self.via))
        return s + f" N={len(self.payload)}\n" + \
            self.payload.decode("latin-1")


class AX25Decoder:
    """Streaming HDLC deframer; feed bits with :meth:`process`
    (reference: src/ax25.cc:100-161)."""

    MAX_FRAME = 512  # reference: src/ax25.cc:144

    def __init__(self) -> None:
        self.bitstream = 0
        self.bitbuffer = 0x80
        self.state = 0
        self.rxbuffer = bytearray()
        self.messages: List[AX25Message] = []
        self.frames: List[bytes] = []  # raw CRC-valid frames (sans FCS)

    def process(self, bits: np.ndarray) -> List[AX25Message]:
        new_before = len(self.messages)
        for b in np.asarray(bits).astype(np.uint8):
            self.bitstream = ((self.bitstream << 1) | int(b & 1)) & 0xFFFFFFFF
            if (self.bitstream & 0xFF) == 0x7E:  # flag
                # A parseable frame needs two 7-byte addresses + FCS; random
                # noise segments pass CRC with probability ~2^-16, so short
                # "frames" must be skipped, not parsed (they would crash the
                # address unpack).
                if self.state == 1 and len(self.rxbuffer) >= 16:
                    if check_crc_ccitt(bytes(self.rxbuffer)):
                        frame = bytes(self.rxbuffer[:-2])
                        self.frames.append(frame)
                        self.messages.append(AX25Message.from_frame(frame))
                self.state = 1
                self.rxbuffer = bytearray()
                self.bitbuffer = 0x80
                continue
            if (self.bitstream & 0x7F) == 0x7F:  # abort: 7 ones
                self.state = 0
                continue
            if not self.state:
                continue
            if (self.bitstream & 0x3F) == 0x3E:  # stuffed bit
                continue
            self.bitbuffer |= (self.bitstream & 0x01) << 8
            if self.bitbuffer & 0x01:  # 8 bits assembled
                if len(self.rxbuffer) >= self.MAX_FRAME:
                    self.state = 0
                    continue
                self.rxbuffer.append((self.bitbuffer >> 1) & 0xFF)
                self.bitbuffer = 0x80
                continue
            self.bitbuffer >>= 1
        return self.messages[new_before:]


def ax25_decode_bits(bits: np.ndarray) -> List[AX25Message]:
    """One-shot deframe of a dense bit vector by the native C++ HDLC state
    machine (``libsdr_tpu_torch.native``).  The frames are those of a fresh
    :class:`AX25Decoder` over the same bits, which stays as the plain
    version (tests/test_torch_native.py)."""
    import ctypes

    from libsdr_tpu_torch import native

    bits = np.ascontiguousarray(np.asarray(bits, dtype=np.uint8))
    lib = native.get_lib()
    # True upper bounds (a CRC-valid frame is >= 3 bytes, ~32 bits with the
    # shared flag), so the native deframer never truncates.
    cap_frames = len(bits) // 32 + 8
    cap_bytes = len(bits) // 8 + 64
    meta = np.zeros(cap_frames * 2, np.int64)
    frames = np.zeros(cap_bytes, np.uint8)
    n = lib.ax25_decode(
        bits.ctypes.data_as(ctypes.c_void_p), len(bits),
        meta.ctypes.data_as(ctypes.c_void_p),
        frames.ctypes.data_as(ctypes.c_void_p), cap_frames, cap_bytes)
    msgs: List[AX25Message] = []
    for i in range(int(n)):
        off, length = int(meta[i * 2]), int(meta[i * 2 + 1])
        if length < 14:  # a CRC-lucky noise segment, not a parseable frame
            continue
        msgs.append(AX25Message.from_frame(bytes(frames[off:off + length])))
    return msgs


# ---------------------------------------------------------------------------
# Encoder (fixture helper — the reference has no transmitter)
# ---------------------------------------------------------------------------

def _pack_call(call: str, ssid: int, last: bool) -> bytes:
    buf = bytearray((call.upper() + "      ")[:6].encode("ascii"))
    buf = bytearray(b << 1 for b in buf)
    buf.append(((ssid & 0xF) << 1) | 0x60 | (0x01 if last else 0x00))
    return bytes(buf)


def ax25_frame_bits(frm: str, to: str, info: bytes,
                    via: Optional[List[str]] = None,
                    frm_ssid: int = 0, to_ssid: int = 0,
                    ctrl: int = 0x03, pid: int = 0xF0,
                    n_flags: int = 4) -> np.ndarray:
    """Build an HDLC bit vector of one AX.25 frame: flags + addresses +
    ctrl + PID + info + FCS, with bit stuffing; LSB-first.  Defaults build a
    UI frame (ctrl 0x03, PID 0xF0 — what APRS expects, reference:
    src/aprs.cc:18-41)."""
    via = via or []
    frame = bytearray()
    frame += _pack_call(to, to_ssid, last=False)
    addrs = [(v, 0) for v in via]
    frame += _pack_call(frm, frm_ssid, last=not addrs)
    for k, (v, ss) in enumerate(addrs):
        frame += _pack_call(v, ss, last=(k == len(addrs) - 1))
    frame += bytes([ctrl, pid])
    frame += info
    fcs = crc_ccitt(bytes(frame)) ^ 0xFFFF
    frame += bytes([fcs & 0xFF, (fcs >> 8) & 0xFF])

    bits: List[int] = []
    for _ in range(n_flags):
        bits += [0, 1, 1, 1, 1, 1, 1, 0]
    ones = 0
    for byte in frame:
        for k in range(8):  # LSB first
            bit = (byte >> k) & 1
            bits.append(bit)
            if bit:
                ones += 1
                if ones == 5:
                    bits.append(0)  # stuff
                    ones = 0
            else:
                ones = 0
    for _ in range(n_flags):
        bits += [0, 1, 1, 1, 1, 1, 1, 0]
    return np.asarray(bits, dtype=np.uint8)
