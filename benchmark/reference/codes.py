"""The line codes of the multi-mode bank's three other services, written out
plainly for the benchmark: an encoder for the traffic generator and a
decoder for the reference each.  Nothing here imports the program.

* **AX.25 v2.2** (APRS Protocol Reference 1.0.1): a UI frame's addresses
  (callsign characters shifted left by one, the SSID byte ``0x60 | ssid <<
  1``, the extension bit on the last address), control 0x03, PID 0xF0, the
  information field and the FCS (CRC-16/X.25: reflected polynomial 0x8408,
  start 0xFFFF, sent inverted, low byte first); HDLC framing with 0x7E
  flags, a 0 stuffed after five 1s, bytes least significant bit first; NRZI
  on the air (a 0 changes the tone, a 1 keeps it).
* **ITA2** (Baudot) at 45.45 baud, counted in half-bits (two a bit, so
  that 1.5 stop bits are whole).  The frame is the one libsdr's decoder
  (``src/baudot.cc``) reads, and so the program's: two mark half-bits, the
  five code bits most significant first, three space half-bits.  It departs
  from the published frame (a space start bit, the code least significant
  bit first, 1.5 mark stop bits): it is that frame time-reversed, the half
  stop bit moved to its other end.
* **Varicode** (G3PLX, PSK31): each character a pattern with no "00",
  characters parted by "00".
"""

from __future__ import annotations

import re

import numpy as np

# ---------------------------------------------------------------------------
# AX.25 / HDLC
# ---------------------------------------------------------------------------

FLAG = 0x7E


def fcs(data: bytes) -> int:
    """The frame check sequence of ``data``: CRC-16/X.25 (reflected 0x8408,
    start 0xFFFF, the final value inverted)."""
    crc = 0xFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    return crc ^ 0xFFFF


def _address(call: str, ssid: int, last: bool) -> bytes:
    name = (call.upper() + "      ")[:6].encode("ascii")
    return bytes(c << 1 for c in name) + bytes(
        [0x60 | (ssid & 0xF) << 1 | int(last)])


def ui_frame(src: str, dst: str, info: bytes) -> bytes:
    """A UI frame without its FCS: destination, source, control, PID and
    the information field."""
    return (_address(dst, 0, False) + _address(src, 0, True)
            + bytes([0x03, 0xF0]) + info)


def _bits_lsb(data: bytes) -> list:
    return [(b >> k) & 1 for b in data for k in range(8)]


def hdlc_bits(frame: bytes, lead_flags: int, tail_flags: int = 2
              ) -> np.ndarray:
    """The HDLC bits of ``frame`` and its FCS: ``lead_flags`` flags, the
    stuffed body, ``tail_flags`` flags."""
    f = fcs(frame)
    body, ones = [], 0
    for b in _bits_lsb(frame + bytes([f & 0xFF, f >> 8])):
        body.append(b)
        ones = ones + 1 if b else 0
        if ones == 5:
            body.append(0)
            ones = 0
    flag = _bits_lsb(bytes([FLAG]))
    return np.asarray(flag * lead_flags + body + flag * tail_flags, np.uint8)


def nrzi(bits: np.ndarray, level: int = 1) -> np.ndarray:
    """The line levels of ``bits`` from ``level``: a 0 toggles, a 1 keeps."""
    flips = np.cumsum(np.asarray(bits) == 0)
    return ((level + flips) % 2).astype(np.uint8)


def deframe(bits: np.ndarray) -> list:
    """The frames (without FCS) between flags in a decoded bit stream whose
    FCS checks: each run between two flags unstuffed (a 0 after five 1s
    dropped), refused with seven 1s in a row or a length not a whole
    number of bytes or under 16 bytes."""
    b = np.asarray(bits, np.uint8) & 1
    if len(b) < 8:
        return []
    flag = np.asarray(_bits_lsb(bytes([FLAG])), np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(b, 8)
    ends = np.flatnonzero((win == flag).all(1)) + 8   # one past each flag
    out = []
    for s, e in zip(ends[:-1], ends[1:] - 8):
        if e - s < 16 * 8:
            continue
        seg = b[s:e]
        run = np.convolve(seg, np.ones(7, np.int64), "valid")
        if (run == 7).any():
            continue
        five = np.convolve(seg, np.ones(5, np.int64), "valid")
        # a stuffed 0: right after five 1s
        stuffed = np.zeros(len(seg), bool)
        stuffed[5:] = (five[:-1] == 5) & (seg[5:] == 0)
        seg = seg[~stuffed]
        if len(seg) % 8:
            continue
        data = np.packbits(seg.reshape(-1, 8)[:, ::-1], axis=1)[:, 0]
        data = bytes(data.tolist())
        if len(data) >= 16 and fcs(data[:-2]) == data[-2] | data[-1] << 8:
            out.append(data[:-2])
    return out


# ---------------------------------------------------------------------------
# ITA2 (RTTY)
# ---------------------------------------------------------------------------

LETTERS = "\0E\nA SIU\rDRJNFCKTZLWHYPQOBG\0MXV\0"
FIGURES = "\x003\n- \x0787\r$4',!:(5\")2#6019?&\0./;\0"
LTRS, FIGS, SPACE = 31, 27, 4
STOP_HALF_BITS = 3
FRAME_HALF_BITS = 2 + 10 + STOP_HALF_BITS


def ita2_codes(text: str) -> list:
    """The ITA2 codes of ``text`` (letters, figures and spaces), led by a
    letters shift, with a shift before each change of case."""
    codes, case = [LTRS], "L"
    for ch in text.upper():
        if ch == " ":
            codes.append(SPACE)
            case = "L"       # a space returns a receiver to letters
            continue
        if ch in LETTERS[1:] and ch not in "\0\n\r":
            if case != "L":
                codes.append(LTRS)
                case = "L"
            codes.append(LETTERS.index(ch))
        elif ch in FIGURES[1:]:
            if case != "F":
                codes.append(FIGS)
                case = "F"
            codes.append(FIGURES.index(ch))
        else:
            raise ValueError(f"no ITA2 code for {ch!r}")
    return codes


def ita2_half_bits(text: str, idle: int = 16) -> np.ndarray:
    """The half-bits of ``text``: ``idle`` mark half-bits, each code's frame
    (module docstring), ``idle`` mark half-bits."""
    out = [1] * idle
    for c in ita2_codes(text):
        out += [1, 1]
        for k in range(4, -1, -1):
            out += [(c >> k) & 1] * 2
        out += [0] * STOP_HALF_BITS
    return np.asarray(out + [1] * idle, np.uint8)


def ita2_decode(half_bits: np.ndarray) -> str:
    """The text in a half-bit stream: a frame is taken where the last 15
    half-bits open with two marks and close with three spaces, at least 15
    half-bits after the last one taken; its code read from the second of
    each pair of data half-bits."""
    out, case, since = [], "L", 0
    reg = 0
    for h in np.asarray(half_bits, np.uint8) & 1:
        reg = ((reg << 1) | int(h)) & ((1 << FRAME_HALF_BITS) - 1)
        since += 1
        if since < FRAME_HALF_BITS:
            continue
        if reg >> (FRAME_HALF_BITS - 2) != 3 or reg & 7:
            continue
        since = 0
        code = 0
        for j in range(5):
            code |= ((reg >> (STOP_HALF_BITS + 2 * j)) & 1) << j
        if code == LTRS:
            case = "L"
        elif code == FIGS:
            case = "F"
        else:
            if code == SPACE:
                case = "L"
            out.append((LETTERS if case == "L" else FIGURES)[code])
    return "".join(out)


# ---------------------------------------------------------------------------
# Varicode (PSK31)
# ---------------------------------------------------------------------------

VARICODE = {
    " ": "1", "e": "11", "t": "101", "o": "111", "a": "1011", "i": "1101",
    "n": "1111", "r": "10101", "s": "10111", "l": "11011", "h": "101011",
    "d": "101101", "c": "101111", "u": "110111", "m": "111011",
    "f": "111101", "p": "111111", "g": "1011011", "y": "1011101",
    "b": "1011111", "w": "1101011", "v": "1111011", "k": "10111111",
    "x": "11011111", "q": "110111111", "j": "111101011", "z": "111010101",
    "0": "10110111", "1": "10111101", "2": "11101101", "4": "101110111",
    "6": "101101011", "8": "110101011",
}
_FROM_VARICODE = {v: k for k, v in VARICODE.items()}


def varicode_bits(text: str) -> np.ndarray:
    """The Varicode bits of ``text``, each character followed by "00"."""
    out = []
    for ch in text:
        out += [int(b) for b in VARICODE[ch]] + [0, 0]
    return np.asarray(out, np.uint8)


def varicode_decode(bits: np.ndarray) -> str:
    """The characters in a bit stream: the bits between two runs of two or
    more 0s read as a pattern; patterns of no character dropped."""
    s = "".join("1" if b & 1 else "0" for b in np.asarray(bits, np.uint8))
    return "".join(_FROM_VARICODE.get(p, "") for p in re.split("00+", s)
                   if p)
