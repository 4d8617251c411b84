"""PSK31 Varicode decoder (reference: src/psk31.{hh,cc} Varicode).

Varicode is the standard public PSK31 variable-length code (G3PLX): each
character's pattern contains no "00" and characters are separated by "00".
The decoder shifts bits in and, on two consecutive zeros, looks up the
accumulated pattern read as a binary integer (reference framing:
src/psk31.cc:70-91).

``_CODES`` maps characters to their standard varicode integers (pattern read
as binary, e.g. ' ' = "1" = 1, 'e' = "11" = 3, '!' = "1111111111" = 1023) —
the same standard code points the reference's table holds
(src/psk31.cc:10-44), including its quirk of decoding EOT (747) as newline.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# char -> varicode integer (standard PSK31 varicode, printable set + CR/LF).
_CODES: Dict[str, int] = {
    " ": 1, "e": 3, "t": 5, "o": 7, "a": 11, "i": 13, "n": 15, "r": 21,
    "s": 23, "l": 27, "\n": 29, "\r": 31, "h": 43, "d": 45, "c": 47,
    "u": 55, "m": 59, "f": 61, "p": 63, "=": 85, ".": 87, "g": 91,
    "y": 93, "b": 95, "w": 107, "T": 109, "S": 111, "-": 117, "E": 119,
    "v": 123, "A": 125, "I": 127, "O": 171, "C": 173, "R": 175, "D": 181,
    "0": 183, "M": 187, "1": 189, "k": 191, "P": 213, "L": 215, "F": 219,
    "N": 221, "x": 223, "B": 235, "2": 237, ":": 245, "[": 251, "3": 511,
    "G": 253,
    "j": 491, "<": 493, "\\": 495, ")": 503, "]": 507, "J": 509,
    "H": 341, "U": 343, "%%EOT%%": 747, "W": 349, "~": 727, "&": 699,
    "z": 469, ">": 471, "$": 475, "Q": 477, "q": 447, "4": 375,
    "X": 373, "_": 365, "6": 363, "*": 367, "Y": 379, "K": 381,
    "V": 437, "Z": 685, "{": 695, "}": 693, ";": 445, "5": 859,
    "7": 941, "/": 943, "8": 427, "9": 951, "'": 895, "\"": 351,
    "?": 687, "@": 701, "^": 703, "`": 735, "#": 1013, "+": 991,
    "|": 443, "!": 1023, "%": 1749,
}

# Decode table: integer -> char; EOT decodes as newline (reference quirk,
# src/psk31.cc:21-22).
_TABLE: Dict[int, str] = {}
for _ch, _code in _CODES.items():
    _TABLE[_code] = "\n" if _ch == "%%EOT%%" else _ch


class VaricodeDecoder:
    """Feed bits with :meth:`process`; returns decoded characters.  Framing
    as in the reference (src/psk31.cc:70-91): on two consecutive 0 bits,
    look up the accumulated pattern; unknown patterns are dropped."""

    def __init__(self) -> None:
        self.value = 0
        self.text = ""

    def process(self, bits: np.ndarray) -> str:
        out: List[str] = []
        for b in np.asarray(bits).astype(np.uint8):
            self.value = ((self.value << 1) | int(b & 1)) & 0xFFFF
            if (self.value & 0x3) == 0:
                self.value >>= 2
                if self.value:
                    c = _TABLE.get(self.value)
                    if c is not None:
                        out.append(c)
                    self.value = 0
        s = "".join(out)
        self.text += s
        return s


def varicode_encode_bits(text: str) -> np.ndarray:
    """Encode text as a varicode bit stream with '00' separators (fixture
    helper; the reference has no encoder)."""
    bits: List[int] = [0, 0]
    for ch in text:
        code = _CODES.get(ch)
        if code is None:
            continue
        bits.extend(int(b) for b in bin(code)[2:])
        bits.extend([0, 0])
    return np.asarray(bits, dtype=np.uint8)
