"""Baudot / ITA2 (RTTY) decoder (reference: src/baudot.{hh,cc}).

The decoder consumes *half-bits* (2 per data bit) so that 1.5-stop-bit
framing is detectable: for 45.45 Bd RTTY the upstream bit-sync runs at
90.90 Bd (reference: src/baudot.hh:10-18).  A symbol is recognized when the
half-bit shift register matches the stop/start frame pattern for the chosen
stop-bit mode (reference: src/baudot.cc:26-51); the five data bits are
sampled LSB-first at every second half-bit (src/baudot.cc:95-99).
"""

from __future__ import annotations

from typing import List

import numpy as np

# ITA2 code tables (standard; reference: src/baudot.cc:9-14).
LETTERS = ["\0", "E", "\n", "A", " ", "S", "I", "U", "\n", "D", "R", "J",
           "N", "F", "C", "K", "T", "Z", "L", "W", "H", "Y", "P", "Q",
           "O", "B", "G", "\0", "M", "X", "V", "\0"]
FIGURES = ["\0", "3", "\n", "-", " ", "\a", "8", "7", "\n", "?", "4", "'",
           ",", "!", ":", "(", "5", "\"", ")", "2", "#", "6", "0", "1",
           "9", "?", "&", "\0", ".", "/", ";", "\0"]

CHAR_STF = 27  # shift to figures
CHAR_STL = 31  # shift to letters
CHAR_SPA = 4   # space resets to letters

# (stop_half_bits, bits_per_symbol, pattern, mask) per stop-bit mode
# (reference: src/baudot.cc:26-51)
_FRAMING = {
    "1":   (2, 14, 0x3000, 0x3003),
    "1.5": (3, 15, 0x6000, 0x6007),
    "2":   (4, 16, 0xC000, 0xC00F),
}


class BaudotDecoder:
    """Feed half-bits with :meth:`process`; returns decoded text."""

    def __init__(self, stop_bits: str = "1.5"):
        if stop_bits not in _FRAMING:
            raise ValueError(f"stop_bits must be one of {list(_FRAMING)}")
        self.stop_hbits, self.bits_per_symbol, self.pattern, self.mask = \
            _FRAMING[stop_bits]
        self.bitstream = 0
        self.bitcount = 0
        self.mode = "letters"
        self.text = ""

    def process(self, half_bits: np.ndarray) -> str:
        out: List[str] = []
        for b in np.asarray(half_bits).astype(np.uint8):
            self.bitstream = ((self.bitstream << 1) | int(b & 1)) & 0xFFFF
            self.bitcount += 1
            if (self.bitcount >= self.bits_per_symbol and
                    (self.bitstream & self.mask) == self.pattern):
                self.bitcount = 0
                code = 0
                for j in range(5):
                    shift = self.stop_hbits + 2 * j
                    code |= ((self.bitstream >> shift) & 1) << j
                if code == CHAR_STL:
                    self.mode = "letters"
                elif code == CHAR_STF:
                    self.mode = "figures"
                else:
                    if code == CHAR_SPA:
                        self.mode = "letters"
                    table = LETTERS if self.mode == "letters" else FIGURES
                    out.append(table[code])
        s = "".join(out)
        self.text += s
        return s


def baudot_encode_bits(text: str, stop_bits: str = "1.5") -> np.ndarray:
    """Encode text as a half-bit stream in the exact framing the reference
    decoder matches (fixture helper; the reference has no encoder).

    The reference's frame mask/pattern (src/baudot.cc:26-51) together with
    its data sampling at half-bit offsets ``stop_hbits + 2j``
    (src/baudot.cc:95-99) imply a per-symbol frame of

        [1, 1]  +  [d4 d4 d3 d3 ... d0 d0]  +  [0] * stop_hbits

    i.e. two mark half-bits, the five code bits MSB-first as half-bit pairs,
    then ``stop_hbits`` zero half-bits — ``bits_per_symbol`` halves total,
    matching the shift-register pattern at the instant the last zero lands.
    """
    stop_hbits, _, _, _ = _FRAMING[stop_bits]
    mode = "letters"
    half_bits: List[int] = [1, 1] * 8  # idle mark (never matches the pattern)

    def emit(code: int):
        half_bits.extend([1, 1])
        for j in range(4, -1, -1):
            bit = (code >> j) & 1
            half_bits.extend([bit, bit])
        half_bits.extend([0] * stop_hbits)

    # Lead with a letters-shift: its data half-bits are all mark, so the
    # decoder cannot false-match mid-frame before it has sync.
    emit(CHAR_STL)

    for ch in text.upper():
        if ch == " ":
            emit(CHAR_SPA)
            mode = "letters"
        elif ch in LETTERS and (mode == "letters" or ch not in FIGURES):
            if mode != "letters":
                emit(CHAR_STL)
                mode = "letters"
            emit(LETTERS.index(ch))
        elif ch in FIGURES:
            if mode != "figures":
                emit(CHAR_STF)
                mode = "figures"
            emit(FIGURES.index(ch))
    half_bits.extend([1, 1] * 8)
    return np.asarray(half_bits, dtype=np.uint8)
