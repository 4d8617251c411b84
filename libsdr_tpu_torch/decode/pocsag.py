"""POCSAG pager decoder (reference: src/pocsag.{hh,cc}).

Protocol (reference: src/pocsag.hh:12-19): preamble of alternating bits, then
batches of [32-bit sync word 0x7CD215D8 | 8 slots x 2 words].  Idle words are
0x7A89C197; bit 31 distinguishes address (0) from message (1) words.  Every
word is BCH(31,21)-protected (see :mod:`libsdr_tpu_torch.decode.bch`).

Host-side FSM mirroring the reference state machine WAIT -> RECEIVE ->
CHECK_CONTINUE (src/pocsag.cc:40-95) bit for bit, including the address
assembly ``addr = ((word>>13)&0x3ffff)<<3 | slot`` (src/pocsag.cc:112) and
the text/numeric decode heuristics (src/pocsag.cc:220-251).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from libsdr_tpu_torch.decode.bch import bch_encode, bch_repair

SYNC_WORD = 0x7CD215D8
IDLE_WORD = 0x7A89C197

_BCD_TABLE = "084 2.6]195-3U7["  # reference: src/pocsag.cc:222

_CTRL_NAMES = [
    "<NUL>", "<SOH>", "<STX>", "<ETX>", "<EOT>", "<ENQ>", "<ACK>", "<BEL>",
    "<BS>", "<HT>", "<LF>", "<VT>", "<FF>", "<CR>", "<SO>", "<SI>",
    "<DLE>", "<DC1>", "<DC2>", "<DC3>", "<DC4>", "<NAK>", "<SYN>", "<ETB>",
    "<CAN>", "<EM>", "<SUB>", "<ESC>", "<FS>", "<GS>", "<RS>", "<US>",
]  # reference: src/pocsag.cc:179-218


def _ascii2text(byte: int) -> str:
    return _CTRL_NAMES[byte] if byte < 32 else chr(byte)


def _text_weight(c: int) -> int:
    """reference: src/pocsag.cc:226-238 (log-likelihood of a text char)."""
    if c < 32 or c == 127:
        return -5
    if (32 < c < 48) or (57 < c < 65) or (90 < c < 97) or (122 < c < 127):
        return -2
    return 1


def _numeric_weight(cp: str, pos: int) -> int:
    """reference: src/pocsag.cc:240-251."""
    if cp == "U":
        return -10
    if cp in "[]":
        return -5
    if cp in " .-":
        return -2
    if pos < 10:
        return 5
    return 0


@dataclasses.dataclass
class POCSAGMessage:
    """A received page (reference: src/pocsag.hh:40-88 POCSAG::Message)."""

    address: int
    function: int
    payload: bytes = b""   # packed 20-bit payload chunks, MSB-first
    bits: int = 0

    def add_payload(self, word: int) -> None:
        """Append the 20 data bits of a message word
        (reference: src/pocsag.cc:283-295)."""
        payload = bytearray(self.payload)
        for i in range(19, -1, -1):
            if self.bits % 8 == 0:
                payload.append(0)
            bit = (word >> (i + 11)) & 1
            payload[-1] = ((payload[-1] << 1) | bit) & 0xFF
            self.bits += 1
        self.payload = bytes(payload)

    # -- decodes ------------------------------------------------------------

    def _iter_text_bytes(self):
        """7-bit chars, bits reversed within each char
        (reference: src/pocsag.cc:297-314)."""
        byte = 0
        for i in range(self.bits):
            byte_idx, bit_idx = i // 8, 7 - (i % 8)
            bit = (self.payload[byte_idx] >> bit_idx) & 1
            byte = ((byte >> 1) | (bit << 6)) & 0x7F
            if i % 7 == 6:
                yield byte

    def as_text(self) -> str:
        return "".join(_ascii2text(b) for b in self._iter_text_bytes())

    def _iter_bcd(self):
        n = self.bits // 4
        for i in range(n // 2):
            yield _BCD_TABLE[(self.payload[i] >> 4) & 0xF]
            yield _BCD_TABLE[self.payload[i] & 0xF]
        if n % 2:
            yield _BCD_TABLE[self.payload[n // 2] & 0xF]

    def as_numeric(self) -> str:
        """BCD decode (reference: src/pocsag.cc:317-332)."""
        return "".join(self._iter_bcd())

    def estimate_text(self) -> int:
        return sum(_text_weight(b) for b in self._iter_text_bytes())

    def estimate_numeric(self) -> int:
        """reference: src/pocsag.cc:361-373 (position index is the payload
        byte index, two BCD digits share one position)."""
        w = 0
        for k, c in enumerate(self._iter_bcd()):
            w += _numeric_weight(c, k // 2)
        return w

    def best_decode(self) -> str:
        if self.bits == 0:
            return "(alert)"
        if self.estimate_text() >= self.estimate_numeric():
            return self.as_text()
        return self.as_numeric()


class POCSAGDecoder:
    """Streaming POCSAG FSM; feed bits with :meth:`process`, collect
    :attr:`messages` (reference: src/pocsag.cc:40-95)."""

    WAIT, RECEIVE, CHECK_CONTINUE = range(3)

    def __init__(self) -> None:
        self.state = self.WAIT
        self.bits = 0
        self.bitcount = 0
        self.slot = 0
        self.message: Optional[POCSAGMessage] = None
        self.messages: List[POCSAGMessage] = []

    def process(self, bits: np.ndarray) -> List[POCSAGMessage]:
        """Consume a bit vector; returns messages completed in this call."""
        completed_before = len(self.messages)
        for b in np.asarray(bits).astype(np.uint8):
            self.bits = ((self.bits << 1) | int(b & 1)) & 0xFFFFFFFFFFFFFFFF
            if self.state == self.WAIT:
                st, word = bch_repair(self.bits & 0xFFFFFFFF)
                if st == 0 and word == SYNC_WORD:
                    self.message = None
                    self.state, self.bitcount, self.slot = self.RECEIVE, 0, 0
            elif self.state == self.RECEIVE:
                self.bitcount += 1
                if self.bitcount == 64:
                    self.bitcount = 0
                    for w in ((self.bits >> 32) & 0xFFFFFFFF,
                              self.bits & 0xFFFFFFFF):
                        st, word = bch_repair(w)
                        if st == 0:
                            self._process_word(word)
                    self.slot += 1
                    if self.slot == 8:
                        self.state = self.CHECK_CONTINUE
                        self.bitcount = 0
            else:  # CHECK_CONTINUE
                self.bitcount += 1
                if self.bitcount == 32:
                    st, word = bch_repair(self.bits & 0xFFFFFFFF)
                    if st == 0 and word == SYNC_WORD:
                        self.state, self.slot, self.bitcount = self.RECEIVE, 0, 0
                    else:
                        self._finish_message()
                        self.state = self.WAIT
        return self.messages[completed_before:]

    def _process_word(self, word: int) -> None:
        """reference: src/pocsag.cc:98-127."""
        if word == IDLE_WORD:
            self._finish_message()
        elif (word & 0x80000000) == 0:  # address word
            self._finish_message()
            addr = (((word >> 13) & 0x3FFFF) << 3) + self.slot
            func = (word >> 11) & 0x3
            self.message = POCSAGMessage(addr, func)
        else:  # message word
            if self.message is not None:
                self.message.add_payload(word)

    def _finish_message(self) -> None:
        if self.message is not None:
            self.messages.append(self.message)
            self.message = None


def pocsag_decode_bits(bits: np.ndarray) -> List[POCSAGMessage]:
    """One-shot decode of a dense bit vector by the native C++ state
    machine (``libsdr_tpu_torch.native``, ~10 ns a bit): at hundreds of
    channels the Python loop of :class:`POCSAGDecoder` would take the whole
    receive bank's time.  The messages are those of a fresh
    :class:`POCSAGDecoder` over the same bits, which stays as the plain
    version (tests/test_torch_native.py)."""
    import ctypes

    from libsdr_tpu_torch import native

    bits = np.ascontiguousarray(np.asarray(bits, dtype=np.uint8))
    lib = native.get_lib()
    # True upper bounds, so the native decoder never truncates: every
    # message takes at least one 32-bit address word, and 32 payload bits
    # pack into at most 3 bytes.
    cap_msgs = len(bits) // 32 + 4
    cap_payload = len(bits) // 2 + 64
    meta = np.zeros(cap_msgs * 4, np.int64)
    payload = np.zeros(cap_payload, np.uint8)
    n = lib.pocsag_decode(
        bits.ctypes.data_as(ctypes.c_void_p), len(bits),
        meta.ctypes.data_as(ctypes.c_void_p),
        payload.ctypes.data_as(ctypes.c_void_p), cap_msgs, cap_payload)
    msgs: List[POCSAGMessage] = []
    off = 0
    for i in range(int(n)):
        addr, func, nbytes, nbits = (int(v) for v in meta[i * 4:i * 4 + 4])
        msgs.append(POCSAGMessage(addr, func,
                                  payload=bytes(payload[off:off + nbytes]),
                                  bits=nbits))
        off += nbytes
    return msgs


# ---------------------------------------------------------------------------
# Encoder (fixture helper — the reference has no transmitter)
# ---------------------------------------------------------------------------

def _encode_text_payload(text: str) -> List[int]:
    """Pack 7-bit LSB-first-reversed chars into 20-bit message words, as the
    inverse of Message::asText (src/pocsag.cc:297-314)."""
    bits: List[int] = []
    for ch in text:
        c = ord(ch) & 0x7F
        # Transmitted bit order: the decoder shifts each received bit into a
        # byte from the top (>>1 | bit<<6), so it reads chars LSB-first.
        for k in range(7):
            bits.append((c >> k) & 1)
    words = []
    for i in range(0, len(bits), 20):
        chunk = bits[i:i + 20] + [0] * max(0, 20 - len(bits[i:i + 20]))
        val = 0
        for b in chunk:
            val = (val << 1) | b
        words.append(0x80000000 | (val << 11))
    return words


def pocsag_encode_batch(address: int, function: int, text: str) -> np.ndarray:
    """Build a transmittable POCSAG bit vector: preamble + sync + one batch
    (or more) carrying a text page for ``address``.  Returns a uint8 bit
    array suitable for FSK modulation or direct decoder tests."""
    slot = address & 0x7
    addr_field = (address >> 3) & 0x3FFFF
    # data21 layout: bit 20 = address-flag (0), bits 19..2 = address field,
    # bits 1..0 = function.  The final word puts data21 at bits 31..11, so
    # the decoder reads (word>>13)&0x3ffff == addr_field and
    # (word>>11)&3 == func (src/pocsag.cc:112-113).
    addr_data21 = (addr_field << 2) | (function & 0x3)
    addr_word = bch_encode(addr_data21)
    msg_words = []
    for w in _encode_text_payload(text):
        data21 = (w >> 11) & 0x1FFFFF
        data21 |= 1 << 20  # message-word flag (bit 31 of the final word)
        msg_words.append(bch_encode(data21))
    idle = IDLE_WORD

    # Assemble one or more batches of 16 words with the page at `slot`.
    words: List[int] = []
    payload = list(msg_words)
    batch: List[int] = [idle] * 16
    batch[2 * slot] = addr_word
    pos = 2 * slot + 1
    while payload and pos < 16:
        batch[pos] = payload.pop(0)
        pos += 1
    words.extend(batch)
    while payload:  # continuation batches
        batch = [idle] * 16
        pos = 0
        while payload and pos < 16:
            batch[pos] = payload.pop(0)
            pos += 1
        words.extend(batch)

    bits: List[int] = []
    bits.extend([1, 0] * 300)  # preamble >= 576 alternating bits
    n_batches = len(words) // 16
    for bi in range(n_batches):
        for k in range(31, -1, -1):
            bits.append((SYNC_WORD >> k) & 1)
        for w in words[bi * 16:(bi + 1) * 16]:
            for k in range(31, -1, -1):
                bits.append((w >> k) & 1)
    # Trailing garbage so CHECK_CONTINUE sees no sync and flushes the message.
    bits.extend([0] * 64)
    return np.asarray(bits, dtype=np.uint8)
