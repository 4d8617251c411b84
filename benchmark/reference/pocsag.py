"""POCSAG (ITU-R M.584-2) written out plainly for the benchmark: the BCH(31,21)
code, an encoder for the traffic generator and a decoder for the reference.

Nothing here imports the program.  The encoder follows the reference
libsdr's bit layout (preamble of 576+ alternating bits, then batches of a
sync word and 8 slots of 2 words, a text page's 7-bit characters LSB
first); the decoder is the reference's WAIT -> RECEIVE -> CHECK_CONTINUE
state machine (libsdr ``src/pocsag.cc``), with up to two bit errors a word
repaired.  A decoded page is ``(address, function, payload_bits)``: the raw
20-bit data of its message words, so that two decoders are compared on the
bits they received and not on a rendering of them.
"""

from __future__ import annotations

import functools

import numpy as np

SYNC_WORD = 0x7CD215D8
IDLE_WORD = 0x7A89C197
BCH_POLY = 0o3551           # g(x) = x^10+x^9+x^8+x^6+x^5+x^3+1
PREAMBLE_BITS = 600


def _parity(x: int) -> int:
    return bin(x & 0xFFFFFFFF).count("1") & 1


def syndrome(word: int) -> int:
    """The BCH(31,21) remainder of ``word >> 1`` and the even-parity bit
    above it: zero for a valid codeword."""
    reg = (word & 0xFFFFFFFF) >> 1
    for bit in range(30, 9, -1):
        if reg >> bit & 1:
            reg ^= BCH_POLY << (bit - 10)
    return reg | (_parity(word) << 10)


@functools.lru_cache(maxsize=1)
def _error_table() -> dict:
    """syndrome -> the error mask of every 1- and 2-bit error of a word."""
    table = {}
    for i in range(32):
        table.setdefault(syndrome(1 << i), 1 << i)
    for i in range(32):
        for j in range(i + 1, 32):
            table.setdefault(syndrome((1 << i) | (1 << j)),
                             (1 << i) | (1 << j))
    return table


def repair(word: int):
    """The codeword within two bit errors of ``word``, or None."""
    s = syndrome(word)
    if s == 0:
        return word & 0xFFFFFFFF
    mask = _error_table().get(s)
    return None if mask is None else (word ^ mask) & 0xFFFFFFFF


def encode_word(data21: int) -> int:
    """A 32-bit codeword: 21 data bits, 10 check bits, even parity."""
    reg = (data21 & 0x1FFFFF) << 10
    for bit in range(30, 9, -1):
        if reg >> bit & 1:
            reg ^= BCH_POLY << (bit - 10)
    word = (((data21 & 0x1FFFFF) << 10) | reg) << 1
    return word | _parity(word)


def encode_page(address: int, function: int, text: str) -> np.ndarray:
    """The bits of one text page: preamble, then batches with the address
    word in slot ``address & 7`` and the message words after it, then 64
    zeros (so that a decoder sees no sync and closes the page)."""
    chars = []
    for ch in text:
        c = ord(ch) & 0x7F
        chars.extend((c >> k) & 1 for k in range(7))
    msg = []
    for i in range(0, len(chars), 20):
        chunk = chars[i:i + 20] + [0] * max(0, 20 - len(chars[i:i + 20]))
        val = int("".join(map(str, chunk)), 2)
        msg.append(encode_word((1 << 20) | val))
    slot = address & 7
    words = [IDLE_WORD] * 16
    words[2 * slot] = encode_word(((address >> 3) & 0x3FFFF) << 2
                                  | (function & 3))
    pos = 2 * slot + 1
    while msg:
        if pos == len(words):
            words.extend([IDLE_WORD] * 16)
        words[pos] = msg.pop(0)
        pos += 1
    bits = [1, 0] * (PREAMBLE_BITS // 2)
    for b in range(0, len(words), 16):
        for w in [SYNC_WORD] + words[b:b + 16]:
            bits.extend((w >> k) & 1 for k in range(31, -1, -1))
    bits.extend([0] * 64)
    return np.asarray(bits, np.uint8)


def _windows(bits: np.ndarray) -> np.ndarray:
    """w[i] = the 32 bits ending at bit i (MSB first), for i >= 31."""
    b = np.asarray(bits, np.uint64)
    if len(b) < 32:
        return np.zeros(0, np.uint64)
    view = np.lib.stride_tricks.sliding_window_view(b, 32)
    return view @ (np.uint64(1) << np.arange(31, -1, -1, dtype=np.uint64))


def _popcount(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    return np.unpackbits(x.view(np.uint8)).reshape(len(x), 64).sum(1)


def sync_ends(bits: np.ndarray) -> np.ndarray:
    """The bit indices at which a sync word (within two bit errors) ends."""
    w = _windows(bits)
    return np.flatnonzero(_popcount(w ^ np.uint64(SYNC_WORD)) <= 2) + 31


def _word(bits, start: int) -> int:
    return int("".join(str(int(b)) for b in bits[start:start + 32]), 2)


def decode(bits: np.ndarray) -> list:
    """Every page in ``bits``: [(address, function, payload bit tuple)]."""
    bits = np.asarray(bits, np.uint8) & 1
    syncs = sync_ends(bits)
    pages, page = [], None

    def finish():
        nonlocal page
        if page is not None:
            pages.append((page[0], page[1], tuple(page[2])))
        page = None

    i = 0
    while True:
        nxt = syncs[syncs >= i]
        if not len(nxt):
            break
        pos = int(nxt[0]) + 1
        page = None                      # a fresh sync starts a new batch
        while True:                      # RECEIVE: 8 slots of 2 words
            if pos + 512 > len(bits):    # cut off: the page never closes
                pos, page = len(bits), None
                break
            for slot in range(8):
                for k in range(2):
                    w = repair(_word(bits, pos + 64 * slot + 32 * k))
                    if w is None:
                        continue
                    if w == IDLE_WORD:
                        finish()
                    elif not w & 0x80000000:
                        finish()
                        page = ((((w >> 13) & 0x3FFFF) << 3) + slot,
                                (w >> 11) & 3, [])
                    elif page is not None:
                        page[2].extend((w >> s) & 1
                                       for s in range(30, 10, -1))
            pos += 512
            # CHECK_CONTINUE: another batch only behind another sync word
            if pos + 32 <= len(bits) and repair(_word(bits, pos)) \
                    == SYNC_WORD:
                pos += 32
                continue
            pos += 32
            break
        finish()
        i = pos
    return pages
