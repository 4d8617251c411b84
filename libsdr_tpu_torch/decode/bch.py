"""BCH(31,21) ECC for POCSAG (reference: src/bch31_21.{hh,cc}).

The code: generator g(x) = x^10+x^9+x^8+x^6+x^5+x^3+1 (octal 03551), dmin=5,
systematic; a POCSAG word is [data:21 | check:10 | even-parity:1], MSB first
(reference: src/bch31_21.cc:7-19).

The reference repairs 1- and 2-bit errors by bit-sliced brute force over 32
transposed copies (src/bch31_21.cc:123-212).  The syndrome is linear over
GF(2), so we instead precompute a table mapping every 1- and 2-bit error
syndrome to its error mask: repair is one table lookup, O(1) per word, with
outputs identical to the brute force (all such syndromes are distinct because
dmin >= 5 — verified exhaustively in tests/test_decode.py).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

BCH_POLY = 0o3551
BCH_N = 31
BCH_K = 21


def _parity32(x: int) -> int:
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return x & 1


def bch_syndrome(word: int) -> int:
    """Syndrome of a 32-bit POCSAG word: polynomial division of word>>1 by
    g(x), plus the even-parity bit at position BCH_N-BCH_K
    (reference: src/bch31_21.cc:32-46)."""
    shreg = (word & 0xFFFFFFFF) >> 1  # throw away parity bit
    mask = 1 << (BCH_N - 1)
    coeff = BCH_POLY << (BCH_K - 1)
    for _ in range(BCH_K):
        if shreg & mask:
            shreg ^= coeff
        mask >>= 1
        coeff >>= 1
    if _parity32(word & 0xFFFFFFFF):
        shreg |= 1 << (BCH_N - BCH_K)
    return shreg


@functools.lru_cache(maxsize=None)
def _error_table() -> Dict[int, int]:
    """syndrome -> error mask for all 1- and 2-bit error patterns over the
    full 32-bit word (the same search space as the reference brute force,
    src/bch31_21.cc:137-181)."""
    table: Dict[int, int] = {}
    singles = [(bch_syndrome(1 << i), 1 << i) for i in range(32)]
    for s, m in singles:
        table.setdefault(s, m)
    for i in range(32):
        si = bch_syndrome(1 << i)
        for j in range(i + 1, 32):
            s = si ^ bch_syndrome(1 << j)
            table.setdefault(s, (1 << i) | (1 << j))
    return table


def bch_repair(word: int) -> Tuple[int, int]:
    """Check and repair up to 2 bit errors.

    Returns:
      (status, word): status 0 = ok/repaired (word fixed), 1 = unrepairable —
      the same contract as the reference's ``pocsag_repair``
      (src/bch31_21.cc:123-212).
    """
    word &= 0xFFFFFFFF
    s = bch_syndrome(word)
    if s == 0:
        return 0, word
    mask = _error_table().get(s)
    if mask is None:
        return 1, word
    return 0, word ^ mask


def bch_encode(data21: int) -> int:
    """Build a valid 32-bit POCSAG word from 21 data bits: append the 10 BCH
    check bits and the even-parity bit (fixture/encoder helper; the reference
    has no encoder)."""
    data21 &= (1 << 21) - 1
    # Polynomial division of data<<10 by g(x) gives the check bits.
    shreg = data21 << 10
    coeff = BCH_POLY << (BCH_K - 1)
    mask = 1 << (BCH_N - 1)
    for _ in range(BCH_K):
        if shreg & mask:
            shreg ^= coeff
        mask >>= 1
        coeff >>= 1
    check = shreg & ((1 << 10) - 1)
    word31 = (data21 << 10) | check
    word = word31 << 1
    if _parity32(word):
        word |= 1
    return word


def bch_repair_array(words: np.ndarray):
    """Vectorized-ish repair of an array of words; returns (status, repaired)."""
    status = np.zeros(len(words), np.int32)
    out = np.zeros(len(words), np.uint32)
    for i, w in enumerate(np.asarray(words, dtype=np.uint64)):
        st, ww = bch_repair(int(w))
        status[i] = st
        out[i] = ww
    return status, out
