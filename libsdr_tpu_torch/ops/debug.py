"""Debug sinks (copied from ``libsdr_tpu.ops.debug``, which is numpy-only;
importing it would load JAX; reference: src/utils.hh:796-901 TextDump/
DebugDump/DebugStore, src/fsk.hh:176-189 BitDump).

These are host-side consumers used with :func:`run_pipeline`'s ``sink``
callback; DebugStore is also the capture sink of the reference's testing
idiom (test/coreutilstest.cc)."""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np


class DebugStore:
    """Keep the received blocks (reference: src/utils.hh:799-841)."""

    def __init__(self, keep_all: bool = True):
        self.keep_all = keep_all
        self.blocks: List[np.ndarray] = []
        self.last: Optional[np.ndarray] = None

    def __call__(self, block: np.ndarray) -> None:
        self.last = block
        if self.keep_all:
            self.blocks.append(block)

    def concatenated(self) -> np.ndarray:
        return np.concatenate(self.blocks, axis=-1)


class TextDump:
    """Print samples as text (reference: src/utils.hh TextDump)."""

    def __init__(self, stream=None, fmt: str = "{:.6g}"):
        self.stream = stream or sys.stdout
        self.fmt = fmt

    def __call__(self, block: np.ndarray) -> None:
        flat = np.asarray(block).reshape(-1)
        self.stream.write(" ".join(self.fmt.format(v) for v in flat) + "\n")


class BitDump:
    """Print a bit stream (reference: src/fsk.hh:176-189); accepts ragged
    blocks (data, valid) or dense bit arrays."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def __call__(self, block) -> None:
        if hasattr(block, "valid"):  # Ragged (numpy arrays have .data too)
            data = np.asarray(block.data)[np.asarray(block.valid, bool)]
        else:
            data = np.asarray(block).reshape(-1)
        self.stream.write(" ".join(str(int(b)) for b in data) + "\n")
