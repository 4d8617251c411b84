"""Tiny versions of the benchmark's cells for the CPU tests, and the card
fixture of the tests marked ``cuda``."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness, manifest  # noqa: E402


def tiny_cell(name: str):
    """``name`` at a size a CPU test holds: the FM bank on 4 lanes, the
    pager band on 16 channels of the configuration's raster (two pages);
    every width, rate and traffic rule otherwise as committed."""
    cell = manifest.cell(name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if cfg["system"] == "fm_bank":
        cfg["channels"] = 4
        k = min(2, tr["blocks_per_dispatch"])
        tr.update(block_samples=1 << (14 if k == 1 else 12),
                  distinct_blocks=2 * k, blocks_per_dispatch=k)
    else:
        raster = cfg["sample_rate"] / cfg["channels"]
        cfg.update(channels=16, sample_rate=16 * raster)
        tr.update(block_samples=1 << 18, page_every=8, edge_pages=False)
    cell.config, cell.traffic = cfg, tr
    return cell


def run_tiny(name: str, seed: int = 20, trace: bool = False, **kw) -> dict:
    return harness.run_cell(tiny_cell(name), seed, 0.05, trace, "cpu",
                            time.perf_counter(), **kw)


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")
