"""The traffic generators.  A traffic file names its ``signal``; the
generator is ``benchmark/signals/<signal>.py``, found by that name, whose
``make(config, traffic, seed, device)`` returns the blocks, made from the
run's seed on the device they will be read on, and a plan of what they
carry (or None).  A block is a pair ``(re, im)`` of float32 planes of
shape (C, B), or (B,) for a single wideband stream.  Nothing here imports
the program.
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark import manifest


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` from any whole-number seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def make(config: dict, traffic: dict, seed: int, device,
         root: Path = manifest.ROOT):
    """The traffic's blocks (and its plan, or None) for ``seed``, by the
    generator that ``traffic["signal"]`` names under ``root``."""
    path = Path(root) / "benchmark" / "signals" / f"{traffic['signal']}.py"
    return manifest.load_module(path).make(config, traffic, seed, device)
