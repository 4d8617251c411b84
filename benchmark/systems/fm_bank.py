"""The FM broadcast bank on the card: ``IQBaseBand -> FMDemod -> FMDeemph``
on every channel, which the program's fusion pass makes one op
(``ops/fm_fused.FMBasebandFused``, the FIR and discriminator kernel), fed
from blocks held on the card and replayed in turn, the carry running on.

One block a dispatch goes through ``Pipeline.compile()``; K blocks a
dispatch through ``Pipeline.compile_chunked("unroll")``, one CUDA graph
replay reading the blocks where they lie (its own outputs, not cloned).
The audio stays on the card.  The outputs of the last two dispatches are
judged against ``reference/fm_bank.py`` after the window.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from benchmark.reference import fm_bank as reference

PLANES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class System:
    """The program's FM bank over ``made``, the traffic's (blocks, None)."""

    def __init__(self, config: dict, traffic: dict, made, seed: int, device,
                 planes: str = None):
        import libsdr_tpu_torch as L
        from libsdr_tpu_torch.core.cplx import Complex
        from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand

        self.config = config
        self.blocks, _ = made
        dtype = PLANES[planes or config["planes"]]
        self.inputs = [Complex(re.to(dtype), im.to(dtype))
                       for re, im in self.blocks]
        ch = config["chain"]
        c, b = int(config["channels"]), int(traffic["block_samples"])
        self.pipeline = L.Pipeline([
            IQBaseBand(fc=ch["fc"], width=ch["width"], order=ch["order"],
                       decim=ch["decim"], design=ch["design"]),
            FMDemod(gain=ch["gain"]), FMDeemph(tau=ch["tau"])])
        self.pipeline.bind(L.StreamSpec(np.complex64, config["sample_rate"],
                                        b, channels=(c,), plane_dtype=dtype))
        self.carry = self.pipeline.init_carry(device)
        self.k = int(traffic["blocks_per_dispatch"])
        self.blocks_per_dispatch = self.k
        self.samples_per_block = c * b
        n = len(self.inputs)
        if n % self.k:
            raise ValueError("distinct_blocks must be whole dispatches")
        self.step = self.pipeline.compile() if self.k == 1 else None
        self.chunked = (self.pipeline.compile_chunked("unroll")
                        if self.k > 1 else None)
        # a graph's outputs last until its next replay: two dispatches stay
        # readable where they replay two graphs (two sets of addresses)
        kept = 2 if self.k == 1 or n // self.k >= 2 else 1
        self.outs = collections.deque(maxlen=kept)
        self.min_dispatches = kept + 1

    def _indices(self, i: int) -> list:
        n = len(self.inputs)
        return [(i * self.k + j) % n for j in range(self.k)]

    def dispatch(self, i: int) -> None:
        idx = self._indices(i)
        if self.chunked is None:
            self.carry, y = self.step(self.carry, self.inputs[idx[0]])
            ys = (y,)
        else:
            self.carry, ys = self.chunked.run(
                self.carry, tuple(self.inputs[j] for j in idx), clone=False)
        self.outs.append((idx, ys))

    def warm(self) -> None:
        """Every dispatch of one period: builds the kernels, captures each
        graph; the window then starts the period again."""
        for i in range(len(self.inputs) // self.k):
            self.dispatch(i)
        self.outs.clear()

    def launches(self) -> int:
        from libsdr_tpu_torch.core.graph import kernel_entries
        n = sum(e.launches for e in kernel_entries())
        if self.chunked is not None:
            n += sum(self.chunked.graph_launches().values())
        return n

    def judge(self) -> dict:
        order = [j for idx, _ in self.outs for j in idx]
        # a graph's outputs go with its memory pool
        outputs = [y if self.chunked is None else y.clone()
                   for _, ys in self.outs for y in ys]
        lead = (order[0] - 1) % len(self.inputs)
        del self.outs, self.carry, self.step, self.chunked, self.pipeline
        del self.inputs
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        worst, rms = reference.compare(self.config, self.blocks,
                                       [lead] + order, outputs)
        lim = self.config["limits"]
        return {"audio_err": (worst, lim["audio_err"]),
                "audio_rms": (rms, lim["audio_rms"])}
