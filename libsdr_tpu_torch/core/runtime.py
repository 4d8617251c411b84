"""Host streaming loop (counterpart of ``libsdr_tpu.core.runtime``): feeds
fixed-size blocks from a source iterator through a pipeline's step and hands
each result to a sink.

The card runs ahead of the host: each output is copied to pinned host
memory without blocking, behind an event, and the host reads an output
back (sinks it, collects it) only once more than two are in flight.  With
``chunks_per_dispatch=K`` a group of K blocks is one dispatch, the K steps
replayed from one CUDA graph (``Pipeline.compile_chunked``).
:func:`reblock` and :class:`Throughput` are numpy-only copies of the JAX
package's.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.graph import (Pipeline, _leaves, _rebuild,
                                         resolve_device)
from libsdr_tpu_torch.core.ragged import compact, concat_host

# Outputs in flight before the host reads the oldest back.
IN_FLIGHT = 2


def stream_blocks(samples: np.ndarray, block_size: int,
                  pad_value=0) -> Iterator[np.ndarray]:
    """Yield fixed-size blocks along the trailing axis, zero-padding the
    final partial block."""
    n = samples.shape[-1]
    for start in range(0, n, block_size):
        blk = samples[..., start:start + block_size]
        if blk.shape[-1] < block_size:
            pad = block_size - blk.shape[-1]
            widths = [(0, 0)] * (blk.ndim - 1) + [(0, pad)]
            blk = np.pad(blk, widths, constant_values=pad_value)
        yield blk


class _HostCopy:
    """One output on its way to the host: on the card, its tensors copied
    into pinned memory without blocking, behind an event."""

    def __init__(self, y):
        leaves, self.struct = _leaves(y)
        self.event = None
        if leaves and leaves[0].device.type == "cuda":
            self.leaves = [torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True).copy_(
                                           v, non_blocking=True)
                           for v in leaves]
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.leaves = leaves

    def wait(self):
        """The output, its tensors on the host once the copy is done."""
        if self.event is not None:
            self.event.synchronize()
        return _rebuild(self.struct, iter(self.leaves))


def run_pipeline(pipeline: Pipeline,
                 blocks: Iterable[Any],
                 sink: Optional[Callable[[Any], None]] = None,
                 carry: Any = None,
                 collect: bool = True,
                 device=None,
                 chunks_per_dispatch: int = 1):
    """Drive a bound ``pipeline`` over an iterable of input blocks.

    Args:
      pipeline: a bound Pipeline.
      blocks: input blocks (numpy arrays, tensors or Complex) of
        ``pipeline.in_spec.shape``.
      sink: optional callback receiving each output block as numpy (a host
        :class:`~libsdr_tpu_torch.core.ragged.Ragged` for a ragged stream).
      carry: initial carry; defaults to ``pipeline.init_carry(device)``.
      collect: if True, concatenate and return all outputs along time.
      device: where the blocks are processed (default: the card, see
        ``core.graph.resolve_device``; ``"cpu"`` for the plain versions).
      chunks_per_dispatch: K consecutive blocks in one dispatch through
        ``pipeline.compile_chunked("unroll")`` (on the card one CUDA graph
        replay); a trailing group of fewer than K blocks goes through the
        single step.  Bit-identical to K = 1.

    Returns:
      (carry, outputs): outputs is the concatenated numpy output if
      ``collect``, else None.  A ragged output stream (the bit-sync PLL's)
      is compacted once at the end: a dense vector for one stream, a list of
      per-channel vectors for a bank.
    """
    device = resolve_device(device)
    k = int(chunks_per_dispatch)
    if k < 1:
        raise ValueError(f"run_pipeline: chunks_per_dispatch {k} < 1")
    step = pipeline.compile()
    stepk = pipeline.compile_chunked("unroll") if k > 1 else None
    if carry is None:
        carry = pipeline.init_carry(device)
    ragged = pipeline.out_spec.ragged
    real_dtype = pipeline.in_spec.real_dtype
    outs = []
    pending = []          # outputs in flight, oldest first
    from_graph = False    # whether the carry is a graph's own tensors

    def drain(copies):
        for c in copies:
            y = c.wait()
            y = y.to_numpy() if ragged else cplx.to_numpy(y)
            if sink is not None:
                sink(y)
            if collect:
                outs.append(y)

    def dispatch(group):
        nonlocal carry, from_graph
        if len(group) == k > 1:
            # the graph's outputs live until its next replay, which the
            # stream orders after their copies to the host
            carry, ys = stepk.run(carry, tuple(group), clone=False,
                                  device=device)
            from_graph = True
        else:
            ys = []
            for x in group:
                carry, y = step(carry, cplx.as_block(x, real_dtype, device))
                ys.append(y)
            from_graph = False
        pending.append([_HostCopy(y) for y in ys])
        if len(pending) > IN_FLIGHT:
            drain(pending.pop(0))

    group = []
    for blk in blocks:
        # a group of K host blocks goes to the card once, into the graph
        group.append(cplx.as_block(blk, real_dtype, device if k == 1
                                   else None))
        if len(group) == k:
            dispatch(group)
            group = []
    if group:                      # trailing partial group
        dispatch(group)
    for copies in pending:
        drain(copies)
    if from_graph:
        carry = _rebuild(_leaves(carry)[1],
                         iter([v.clone() for v in _leaves(carry)[0]]))
    if not (collect and outs):
        return carry, None
    if ragged:
        return carry, compact(concat_host(outs))
    return carry, np.concatenate(outs, axis=-1)


def reblock(blocks: Iterable[np.ndarray], out_size: int
            ) -> Iterator[np.ndarray]:
    """Host-side re-blocker (a copy of ``libsdr_tpu.core.runtime.reblock``):
    accumulate arbitrary-size blocks and emit fixed-size ones, for stages
    whose block size is part of the transform (an FFT).  The trailing
    remainder is dropped."""
    buf = None
    for blk in blocks:
        blk = np.asarray(blk)
        buf = blk if buf is None else np.concatenate([buf, blk], axis=-1)
        while buf.shape[-1] >= out_size:
            yield buf[..., :out_size]
            buf = buf[..., out_size:]


class Throughput:
    """Throughput and drop meter for the streaming loop (a copy of
    ``libsdr_tpu.core.runtime.Throughput``).

    ``add`` counts samples processed; ``add_dropped`` counts samples a live
    source discarded because the pipeline fell behind the wire.  A healthy
    live deployment shows ``drop_fraction == 0`` with ``msps`` at or above
    the wire rate."""

    def __init__(self) -> None:
        self.samples = 0
        self.dropped = 0
        self.t0 = time.perf_counter()

    def add(self, n: int) -> None:
        self.samples += n

    def add_dropped(self, n: int) -> None:
        self.dropped += n

    def update_from(self, stats, bytes_per_sample: int = 2) -> None:
        """Absorb a live source's statistics: any object with a total
        ``bytes_dropped``.  ``bytes_per_sample``: wire bytes a sample (2
        for u8 IQ, 4 for s16 IQ, 2 for s16 mono audio)."""
        self.dropped = stats.bytes_dropped // bytes_per_sample

    @property
    def msps(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.samples / dt / 1e6 if dt > 0 else float("inf")

    @property
    def drop_fraction(self) -> float:
        total = self.samples + self.dropped
        return self.dropped / total if total else 0.0

    def report(self) -> str:
        sustained = self.samples / max(
            time.perf_counter() - self.t0, 1e-9) / 1e6
        return (f"{sustained:.2f} Msps sustained, "
                f"{self.dropped} samples dropped "
                f"({100 * self.drop_fraction:.2f}%)")
