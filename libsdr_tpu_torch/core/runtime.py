"""Host streaming loop (counterpart of ``libsdr_tpu.core.runtime``): feeds
fixed-size blocks from a source iterator through a pipeline's step and hands
each result to a sink."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.graph import Pipeline, resolve_device
from libsdr_tpu_torch.core.ragged import compact, concat_host


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


def run_pipeline(pipeline: Pipeline,
                 blocks: Iterable[Any],
                 sink: Optional[Callable[[Any], None]] = None,
                 carry: Any = None,
                 collect: bool = True,
                 device=None):
    """Drive a bound ``pipeline`` over an iterable of input blocks, one step
    per block (the JAX package's ``chunks_per_dispatch=1``).

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

    Returns:
      (carry, outputs): outputs is the concatenated numpy output if
      ``collect``, else None.  A ragged output stream (the bit-sync PLL's)
      is compacted once at the end: a dense vector for one stream, a list of
      per-channel vectors for a bank.
    """
    device = resolve_device(device)
    step = pipeline.compile()
    if carry is None:
        carry = pipeline.init_carry(device)
    ragged = pipeline.out_spec.ragged
    real_dtype = pipeline.in_spec.real_dtype
    outs = []
    for blk in blocks:
        carry, y = step(carry, cplx.as_block(blk, real_dtype, device))
        y = y.to_numpy() if ragged else cplx.to_numpy(y)
        if sink is not None:
            sink(y)
        if collect:
            outs.append(y)
    if not (collect and outs):
        return carry, None
    if ragged:
        return carry, compact(concat_host(outs))
    return carry, np.concatenate(outs, axis=-1)
