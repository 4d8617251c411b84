"""Checkpoint / resume of streaming state (counterpart of
``libsdr_tpu.core.checkpoint``).

All state is the explicit carry, so resuming at block N is (carry,
position) serialization: a pipeline restarted from a checkpoint continues
bit-identically.  The file is the JAX package's: an npz with a JSON
``__header__`` and the carry's leaves as ``leaf_0``, ``leaf_1``, ... in
flatten order (dict keys sorted, Complex as re then im), so a checkpoint
that the JAX package writes for a carry whose leaves line up loads here.
"""

from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.graph import _leaves, _rebuild, resolve_device


def _storable(leaf) -> np.ndarray:
    """A leaf as a numpy array npz can hold: bfloat16 widened to float32
    (lossless; :func:`load_checkpoint` casts back to the live dtype)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, carry: Any, position: int,
                    meta: dict | None = None) -> None:
    """Serialize a carry and the stream position to ``path`` (.npz)."""
    leaves, struct = _leaves(carry)
    arrays = {f"leaf_{i}": _storable(v) for i, v in enumerate(leaves)}
    header = json.dumps({
        "position": int(position),
        "n_leaves": len(leaves),
        "treedef": repr(struct),
        "meta": meta or {},
    })
    np.savez(path, __header__=np.frombuffer(header.encode(), np.uint8),
             **arrays)


def load_checkpoint(path: str, carry_like: Any) -> Tuple[Any, int, dict]:
    """Restore (carry, position, meta).  ``carry_like`` (e.g.
    ``pipeline.init_carry(device)``) gives the structure; each leaf comes
    back in the live leaf's dtype, on its device."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        saved = [z[f"leaf_{i}"] for i in range(header["n_leaves"])]
    like, struct = _leaves(carry_like)
    if len(like) != len(saved):
        raise ValueError(
            f"checkpoint has {len(saved)} leaves, pipeline carry has "
            f"{len(like)}: pipeline structure changed?")
    restored = []
    for s, v in zip(saved, like):
        if isinstance(v, torch.Tensor):
            if tuple(s.shape) != tuple(v.shape):
                raise ValueError(f"checkpoint leaf of shape {s.shape}, "
                                 f"pipeline carry's {tuple(v.shape)}")
            restored.append(torch.as_tensor(np.array(s)).to(v.device,
                                                             v.dtype))
        else:
            restored.append(s)
    return _rebuild(struct, iter(restored)), header["position"], \
        header["meta"]


def run_resumable(pipeline, blocks, checkpoint_path: str,
                  checkpoint_every: int = 64, sink=None, device=None):
    """Drive a bound pipeline with periodic checkpoints, resuming from
    ``checkpoint_path`` when it exists; returns the final (carry,
    position).  Runs on ``device``: by default the card, as
    ``pipeline.init_carry()`` (``device="cpu"`` for the plain versions).

    ``blocks`` is a callable ``blocks(start_block) -> iterator`` so a
    resume can skip ahead.
    """
    device = resolve_device(device)
    carry = pipeline.init_carry(device)
    start = 0
    if os.path.exists(checkpoint_path):
        carry, start, _ = load_checkpoint(checkpoint_path, carry)
    step = pipeline.compile()
    real_dtype = pipeline.in_spec.real_dtype
    pos = start
    for blk in blocks(start):
        carry, y = step(carry, cplx.as_block(blk, real_dtype, device))
        if sink is not None:
            sink(cplx.to_numpy(y))
        pos += 1
        if pos % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, carry, pos)
    save_checkpoint(checkpoint_path, carry, pos)
    return carry, pos
