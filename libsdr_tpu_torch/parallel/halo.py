"""Collectives of the sharded paths on ``torch.distributed`` (counterpart of
``libsdr_tpu.parallel.halo``).

The JAX package runs one SPMD program over a mesh and moves halos with
``ppermute`` inside ``shard_map``.  Here each rank is one process that runs
the same body on its own shard, and an axis of a
``torch.distributed.device_mesh.DeviceMesh`` is an :class:`Axis`: its
process group, its size and this rank's index on it.  The collectives map:

  ===========================  ==========================================
  JAX                          here
  ===========================  ==========================================
  ``ppermute`` right           :func:`pass_right`: ``batch_isend_irecv``
  ``all_gather(...)[n - 1]``   :func:`last_shard_tail`: ``broadcast``
  ``all_to_all(tiled=True)``   :func:`all_to_all`: ``all_to_all_single``
  ``all_gather`` (GSPMD)       :func:`all_gather`
  ===========================  ==========================================

Each helper takes a tensor or a nest of tensors (planar ``Complex``,
tuples) of one dtype and moves it in one collective, the planes packed
together.  On an axis of one rank every helper is the identity, and the
build functions skip them statically.  The overlap-save FIR's carried tail
becomes a halo: shard i needs the last ``T-1`` samples of shard i-1
(:func:`fir_overlap_save_sharded`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from libsdr_tpu_torch.core.graph import _leaves, _rebuild
from libsdr_tpu_torch.core.stream import ConfigError


class Axis(NamedTuple):
    """One axis of a mesh as this rank sees it: the axis's process group
    (None for one rank), its size and this rank's index on it."""

    group: Optional[object]
    size: int
    index: int

    def rank(self, i: int) -> int:
        """The global rank of the axis's member ``i``."""
        return dist.get_global_rank(self.group, i)


ONE = Axis(None, 1, 0)


def mesh_axis(mesh, axis: str) -> Axis:
    """The :class:`Axis` named ``axis`` of ``mesh`` (a ``DeviceMesh``), or
    a one-rank axis for ``mesh=None``."""
    if mesh is None:
        return ONE
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ConfigError(f"mesh axes {names} have no axis {axis!r}")
    return Axis(mesh.get_group(axis), mesh.size(names.index(axis)),
                mesh.get_local_rank(axis))


def _pack(tree):
    """The leaves of ``tree`` as one flat tensor, and the function that
    rebuilds a tree of the same structure from such a tensor."""
    leaves, struct = _leaves(tree)
    dtypes = {v.dtype for v in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"one collective moves one dtype, got {dtypes}")
    shapes = [v.shape for v in leaves]
    flat = torch.cat([v.reshape(-1) for v in leaves])

    def unpack(t: torch.Tensor):
        parts, off = [], 0
        for s in shapes:
            k = s.numel()
            parts.append(t[off:off + k].reshape(s))
            off += k
        return _rebuild(struct, iter(parts))

    return flat, unpack


def pass_right(x, ax: Axis):
    """Each shard's value to its right neighbour (shard i -> i+1); shard 0
    receives zeros.  This is the overlap-save halo move."""
    if ax.size == 1:
        return x
    flat, unpack = _pack(x)
    out = torch.zeros_like(flat)
    ops = []
    if ax.index + 1 < ax.size:
        ops.append(dist.P2POp(dist.isend, flat, ax.rank(ax.index + 1),
                              ax.group))
    if ax.index > 0:
        ops.append(dist.P2POp(dist.irecv, out, ax.rank(ax.index - 1),
                              ax.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return unpack(out)


def last_shard_tail(x, ax: Axis):
    """The last shard's value on every shard (the global stream's tail,
    carried into the next block step)."""
    if ax.size == 1:
        return x
    flat, unpack = _pack(x)
    flat = flat.clone()
    dist.broadcast(flat, src=ax.rank(ax.size - 1), group=ax.group)
    return unpack(flat)


def all_gather(x, ax: Axis, dim: int = -1):
    """Every shard's value, concatenated along ``dim`` in rank order."""
    if ax.size == 1:
        return x
    flat, unpack = _pack(x)
    parts = [torch.empty_like(flat) for _ in range(ax.size)]
    dist.all_gather(parts, flat, group=ax.group)
    trees = [_leaves(unpack(p))[0] for p in parts]
    _, struct = _leaves(x)
    return _rebuild(struct, iter(torch.cat(cols, dim=dim)
                                 for cols in zip(*trees)))


def all_to_all(x, ax: Axis, split_axis: int, concat_axis: int):
    """JAX's ``all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    each shard splits ``x`` into ``size`` chunks along ``split_axis``, sends
    chunk j to shard j and concatenates the chunks it receives along
    ``concat_axis`` in rank order.  The planes of a nest ride one
    ``all_to_all_single`` (which splits its dim 0: the chunks are stacked
    there first)."""
    if ax.size == 1:
        return x
    leaves, struct = _leaves(x)
    if len({v.dtype for v in leaves}) != 1:
        raise ValueError("all_to_all moves one dtype")
    planes = torch.stack(leaves)                     # (k, ...)
    ndim = planes.ndim - 1
    s, c = split_axis % ndim + 1, concat_axis % ndim + 1
    if planes.shape[s] % ax.size:
        raise ValueError(f"dim {split_axis} of {tuple(leaves[0].shape)} "
                         f"does not split over {ax.size} shards")
    send = torch.stack(planes.chunk(ax.size, dim=s))  # (n, k, ...)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    out = torch.cat(recv.unbind(0), dim=c)
    return _rebuild(struct, iter(out.unbind(0)))


def fir_overlap_save_sharded(taps, x_local, tail_global, ax: Axis,
                             stride: int = 1, offset: int = 0):
    """Time-sharded :func:`libsdr_tpu_torch.ops.fir.fir_overlap_save`.

    Each shard holds ``x_local`` (..., B/n) of a global block; the T-1
    sample halo comes from the left neighbour (:func:`pass_right`), shard 0
    takes ``tail_global`` (the carry from the previous global block).  A
    shard's segment must hold at least T-1 samples, and with a stride its
    length must keep the global output grid (a multiple of ``stride``).
    Returns (y_local, new_tail_global)."""
    from libsdr_tpu_torch.ops.fir import _n_taps, fir_overlap_save

    t = _n_taps(taps)
    b = x_local.shape[-1]
    if t - 1 > b:
        raise ConfigError(f"a shard of {b} samples is shorter than the "
                          f"{t - 1}-sample halo")
    if b % stride:
        raise ConfigError(f"a shard of {b} samples breaks the stride "
                          f"{stride} output grid")
    tail_local = x_local[..., b - (t - 1):]
    if not isinstance(tail_local, torch.Tensor):
        tail_local = tail_local.map(torch.clone)
    else:
        tail_local = tail_local.clone()
    halo = pass_right(tail_local, ax)
    prev = tail_global if ax.index == 0 else halo
    y, _ = fir_overlap_save(taps, x_local, prev, stride=stride,
                            offset=offset)
    return y, last_shard_tail(tail_local, ax)
