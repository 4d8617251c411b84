"""A bound Pipeline's step over a ('ch', 'time') mesh of ranks
(counterpart of ``libsdr_tpu.parallel.mesh``).

Every rank holds local tensors and keeps its kernels: where the JAX
package's GSPMD path must turn its Pallas kernels off (a ``pallas_call``
has no SPMD partitioning rule), a rank here launches them on its own
shard.  :func:`shard_pipeline_step` gives GSPMD's semantics, channels on
'ch' and the time block on 'time'; :func:`shard_map_pipeline_step` shards
channels only and needs no collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from libsdr_tpu_torch.core.graph import Pipeline, _leaves, _rebuild
from libsdr_tpu_torch.core.stream import ConfigError
from libsdr_tpu_torch.parallel.distributed import place_global, rank_device
from libsdr_tpu_torch.parallel.halo import ONE, all_gather, mesh_axis


def make_mesh(n_channel: int = 0, n_time: int = 1,
              device_type: str = "cuda"):
    """A ('ch', 'time') ``DeviceMesh`` over the group's ranks;
    ``n_channel=0`` puts the rest of the ranks on 'ch'.  Without a process
    group (one process) the one-rank mesh is None, which every build function
    takes for the one-device program."""
    if not dist.is_initialized():
        if max(n_channel, 1) * n_time != 1:
            raise ConfigError(f"a {n_channel} x {n_time} mesh needs a "
                              "process group (parallel.distributed."
                              "init_multihost)")
        return None
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_channel <= 0:
        n_channel = world // n_time
    if n_channel * n_time != world:
        raise ConfigError(f"a {n_channel} x {n_time} mesh does not cover "
                          f"the {world} ranks")
    return init_device_mesh(device_type, (n_channel, n_time),
                            mesh_dim_names=("ch", "time"))


def _carry_spec(leaf, n_channels: int, axis: str) -> tuple:
    """THE carry placement rule, shared by both build functions: a leaf whose
    leading dim is the channel count is sharded on ``axis``; every other
    leaf (scalars, NCO phasors, small tails) is replicated."""
    if isinstance(leaf, torch.Tensor) and leaf.ndim >= 1 and \
            leaf.shape[0] == n_channels:
        return (axis,) + (None,) * (leaf.ndim - 1)
    return ()


def _shard_carry(carry, mesh, n_channels: int, axis: str, dev):
    leaves, struct = _leaves(carry)
    return _rebuild(struct, iter(
        place_global(v, mesh, _carry_spec(v, n_channels, axis), v.dtype,
                     dev).clone()
        if isinstance(v, torch.Tensor) else v for v in leaves))


def shard_pipeline_step(pipeline: Pipeline, mesh, shard_time: bool = True,
                        device=None):
    """A bound pipeline's step over ``mesh`` with GSPMD's semantics:
    channels sharded on 'ch' and, with ``shard_time``, the block's time on
    'time'.  Returns (step, place_input, carry): ``place_input`` gives this
    rank its shard of a global block, ``carry`` is this rank's initial
    carry (channel leaves sharded by :func:`_carry_spec`).

    JAX leaves the time axis to GSPMD, which has no PyTorch counterpart.
    Here the block's time shards are all-gathered within the 'time' group,
    the rank's channels run the step on the whole block, and each rank
    keeps its time slice of the output: the single-device result, for
    correctness and not speed.  The fast time-sharded forms are the
    explicit build functions (``parallel/wideband.py``, ``parallel/multimode.py``),
    which pass halos.  The step is the pipeline's own on the rank's
    channels, so its stages must map channels independently.  An output
    whose length does not split over 'time' is refused (GSPMD pads)."""
    in_spec = pipeline.in_spec
    if not in_spec.channels:
        raise ConfigError("shard_pipeline_step needs a channel dim")
    n_ch = in_spec.channels[0]
    dev = rank_device(mesh, device)
    ch = mesh_axis(mesh, "ch")
    tm = mesh_axis(mesh, "time") if shard_time else ONE
    if n_ch % ch.size:
        raise ConfigError(f"{n_ch} channels do not split over {ch.size} "
                          "ranks of 'ch'")
    out_len = pipeline.out_spec.block_size
    if in_spec.block_size % tm.size or out_len % tm.size:
        raise ConfigError(
            f"a block of {in_spec.block_size} samples ({out_len} out) does "
            f"not split over {tm.size} ranks of 'time'")
    spec = ("ch",) + (None,) * (len(in_spec.channels) - 1) + \
        ("time" if shard_time else None,)
    dtype = in_spec.real_dtype
    out_t = out_len // tm.size
    keep = slice(tm.index * out_t, (tm.index + 1) * out_t)

    def place_input(block):
        return place_global(block, mesh, spec, dtype, dev)

    carry = _shard_carry(pipeline.init_carry(dev), mesh, n_ch, "ch", dev)

    def step(carry, x):
        carry, y = pipeline.apply(carry, all_gather(x, tm, dim=-1))
        if tm.size > 1:
            leaves, struct = _leaves(y)
            y = _rebuild(struct, iter(v[..., keep] for v in leaves))
        return carry, y

    return step, place_input, carry


def shard_map_pipeline_step(pipeline: Pipeline, mesh, axis: str = "ch",
                            device=None):
    """Channels sharded on ``axis``, no collective: each rank runs the
    pipeline's step, with its kernels, on its own channel group.  Valid for
    channelwise pipelines (every stage maps channels independently: the
    demod-bank chains; not Channelizer/Combine, whose cross-channel data
    flow needs the explicit build functions of ``parallel/wideband.py``).  The
    pipeline stays bound to the global channel count.  Returns (step,
    place_input, carry) like :func:`shard_pipeline_step`."""
    in_spec = pipeline.in_spec
    if not in_spec.channels:
        raise ConfigError("shard_map_pipeline_step needs a channel dim")
    n_ch = in_spec.channels[0]
    ax = mesh_axis(mesh, axis)
    if n_ch % ax.size:
        raise ValueError(f"channels {n_ch} must divide the mesh axis "
                         f"{axis!r} size {ax.size}")
    dev = rank_device(mesh, device)
    spec = (axis,) + (None,) * len(in_spec.channels)
    dtype = in_spec.real_dtype

    def place_input(block):
        return place_global(block, mesh, spec, dtype, dev)

    carry = _shard_carry(pipeline.init_carry(dev), mesh, n_ch, axis, dev)
    return pipeline.apply, place_input, carry
