"""Multi-process runs on ``torch.distributed`` (counterpart of
``libsdr_tpu.parallel.distributed``).

One process a device: a rank runs the sharded build functions' body on its own
shard and holds only local tensors.  :func:`init_multihost` joins the
process group (NCCL for the cards, gloo for ``device="cpu"``),
:func:`global_mesh` lays the ranks out as a ``DeviceMesh``,
:func:`place_global` and :func:`place_global_ingest` give a rank its shard
of a global array (the second asks the caller's ``fetch`` only for this
rank's index: host-sharded ingest), the sharded checkpoints write and read
each rank's own shards, and :func:`run_supervised` relaunches a job whose
process was lost.  A single process needs none of it: without a process
group the build functions run the one-device program on ``device``.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.graph import _leaves, _rebuild, resolve_device
from libsdr_tpu_torch.core.stream import ConfigError


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device=None,
                   timeout: float = 300.0) -> torch.device:
    """Join the process group and return this rank's device; a no-op for
    one process (the device alone).

    ``coordinator`` is the group's ``init_method`` (``tcp://host:port``,
    ``file:///path``), by default ``SDR_INIT_METHOD`` from the environment
    (a ``file://`` store on a shared file system, where no port is wanted)
    or else ``env://``: the variables ``torchrun`` sets.  These also give
    ``num_processes`` (``WORLD_SIZE``) and ``process_id`` (``RANK``).  ``device`` is the card by default (rank r
    on ``cuda:LOCAL_RANK``, else ``cuda:r % device_count``) or ``"cpu"``;
    the backend follows it: NCCL on the cards, gloo on the CPU.  A
    collective whose peer died raises after ``timeout`` seconds instead of
    waiting for ever."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    dev = resolve_device(device)
    if num_processes <= 1:
        return dev
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None else
                           process_id % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=(coordinator or os.environ.get("SDR_INIT_METHOD")
                         or "env://"),
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout))
    if dist.get_world_size() != num_processes:
        raise ConfigError(f"the process group has {dist.get_world_size()} "
                          f"ranks, not {num_processes}")
    return dev


def shutdown_multihost() -> None:
    """Leave the process group (every rank calls it): a barrier, so that no
    rank tears the group down under a peer, then its destruction."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def global_mesh(axis_names: Sequence[str] = ("ch", "time"),
                time_parallel: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` over every rank of the group, or None without a
    process group (one process: the build functions' one-device program).  Two
    axis names give (channels, time) with ``time_parallel`` ranks on time;
    one name a 1-D mesh."""
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    t = max(1, int(time_parallel))
    if len(axis_names) == 1:
        if t != 1:
            raise ConfigError("a 1-D mesh has no time axis")
        shape = (n,)
    elif n % t:
        raise ConfigError(f"global_mesh: time_parallel={t} does not divide "
                          f"the {n} ranks")
    else:
        shape = (n // t, t)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def rank_device(mesh, device=None) -> torch.device:
    """The device of this rank: ``device`` (the card by default) without a
    mesh; with one, the mesh's device on this rank, and a ``device`` that
    names another raises.  A list of devices is refused: the sharded paths
    take a mesh."""
    if isinstance(device, (list, tuple)):
        raise ConfigError(
            f"{len(device)} devices: pass a mesh for the sharded paths "
            "(parallel.distributed.global_mesh, parallel.mesh.make_mesh) "
            "or one device")
    if mesh is None:
        return resolve_device(device)
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or (want.index is not None
                                     and want.index != dev.index):
            raise ConfigError(f"device {want} disagrees with this rank's "
                              f"device {dev} on the mesh")
    return dev


def shard_index(global_shape, mesh, spec) -> tuple:
    """This rank's index (a tuple of slices) into an array of
    ``global_shape`` sharded by ``spec``: one mesh axis name (or None,
    replicated) a leading dimension, as JAX's ``PartitionSpec``."""
    idx = []
    for d, size in enumerate(global_shape):
        name = spec[d] if d < len(spec) else None
        if name is None or mesh is None:
            idx.append(slice(0, size))
            continue
        names = mesh.mesh_dim_names
        n = mesh.size(names.index(name))
        if size % n:
            raise ConfigError(f"dim {d} of size {size} does not shard over "
                              f"{n} ranks of {name!r}")
        i, per = mesh.get_local_rank(name), size // n
        idx.append(slice(i * per, (i + 1) * per))
    return tuple(idx)


def _on_device(x, dtype, dev):
    """A shard (numpy, tensor or Complex) as a tensor or Complex on
    ``dev``; complex and planar data in ``dtype`` planes."""
    if isinstance(x, (Complex, torch.Tensor)):
        if isinstance(x, Complex) or x.is_floating_point():
            return x.to(dev, dtype)
        return x.to(dev)
    x = np.asarray(x)
    if np.iscomplexobj(x) or np.issubdtype(x.dtype, np.floating):
        return cplx.as_block(x, dtype, dev)
    return torch.as_tensor(x, device=dev)


def place_global(x, mesh, spec, dtype=torch.float32, device=None):
    """This rank's shard of the global array ``x`` (numpy, tensor or
    planar Complex, the whole array on every rank) by ``spec``, on the
    rank's device; complex data become ``dtype`` planes.  Without a mesh,
    the whole array on ``device``."""
    dev = rank_device(mesh, device)
    shape = tuple(x.shape)
    idx = shard_index(shape, mesh, spec)
    if isinstance(x, Complex):
        return _on_device(x.map(lambda a: a[idx]), dtype, dev)
    return _on_device(x[idx], dtype, dev)


def place_global_ingest(global_shape, mesh, spec, fetch,
                        dtype=torch.float32, device=None):
    """Host-sharded ingest: this rank's shard of an array of
    ``global_shape``, read by ``fetch(index)`` with the GLOBAL index (a
    tuple of slices) of this rank's shard only, so that no rank needs the
    whole stream.  ``fetch`` returns numpy, a tensor or a Complex."""
    dev = rank_device(mesh, device)
    return _on_device(fetch(shard_index(tuple(global_shape), mesh, spec)),
                      dtype, dev)


def _rank_and_world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_sharded_checkpoint(path: str, carry, position: int) -> None:
    """Checkpoint of this rank's carry: its own shards only (every leaf is
    a local tensor), so no rank gathers another's state.  Write one file a
    rank.  The leaves go through ``core/checkpoint.py::_storable``."""
    from libsdr_tpu_torch.core.checkpoint import _storable

    leaves, _ = _leaves(carry)
    rank, world = _rank_and_world()
    header = json.dumps({"position": int(position), "n_leaves": len(leaves),
                         "rank": rank, "world": world})
    np.savez(path, __header__=np.frombuffer(header.encode(), np.uint8),
             **{f"leaf{i}": _storable(v) for i, v in enumerate(leaves)})


def load_sharded_checkpoint(path: str, carry_like):
    """Restore (carry, position) from :func:`save_sharded_checkpoint`: each
    rank reads its own file, every leaf in the dtype and on the device of
    ``carry_like``'s.  A file that another rank or another group size
    wrote raises."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        saved = [z[f"leaf{i}"] for i in range(header["n_leaves"])]
    rank, world = _rank_and_world()
    if (header["rank"], header["world"]) != (rank, world):
        raise ConfigError(f"{path} holds rank {header['rank']} of "
                          f"{header['world']}, this is rank {rank} of "
                          f"{world}")
    like, struct = _leaves(carry_like)
    if len(like) != len(saved):
        raise ConfigError(f"{path} has {len(saved)} leaves, the carry "
                          f"{len(like)}")
    out = []
    for s, v in zip(saved, like):
        if tuple(s.shape) != tuple(v.shape):
            raise ConfigError(f"a leaf of shape {s.shape} for the carry's "
                              f"{tuple(v.shape)}")
        out.append(torch.as_tensor(np.array(s)).to(v.device, v.dtype))
    return _rebuild(struct, iter(out)), header["position"]


def run_supervised(make_cmd, num_processes: int, max_restarts: int = 2,
                   poll_s: float = 0.25, timeout_s: float = 600.0,
                   popen_kwargs: Optional[dict] = None,
                   store_dir: Optional[str] = None) -> int:
    """Lost-host detection and restart of a multi-process job.

    Launches the N processes and watches them; when ANY exits abnormally
    (a crash, an OOM kill, a lost host) or the job outlasts ``timeout_s``,
    the survivors are killed (their collectives would wait on the dead
    peer) and the whole job is relaunched.  The workers resume from their
    own checkpoints (:func:`save_sharded_checkpoint`), so finished stream
    positions are not recomputed.

    Args:
      make_cmd: ``(coordinator, process_id, incarnation) -> argv`` of one
        worker; ``coordinator`` is the group's ``init_method``, a new
        ``file://`` store an incarnation (no port to collide with).
      num_processes: the group's size.
      max_restarts: relaunches before giving up.
      store_dir: the directory of the stores, shared by every worker's
        host; by default a temporary one, removed at the end.
    Returns the number of restarts.  Raises RuntimeError when the budget
    is spent.
    """
    import shutil
    import subprocess
    import tempfile
    import time

    own = store_dir is None
    root = tempfile.mkdtemp(prefix="sdr_store") if own else store_dir
    restarts = 0
    try:
        while True:
            coordinator = "file://" + os.path.join(os.path.abspath(root),
                                                   f"store{restarts}")
            procs = [subprocess.Popen(make_cmd(coordinator, i, restarts),
                                      **(popen_kwargs or {}))
                     for i in range(num_processes)]
            t0 = time.monotonic()
            try:
                while True:
                    codes = [p.poll() for p in procs]
                    if all(c == 0 for c in codes):
                        return restarts
                    if any(c not in (None, 0) for c in codes):
                        break    # a lost host
                    if time.monotonic() - t0 > timeout_s:
                        break
                    time.sleep(poll_s)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"run_supervised: job failed {restarts} times "
                    f"(budget {max_restarts})")
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)


def process_local_batch(global_channels: int) -> slice:
    """The channel range this rank feeds (host-sharded ingest: each rank
    reads only its own part of the capture)."""
    p, n = _rank_and_world()
    if global_channels % n:
        raise ValueError(
            f"process_local_batch: {global_channels} channels do not divide "
            f"over {n} processes (the remainder would never be ingested)")
    per = global_channels // n
    return slice(p * per, (p + 1) * per)
