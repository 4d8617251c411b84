"""The sharded paths (counterpart of ``libsdr_tpu.parallel``) on
``torch.distributed``, one process a device.  The parallelism axes of an
SDR pipeline are channels x time blocks:

- channel parallelism: the leading channel dim sharded over a mesh axis
  ('ch'), the data-parallel analog; every op broadcasts over leading dims.
- time-block (sequence) parallelism: the trailing time dim sharded over a
  mesh axis ('time'); the overlap-save FIR tails and the channelizer's
  history become halos passed between neighbouring ranks
  (:mod:`libsdr_tpu_torch.parallel.halo`).

The explicit build functions are ``parallel/wideband.py`` (the wideband receiver
and the pager scanner) and ``parallel/multimode.py`` (the multi-mode
bank); ``parallel/distributed.py`` joins the process group, places shards
and checkpoints them.
"""

from libsdr_tpu_torch.parallel.mesh import make_mesh, shard_pipeline_step

__all__ = ["make_mesh", "shard_pipeline_step"]
