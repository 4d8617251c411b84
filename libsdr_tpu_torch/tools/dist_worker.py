"""One rank of a multi-process job on the sharded wideband receiver
(counterpart of ``tests/_distributed_worker.py`` and
``tests/_failover_worker.py``).

    python -m libsdr_tpu_torch.tools.dist_worker ingest --store URL \\
        --nproc N --rank R --out rows_R.npz
    python -m libsdr_tpu_torch.tools.dist_worker failover --store URL \\
        --nproc N --rank R --incarnation I --workdir DIR \\
        [--crash-at B --crash-rank R]

Every mode joins the group at ``--store`` (``file://`` or ``tcp://``; gloo
for ``--device cpu``, NCCL on the cards) and runs the sharded wideband step
(8 channels, a block of 8 x N x 32) on a 1-D mesh of the N ranks:

* ``ingest``: two chained steps of one block, each rank reading ONLY its
  own time range of the capture (``place_global_ingest``; every index its
  ``fetch`` sees is checked against the rank's range), and its rows of the
  channelized audio saved as ``rows_<first channel>``; a device that
  disagrees with the rank's on the mesh must be refused;
* ``failover``: four blocks with a sharded checkpoint after each
  (``save_sharded_checkpoint``; one file a rank in ``--workdir``) and a
  line a block in ``log_p<rank>.txt``.  Rank ``--crash-rank`` exits with
  code 17 at block ``--crash-at`` of incarnation 0, a lost host; a later
  incarnation resumes from the checkpoints, so no block runs twice.  The
  final block's rows go to ``out_p<rank>.npz``.  ``parallel.distributed.
  run_supervised`` is the launcher that restarts it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

M = 8   # channels of the wideband step


def _step(mesh, n):
    from libsdr_tpu_torch.parallel.wideband import build_wideband_step

    block = M * n * 32
    return (block,) + build_wideband_step(M, block, mesh=mesh)


def _rows(out, mesh, n) -> dict:
    """This rank's output rows keyed by their first global channel."""
    r = mesh.get_local_rank("d") if mesh is not None else 0
    return {f"rows_{r * (M // n)}": out.cpu().numpy()}


def ingest(args, mesh, n, rank) -> None:
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.parallel.distributed import place_global_ingest

    from libsdr_tpu_torch.core.stream import ConfigError
    from libsdr_tpu_torch.parallel.wideband import build_wideband_step

    block, step, init_carry, _ = _step(mesh, n)
    other = "cpu" if mesh.device_type == "cuda" else "cuda"
    try:        # a device that disagrees with the rank's on the mesh
        build_wideband_step(M, block, mesh=mesh, device=other)
    except ConfigError:
        pass
    else:
        raise SystemExit(f"device {other} on a {mesh.device_type} mesh "
                         "was taken")
    rng = np.random.default_rng(99)
    x = (rng.normal(size=block) + 1j * rng.normal(size=block)).astype(
        np.complex64)
    xb = cplx.as_block(x)
    fetched = []

    def place(plane):
        def fetch(idx):
            fetched.append(idx)
            return plane.numpy()[idx]
        return place_global_ingest(plane.shape, mesh, ("d",), fetch)

    carry = init_carry()
    out = None
    for _ in range(2):  # two steps: the carry hand-off too
        carry, out = step(carry, Complex(place(xb.re), place(xb.im)))
    per = block // n
    for (sl,) in fetched:
        if not (rank * per <= sl.start and sl.stop <= (rank + 1) * per):
            raise SystemExit(f"rank {rank} fetched {sl}, outside "
                             f"[{rank * per}, {(rank + 1) * per})")
    np.savez(args.out, **_rows(out, mesh, n))
    print(f"rank {rank} OK: fetched {[(s.start, s.stop) for s, in fetched]}")


def failover(args, mesh, n, rank) -> None:
    from libsdr_tpu_torch.parallel.distributed import (
        load_sharded_checkpoint, save_sharded_checkpoint)

    block, step, init_carry, place = _step(mesh, n)
    n_blocks = 4
    carry = init_carry()
    ckpt = os.path.join(args.workdir, f"ckpt_p{rank}.npz")
    start = 0
    if os.path.exists(ckpt):
        carry, start = load_sharded_checkpoint(ckpt, carry)
    rng = np.random.default_rng(5)
    blocks = [(rng.normal(size=block) + 1j * rng.normal(size=block)
               ).astype(np.complex64) for _ in range(n_blocks)]
    out = None
    with open(os.path.join(args.workdir, f"log_p{rank}.txt"), "a") as log:
        for b in range(start, n_blocks):
            if (args.incarnation == 0 and rank == args.crash_rank
                    and b == args.crash_at):
                os._exit(17)     # a lost host, mid-stream
            carry, out = step(carry, place(blocks[b]))
            save_sharded_checkpoint(ckpt, carry, b + 1)
            log.write(f"inc{args.incarnation} block{b}\n")
            log.flush()
    np.savez(os.path.join(args.workdir, f"out_p{rank}.npz"),
             **_rows(out, mesh, n))
    print(f"rank {rank} incarnation {args.incarnation} done")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("ingest", "failover"))
    ap.add_argument("--store", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    ap.add_argument("--incarnation", type=int, default=0)
    ap.add_argument("--workdir")
    ap.add_argument("--crash-at", type=int, default=-1)
    ap.add_argument("--crash-rank", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)

    from libsdr_tpu_torch.parallel.distributed import (global_mesh,
                                                       init_multihost,
                                                       shutdown_multihost)

    torch.set_num_threads(1)
    dev = init_multihost(args.store, args.nproc, args.rank,
                         device=args.device, timeout=args.timeout)
    mesh = global_mesh(("d",), device_type=dev.type)
    (ingest if args.mode == "ingest" else failover)(
        args, mesh, args.nproc, args.rank)
    shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main())
