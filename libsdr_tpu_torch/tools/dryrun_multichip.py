"""Dry run of every sharded build function over N ranks, each against its n == 1
run (counterpart of ``__graft_entry__.py::dryrun_multichip``).

    python -m libsdr_tpu_torch.tools.dryrun_multichip --nproc 4 --device cpu
    python -m libsdr_tpu_torch.tools.dryrun_multichip --nproc 4   # NCCL

starts N ranks of this module (a ``file://`` store in a temporary
directory, no port), each of which joins the group (gloo for ``--device
cpu``, NCCL on the cards), runs the build functions on its shard
and compares its part of the result with the one-device program run in the
same rank on the whole input:

* ``shard_pipeline_step`` on a ('ch', 'time') mesh (2 ranks on time when N
  is even): an FM bank, and one whose FIR is longer than a time shard;
* ``fir_overlap_save_sharded`` over three carried blocks;
* ``build_wideband_step`` (P = 3 and 8) and ``build_scanner_step`` over
  two chained blocks, bit for bit;
* ``build_multimode_step`` (POCSAG/AX.25/RTTY/PSK31) over two chained
  blocks, bit for bit;
* ``shard_map_pipeline_step`` over channels: the fused FM chain and the AM
  chain with its AGC, bit for bit;
* with ``--wide``, the wideband and multi-mode steps at W2's width too
  (256 channels x 12,288 frames, 6.144 MHz).

Rank 0 prints one line a build function and the launcher exits non-zero when a
rank fails, disagrees beyond the bound or does not finish in ``--timeout``
seconds.  ``--out DIR`` keeps each rank's outputs (``rank<r>.npz``, with
the slice of the global result each holds) for a comparison elsewhere.
The inputs are made with numpy from fixed seeds, the shapes those of
``tests/test_parallel.py``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

FIR_ATOL = 1e-5      # tests/test_parallel.py's halo FIR bound
GSPMD_ATOL = 2e-4    # and its GSPMD pipeline bound


def _bound(stages, n_ch: int, fs: float, b: int):
    from libsdr_tpu_torch import Pipeline, StreamSpec

    p = Pipeline(stages)
    p.bind(StreamSpec(np.complex64, fs, b, channels=(n_ch,)))
    return p


def _fm_bank(fs: float, order: int):
    from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand

    return [IQBaseBand(fc=fs / 8, width=fs / 5, order=order, decim=4,
                       design="textbook"), FMDemod(), FMDeemph()]


def _channelwise(name: str):
    from libsdr_tpu_torch.ops import (AGC, AMDemod, FMDeemph, FMDemod,
                                      IQBaseBand)

    front = IQBaseBand(fc=24e3, width=12.5e3, order=48, out_rate=48e3,
                       design="textbook")
    if name == "fm":
        return [front, FMDemod(), FMDeemph()]
    return [front, AMDemod(), AGC(tau=0.03)]


def _complex(rng, shape, scale=1.0):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            * scale).astype(np.complex64)


def _leaves_np(tree):
    from libsdr_tpu_torch.core.graph import _leaves

    return [v.detach().float().cpu().numpy()
            if v.dtype == torch.bfloat16 else v.detach().cpu().numpy()
            for v in _leaves(tree)[0]]


def _compare(got, ref):
    """(max |got - ref| over the leaves, bit for bit)."""
    err, exact = 0.0, True
    for a, b in zip(_leaves_np(got), _leaves_np(ref)):
        if a.shape != b.shape:
            return float("inf"), False
        exact = exact and np.array_equal(a, b)
        if a.size:
            err = max(err, float(np.abs(a.astype(np.float64)
                                        - b.astype(np.float64)).max()))
    return err, exact


def _ragged_masked(outs):
    """A bank's {mode: Ragged} as data * valid and valid, numpy."""
    return {mode: (r.data.cpu().numpy() * r.valid.cpu().numpy(),
                   r.valid.cpu().numpy()) for mode, r in outs.items()}


def check_gspmd(dev, n, saved, rng_seed=1234):
    """shard_pipeline_step on a ('ch', 'time') mesh against the unsharded
    pipeline, and one whose FIR (order 296) spans more than a time shard."""
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.parallel import make_mesh, shard_pipeline_step
    from libsdr_tpu_torch.parallel.distributed import place_global

    n_time = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n_channel=n // n_time, n_time=n_time,
                     device_type=dev.type)
    lines = []
    for label, n_ch, fs, b, order in (("GSPMD fm bank", 16, 64_000.0, 2048,
                                       16),
                                      ("halo spans a shard", 2 * n, 64_000.0,
                                       256 * n_time, 256 + 40)):
        x = _complex(np.random.default_rng(rng_seed), (n_ch, b))
        step, place, carry = shard_pipeline_step(
            _bound(_fm_bank(fs, order), n_ch, fs, b), mesh)
        _, y = step(carry, place(x))
        solo = _bound(_fm_bank(fs, order), n_ch, fs, b)
        _, y1 = solo.apply(solo.init_carry(dev), cplx.as_block(x, device=dev))
        spec = ("ch", "time")
        ref = place_global(y1, mesh, spec, y1.dtype)
        err, exact = _compare(y, ref)
        if label.startswith("GSPMD"):
            from libsdr_tpu_torch.parallel.distributed import shard_index
            idx = shard_index(tuple(y1.shape), mesh, spec)
            saved["gspmd"] = y.cpu().numpy()
            saved["gspmd_idx"] = np.asarray(
                [idx[0].start, idx[0].stop, idx[1].start, idx[1].stop])
        lines.append((f"{label}: mesh ch {n // n_time} x time {n_time}, "
                      f"{n_ch} ch x {b}", err, exact, err <= GSPMD_ATOL))
    return lines


def check_fir_halo(dev, mesh, saved):
    """fir_overlap_save_sharded over three carried blocks against the
    one-device fir_overlap_save."""
    from libsdr_tpu_torch.ops import firdesign
    from libsdr_tpu_torch.ops.fir import fir_overlap_save
    from libsdr_tpu_torch.parallel.distributed import place_global
    from libsdr_tpu_torch.parallel.halo import (fir_overlap_save_sharded,
                                                mesh_axis)

    ax = mesh_axis(mesh, "d")
    taps = firdesign.lowpass(33, 4000, 48000).astype(np.float32)
    b = 1024
    x = np.random.default_rng(1234).normal(size=3 * b).astype(np.float32)
    tail = torch.zeros(32, device=dev)
    tail1 = torch.zeros(32, device=dev)
    got, want = [], []
    for i in range(3):
        xb = x[i * b:(i + 1) * b]
        y, tail = fir_overlap_save_sharded(
            taps, place_global(xb, mesh, ("d",), device=dev), tail, ax)
        y1, tail1 = fir_overlap_save(taps, torch.as_tensor(xb, device=dev),
                                     tail1)
        got.append(y)
        want.append(place_global(y1, mesh, ("d",), y1.dtype))
    saved["fir"] = torch.cat(got).cpu().numpy()
    err, exact = _compare(torch.cat(got), torch.cat(want))
    return [(f"halo FIR: 33 taps, 3 blocks of {b}", err, exact,
             err <= FIR_ATOL)]


def check_wideband(dev, mesh, n, saved, m=16, block=16 * 8 * 16,
                   ps=(3, 8), tag=""):
    """build_wideband_step at each P of ``ps``, two chained blocks, against
    the one-device step (by default tests/test_parallel.py's fallback
    test's shapes)."""
    from libsdr_tpu_torch.parallel.wideband import build_wideband_step

    rng = np.random.default_rng(3)
    xs = [_complex(rng, block) for _ in range(2)]
    lines = []
    for p in ps:
        step, init, place = build_wideband_step(m, block, p, mesh=mesh)
        step1, init1, place1 = build_wideband_step(m, block, p, device=dev)
        c, c1 = init(), init1()
        got, want = [], []
        for x in xs:
            c, y = step(c, place(x))
            c1, y1 = step1(c1, place1(x))
            got.append(y)
            want.append(y1)
        g = m // n
        r = torch.distributed.get_rank()
        y, y1 = torch.cat(got, -1), torch.cat(want, -1)[r * g:(r + 1) * g]
        if p == 8 and not tag:
            saved["wideband"] = y.cpu().numpy()
        err, exact = _compare(y, y1)
        lines.append((f"wideband P={p}{tag}: {m} ch, 2 blocks of {block}",
                      err, exact, exact))
    return lines


def check_scanner(dev, mesh, n):
    """build_scanner_step (fused channelize + FM, ASK, bit-sync PLL)
    against the one-device scanner, bit for bit."""
    from libsdr_tpu_torch.parallel.wideband import build_scanner_step

    m = 16
    fs = m * 25_000.0
    block = m * 8 * 64 * 4
    x = _complex(np.random.default_rng(11), block, 0.3)
    step, init, place = build_scanner_step(m, block, fs, mesh=mesh)
    step1, init1, place1 = build_scanner_step(m, block, fs, device=dev)
    _, bits = step(init(), place(x))
    _, bits1 = step1(init1(), place1(x))
    g = m // n
    r = torch.distributed.get_rank()
    got = _ragged_masked({"s": bits})["s"]
    ref = _ragged_masked({"s": bits1})["s"]
    ref = tuple(a[r * g:(r + 1) * g] for a in ref)
    exact = all(np.array_equal(a, b) for a, b in zip(got, ref))
    return [(f"scanner (FM + ASK + PLL): {m} ch, block {block}, "
             f"{int(got[1].sum())} bits on this rank",
             0.0 if exact else 1.0, exact, exact)]


def check_multimode(dev, mesh, n, m=32, t_full=576, tag=""):
    """build_multimode_step against the one-device bank over two chained
    blocks, bit for bit (by default tests/test_parallel.py's shapes)."""
    from libsdr_tpu_torch.parallel.multimode import build_multimode_step

    fs = m * 24_000.0
    block = m * t_full
    pattern = ("pocsag", "ax25", "rtty", "psk31")
    rng = np.random.default_rng(7)
    xs = [_complex(rng, block, 0.3) for _ in range(2)]
    step, init, place, groups = build_multimode_step(m, block, fs, pattern,
                                                     mesh=mesh)
    step1, init1, place1, groups1 = build_multimode_step(m, block, fs,
                                                         pattern, device=dev)
    r = torch.distributed.get_rank()
    c, c1 = init(), init1()
    exact, bits = True, 0
    for x in xs:
        c, o = step(c, place(x))
        c1, o1 = step1(c1, place1(x))
        got, ref = _ragged_masked(o), _ragged_masked(o1)
        for mode in pattern:
            k = len(groups[mode]) // n
            exact = exact and np.array_equal(groups[mode], groups1[mode])
            for a, b in zip(got[mode], ref[mode]):
                exact = exact and np.array_equal(a, b[r * k:(r + 1) * k])
            bits += int(got[mode][1].sum())
    return [(f"multi-mode bank{tag}: {m} ch, {pattern}, 2 blocks of {block}, "
             f"{bits} bits on this rank", 0.0 if exact else 1.0, exact,
             exact)]


def check_shard_map(dev, mesh, saved):
    """shard_map_pipeline_step over channels, FM and AM chains, bit for
    bit the one-device step."""
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.parallel.distributed import place_global
    from libsdr_tpu_torch.parallel.mesh import shard_map_pipeline_step

    n_ch, fs, b = 64, 192_000.0, 4096
    x = _complex(np.random.default_rng(1234), (n_ch, b))
    lines = []
    for name in ("fm", "am"):
        step, place, carry = shard_map_pipeline_step(
            _bound(_channelwise(name), n_ch, fs, b), mesh, axis="d")
        _, y = step(carry, place(x))
        solo = _bound(_channelwise(name), n_ch, fs, b)
        _, y1 = solo.apply(solo.init_carry(dev), cplx.as_block(x, device=dev))
        saved[f"shard_map_{name}"] = y.cpu().numpy()
        err, exact = _compare(y, place_global(y1, mesh, ("d",), y1.dtype))
        lines.append((f"shard_map {name} bank: {n_ch} ch x {b}", err, exact,
                      exact))
    return lines


def worker(args) -> int:
    import torch.distributed as dist

    from libsdr_tpu_torch.parallel.distributed import (global_mesh,
                                                       init_multihost,
                                                       shutdown_multihost)

    torch.set_num_threads(1)
    n = args.nproc
    dev = init_multihost(args.store, n, args.rank, device=args.device,
                         timeout=args.timeout)
    mesh = global_mesh(("d",), device_type=dev.type)
    saved = {}
    lines = (check_gspmd(dev, n, saved) + check_fir_halo(dev, mesh, saved)
             + check_wideband(dev, mesh, n, saved)
             + check_scanner(dev, mesh, n) + check_multimode(dev, mesh, n)
             + check_shard_map(dev, mesh, saved))
    if args.wide:       # W2's width: 256 channels x 12,288 frames
        lines += (check_wideband(dev, mesh, n, saved, 256, 256 * 12_288,
                                 (8,), " at W2")
                  + check_multimode(dev, mesh, n, 256, 12_288, " at W2"))
    if args.out:
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **saved)
    every = [None] * n
    dist.all_gather_object(every, lines)
    ok = all(line[3] for rank_lines in every for line in rank_lines)
    if args.rank == 0:
        for i, (label, _, _, _) in enumerate(lines):
            col = [rank_lines[i] for rank_lines in every]
            worst = max(c[1] for c in col)
            exact = all(c[2] for c in col)
            good = all(c[3] for c in col)
            print(f"dryrun_multichip {'OK' if good else 'FAIL'} ({label}): "
                  f"{n} ranks on {dev.type}, max |n - (n == 1)| {worst:.3e}"
                  f", bit for bit {exact}", flush=True)
    shutdown_multihost()
    return 0 if ok else 1


def launch(nproc: int, device: str = "cuda", out: str = None,
           timeout: float = 300.0, env=None, wide: bool = False):
    """Run the dry run on ``nproc`` ranks of this module; returns (exit
    code, rank 0's output, every rank's output).  Every rank is killed when
    the run outlasts ``timeout`` seconds."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [v for v in [env.get("PYTHONPATH")] if v])
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = []
        for r in range(nproc):
            cmd = [sys.executable, "-m", "libsdr_tpu_torch.tools."
                   "dryrun_multichip", "--nproc", str(nproc), "--rank",
                   str(r), "--store", store, "--device", device,
                   "--timeout", str(timeout)]
            if out:
                cmd += ["--out", out]
            if wide:
                cmd += ["--wide"]
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            return 124, "", logs
        rc = max(p.returncode for p in procs)
        return rc, logs[0], logs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--rank", type=int, default=None,
                    help="run as this rank (the launcher passes it)")
    ap.add_argument("--store", help="the group's init_method (a rank's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: rank r on card r) or cpu")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--wide", action="store_true",
                    help="also the wideband and multi-mode steps at W2's "
                         "width (256 channels x 12,288 frames)")
    args = ap.parse_args(argv)
    if args.rank is not None:
        return worker(args)
    rc, log0, logs = launch(args.nproc, args.device, args.out, args.timeout,
                            wide=args.wide)
    print(log0 if rc == 0 else "\n".join(logs), end="")
    return rc


if __name__ == "__main__":
    sys.exit(main())
