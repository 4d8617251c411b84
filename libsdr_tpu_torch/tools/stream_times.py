"""The streaming config's throughput on the card against chunks per dispatch.

    python libsdr_tpu_torch/tools/stream_times.py [--ks 1 2 4 8]
        [--planes f32 bf16] [--sizes 524288 65536] [--blocks 8]
        [--reps 3]

The JAX package's streaming bench (``tools/bench_streaming.py``): the main
path ``IQBaseBand(fc=fs/8, width=200e3, order=64, decim=4,
design="textbook") -> FMDemod -> FMDeemph`` on 128 channels at 960 kHz, in
blocks of 2^19 samples and, its small-block section, 2^16, on ``--blocks``
blocks made on the card from a seed.  For each size, plane dtype and K it
prints one JSON line with

* ``run_ms``: ``run_pipeline(chunks_per_dispatch=K)`` a block, the outputs
  copied to the host and collected (best of ``--reps`` runs, after one
  that captures the graphs);
* ``device_ms``: the steps alone, a block: ``compile()`` at K = 1,
  ``compile_chunked("unroll")`` at K > 1 (its CUDA graph replayed, its
  outputs not cloned, as ``run_pipeline`` runs it), the outputs left on
  the card; and Msamples/s from each;
* ``launches``: K1a's launches a block in the timed run (at K > 1 the
  graph's launches per capture times its replays, plus the single steps).

A tree whose ``run_pipeline`` has no ``chunks_per_dispatch`` (and whose
``Pipeline`` has no ``compile_chunked``) is timed at K = 1 only, so one
call can time two trees in turns (parent, change, change, parent) by
running the script with ``PYTHONPATH`` set to each tree's root.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import time

import numpy as np
import torch

FS = 960_000.0
CHANNELS = 128


def stream_pipeline(block: int, plane_dtype=None, channels: int = CHANNELS):
    """The streaming config's main path, bound."""
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand

    p = L.Pipeline([IQBaseBand(fc=FS / 8, width=200e3, order=64, decim=4,
                               design="textbook"), FMDemod(), FMDeemph()])
    p.bind(L.StreamSpec(np.complex64, FS, block, channels=(channels,),
                        plane_dtype=plane_dtype))
    return p


def stream_blocks_on_card(block: int, n: int, dtype, seed: int = 19,
                          channels: int = CHANNELS):
    """n blocks of FM tones near FS/8 plus noise, on the card."""
    from libsdr_tpu_torch.core.cplx import Complex

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t = torch.arange(n * block, dtype=torch.float64, device="cuda")
    out = []
    fc = FS / 8 + (torch.arange(channels, device="cuda",
                                dtype=torch.float64) % 7 - 3) * 2e3
    ph = (2 * np.pi / FS) * (fc[:, None] * t[None, :]) - 30.0 * torch.cos(
        (2 * np.pi * 1000.0 / FS) * t)[None, :]
    ph = torch.remainder(ph, 2 * np.pi)
    xr = torch.cos(ph).float()
    xi = torch.sin(ph).float()
    del ph
    xr += 0.05 * torch.randn(xr.shape, generator=gen, device="cuda")
    xi += 0.05 * torch.randn(xi.shape, generator=gen, device="cuda")
    for k in range(n):
        sl = slice(k * block, (k + 1) * block)
        out.append(Complex(xr[:, sl].contiguous().to(dtype),
                           xi[:, sl].contiguous().to(dtype)))
    return out


def _has_k() -> bool:
    from libsdr_tpu_torch.core import run_pipeline
    return "chunks_per_dispatch" in inspect.signature(run_pipeline).parameters


def time_config(block: int, dtype, ks, n_blocks: int, reps: int,
                keep_outputs: bool = False) -> list:
    """One dict per K (see the module's docstring); with ``keep_outputs``
    each also holds ``out``, the collected output of the timed run."""
    from libsdr_tpu_torch.core import run_pipeline
    from libsdr_tpu_torch.ops import fir_fm as F

    blocks = stream_blocks_on_card(block, n_blocks, dtype)
    res = []
    for k in ks:
        if k > 1 and not _has_k():
            continue
        p = stream_pipeline(block, dtype)
        kw = dict(chunks_per_dispatch=k) if k > 1 else {}
        run_pipeline(p, blocks, device="cuda", **kw)   # capture, warm
        best, out, launches = float("inf"), None, None
        for _ in range(reps):
            stepk = p.compile_chunked("unroll") if k > 1 else None
            g0 = stepk.graph_launches().get("fir_fm_exact", 0) if k > 1 \
                else 0
            n0 = F.fir_fm_exact.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, y = run_pipeline(p, blocks, device="cuda", **kw)
            dt = time.perf_counter() - t0
            g1 = stepk.graph_launches().get("fir_fm_exact", 0) if k > 1 \
                else 0
            if dt < best:
                best, out = dt, y
                launches = (F.fir_fm_exact.launches - n0 + g1 - g0) \
                    / n_blocks
        # the steps alone
        carry = p.init_carry("cuda")
        if k == 1:
            step = p.compile()
            run = lambda c: [step(c, x) for x in blocks][-1][0]  # noqa: E731
        else:
            stepk = p.compile_chunked("unroll")

            def run(c):
                # as run_pipeline runs it: the graph's own outputs
                for i in range(0, n_blocks - k + 1, k):
                    c, _ = stepk.run(c, tuple(blocks[i:i + k]), clone=False)
                return c
        run(carry)
        dev_best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(carry)
            torch.cuda.synchronize()
            dev_best = min(dev_best, time.perf_counter() - t0)
        n_done = n_blocks if k == 1 else (n_blocks // k) * k
        samples = CHANNELS * block
        line = dict(
            block=block, planes="bf16" if dtype == torch.bfloat16 else "f32",
            K=k, blocks=n_blocks, run_ms=best / n_blocks * 1e3,
            run_msps=samples * n_blocks / best / 1e6,
            device_ms=dev_best / n_done * 1e3,
            device_msps=samples * n_done / dev_best / 1e6,
            launches=launches)
        if keep_outputs:
            line["out"] = out
        res.append(line)
        del p
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ks", nargs="+", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--planes", nargs="+", default=["f32", "bf16"])
    ap.add_argument("--sizes", nargs="+", type=int,
                    default=[1 << 19, 1 << 16])
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    import libsdr_tpu_torch
    for size in args.sizes:
        for planes in args.planes:
            dtype = torch.bfloat16 if planes == "bf16" else torch.float32
            for line in time_config(size, dtype, args.ks, args.blocks,
                                    args.reps):
                line.update(tree=libsdr_tpu_torch.__file__, card=smi)
                print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
