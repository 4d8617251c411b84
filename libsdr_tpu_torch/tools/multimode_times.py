"""W2's multi-mode bank steps timed on the card, one against another.

    PYTHONPATH=<tree root> python libsdr_tpu_torch/tools/multimode_times.py \\
        [--reps 3] [--out mm_times.json]

W2 is the 256-channel bank (12,288 frames a block at 6.144 MHz, the
pattern pocsag,ax25,rtty,psk31, traffic on every fifth channel of
``tools/wideband_signals.mixed_band``).  Three steps run over the same
blocks: ``apps/multimode.build_bank`` with the pattern's map, and
``parallel/multimode.build_multimode_step`` on one rank with float32 planes
and with bfloat16 planes off the u8 wire.  For each, three numbers a block:

* ``wall_ms``: the host clock around the steps (the device's work and
  BPSK31's loop on the host, which the step waits for), and ``bpsk31_ms``
  the part of it spent in ``BPSK31.apply`` (its copy of the PSK31 group to
  the host, which waits for the device's work queued before it, and the
  loop);
* ``device_ms``: the sum of the CUDA kernels' times in a
  ``torch.profiler`` trace of the same steps, no host time in it.

The steps run interleaved, in turn forwards and backwards, ``--reps``
times, and each number is the median of its reps, so that a drift of the
host's speed falls on every step alike.  :func:`step_times` is the timer
``chip_smoke.py`` uses.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

M, FRAMES = 256, 12_288
FS = M * 24_000.0
PATTERN = ("pocsag", "ax25", "rtty", "psk31")


def device_ms(step, carry, blocks) -> float:
    """Device ms a block: the CUDA kernels' time in a profiler trace of the
    step over ``blocks``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for blk in blocks:
            carry, _ = step(carry, blk)
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            total += us
    return total / 1e3 / len(blocks)


def wall_ms(step, carry, blocks) -> tuple:
    """(host ms a block of the step over ``blocks``, of which BPSK31's
    host loop)."""
    from libsdr_tpu_torch.ops.psk31 import BPSK31

    apply, spent = BPSK31.apply, [0.0]

    def timed(self, c, x):
        t = time.perf_counter()
        out = apply(self, c, x)
        spent[0] += time.perf_counter() - t
        return out

    BPSK31.apply = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for blk in blocks:
            carry, _ = step(carry, blk)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        BPSK31.apply = apply
    return total / len(blocks) * 1e3, spent[0] / len(blocks) * 1e3


def step_times(steps: dict, reps: int = 3) -> dict:
    """{label: {"wall_ms", "bpsk31_ms", "device_ms"}} medians over ``reps``
    interleaved rounds; ``steps`` maps a label to (step, init_carry,
    blocks).  One untimed block of each step first."""
    for step, init, blocks in steps.values():
        step(init(), blocks[0])
    torch.cuda.synchronize()
    got = {k: {"wall_ms": [], "bpsk31_ms": [], "device_ms": []}
           for k in steps}
    order = list(steps)
    for r in range(reps):
        for k in (order if r % 2 == 0 else order[::-1]):
            step, init, blocks = steps[k]
            wall, host = wall_ms(step, init(), blocks)
            got[k]["wall_ms"].append(wall)
            got[k]["bpsk31_ms"].append(host)
            got[k]["device_ms"].append(device_ms(step, init(), blocks))
    return {k: {m: statistics.median(v) for m, v in d.items()}
            | {"reps": d} for k, d in got.items()}


def w2_steps(seed: int = 1515) -> dict:
    """W2's band and its three steps, as :func:`step_times` takes them."""
    from libsdr_tpu_torch.apps.multimode import build_bank
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.io.ingest import u8_wire_to_planes
    from libsdr_tpu_torch.parallel.multimode import build_multimode_step
    from libsdr_tpu_torch.tools import ingest_bank as IB
    from libsdr_tpu_torch.tools.wideband_signals import mixed_band

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    b = M * FRAMES
    mode_map = {ch: PATTERN[ch % 4] for ch in range(M)}
    x = mixed_band({ch: mode_map[ch] for ch in range(0, M - 5, 5)}, M,
                   "cuda", gen=gen, sigma=0.02)
    n = -(-x.shape[-1] // b)
    x = x.map(lambda a: torch.nn.functional.pad(a, (0, n * b - a.shape[-1])))
    blocks = [x[i * b:(i + 1) * b] for i in range(n)]
    xs = [Complex(blk.re[None], blk.im[None]) for blk in blocks]
    scale = IB.unclipped_scale(xs, 0.9)
    b16 = [u8_wire_to_planes(IB.quantize_u8(v, scale).reshape(-1),
                             torch.bfloat16) for v in xs]
    bstep, binit, _ = build_bank(FS, b, M, mode_map)
    step, init, _, _ = build_multimode_step(M, b, FS, PATTERN,
                                            device="cuda")
    step16, init16, _, _ = build_multimode_step(
        M, b, FS, PATTERN, plane_dtype=torch.bfloat16, device="cuda")
    return {"build_bank": (bstep, lambda: binit("cuda"), blocks),
            "sharded f32": (step, init, blocks),
            "sharded bf16": (step16, init16, b16)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res = step_times(w2_steps(), args.reps)
    for k, v in res.items():
        print(f"{k}: {v['wall_ms']:.2f} ms a block wall, of which "
              f"BPSK31 {v['bpsk31_ms']:.2f}, {v['device_ms']:.3f} device "
              f"(reps wall "
              f"{[round(t, 2) for t in v['reps']['wall_ms']]}, device "
              f"{[round(t, 3) for t in v['reps']['device_ms']]}) | {smi}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(results=res, device=smi), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
