"""Time the bit-clock PLL kernels (K2 ``pll``, K3 ``pll_bank``) on the card
at the digital paths' shapes, and sweep the serial pass's lanes per warp.

    python libsdr_tpu_torch/tools/pll_times.py [--reps 5] [--sweep]
        [--kernels] [--calls P1 P2 P3 W1 W2]

The calls, each on symbols in runs of one symbol period (L steps, a random
bit each) with 2% of the runs flipped, made on the card from a seed:

* P1: K2 over 64 lanes x 524,288 steps, L = 40, NRZI (the AX.25 bank);
* P2: K2 over 256 x 11,776, L = 20, NRZ (the POCSAG bank's block);
* P3: K3 over 192 x 262,144, L = 20 / 20 / 264 (the mode bank's PLL);
* W1: K2 over 1,024 x 65,536, L = 20, NRZ (the scanner's block);
* W2: K3 over 192 x 12,288, L = 20 / 20 / 264 (the multimode bank's).

Each is timed with CUDA events over ``--reps`` calls after one warm-up, and
printed as one JSON line with ns a step, the card's name and power limit
and, where the package counts them, the serial pass's layouts taken;
``--kernels`` adds each CUDA kernel's device time a call (torch.profiler).
``--sweep`` times K2 at 2^16 steps (L = 40, NRZI) for 64 to 65,536 lanes at
every lanes-per-warp layout, each from a build of the library with
``-DSDR_PLL_LANES=n`` (the six built in parallel), the measurement of
``csrc/bitsync.cu``'s lane cut.

The script imports ``libsdr_tpu_torch`` from the path, so one call can time
two trees in turns (say parent, change, change, parent) by running it with
``PYTHONPATH`` set to each tree's root; a tree without the layouts skips
the sweep.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import json
import subprocess
from unittest import mock

import numpy as np
import torch

BANK = ((20, 0), (20, 1), (264, 0))   # (L, transition) of the mode bank
CALLS = {  # name: (lanes, steps, L and transition of K2, or None for K3)
    "P1": (64, 524_288, 40, True),
    "P2": (256, 11_776, 20, False),
    "P3": (192, 262_144, None, None),
    "W1": (1024, 65_536, 20, False),
    "W2": (192, 12_288, None, None),
}


def _ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _module():
    """ops/pll.py itself (the package's ``ops.pll`` is the entry)."""
    return importlib.import_module("libsdr_tpu_torch.ops.pll")


def symbols(gen, m: int, t: int, run) -> torch.Tensor:
    """(m, t) uint8 on the card: runs of ``run`` steps (an int, or (m,)
    per-lane run lengths), a random bit each, 2% of the runs flipped."""
    run = torch.as_tensor(run, device="cuda").expand(m)
    n = int(t // int(run.min())) + 2
    bits = torch.randint(0, 2, (m, n), generator=gen, device="cuda")
    flip = torch.rand((m, n), generator=gen, device="cuda") < 0.02
    idx = torch.arange(t, device="cuda")[None, :] // run[:, None]
    return (bits ^ flip.long()).gather(1, idx).to(torch.uint8)


def call(name: str, gen):
    """The entry and its arguments for one of CALLS."""
    P = _module()
    m, t, ell, tr = CALLS[name]
    if ell is not None:
        om0 = 1.0 / ell
        st = (torch.zeros((m, ell - 1), dtype=torch.int32, device="cuda"),
              torch.zeros(m, dtype=torch.int32, device="cuda"),
              torch.zeros(m, device="cuda"),
              torch.full((m,), om0, device="cuda"),
              torch.zeros(m, dtype=torch.int32, device="cuda"))
        kw = dict(omega_min=om0 * 0.995, omega_max=om0 * 1.005, gain=0.0005,
                  transition=tr)
        return P.pll, (symbols(gen, m, t, ell),) + st, kw
    per = m // len(BANK)
    ells = np.repeat([e for e, _ in BANK], per).astype(np.int32)
    trans = np.repeat([tr for _, tr in BANK], per).astype(np.int32)
    om0 = (1.0 / ells).astype(np.float32)
    r = int(ells.max()) - 1
    st = (torch.zeros((m, r), dtype=torch.int32, device="cuda"),
          torch.zeros(m, dtype=torch.int32, device="cuda"),
          torch.zeros(m, device="cuda"),
          torch.from_numpy(om0).cuda(),
          torch.zeros(m, dtype=torch.int32, device="cuda"))
    kw = dict(omega_min=om0 * np.float32(0.995),
              omega_max=om0 * np.float32(1.005),
              gain=np.full(m, 0.0005, np.float32), transition=trans,
              ell=ells)
    sym = symbols(gen, m, t, torch.from_numpy(ells).cuda())
    return P.pll_bank, (sym,) + st, kw


def _kernels(fn, reps: int) -> dict:
    """Device ms a call by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            out[ev.key[:60]] = us / 1e3 / reps
    return out


def _taken(entry, before):
    routes = getattr(entry, "routes", None)
    if routes is None:
        return None
    return {str(k): n - before.get(k, 0) for k, n in routes.items()
            if n > before.get(k, 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--calls", nargs="+", default=list(CALLS),
                    choices=list(CALLS))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from libsdr_tpu_torch import _build
    P = _module()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for name in args.calls:
        entry, a, kw = call(name, gen)
        before = dict(getattr(entry, "routes", {}))
        ms = _ms(lambda: entry(*a, **kw), args.reps)
        m, t = a[0].shape
        rec = {"call": name, "entry": entry.__name__, "shape": [m, t],
               "ms": ms, "ns_per_step": ms * 1e6 / t,
               "layouts": _taken(entry, before), "card": smi}
        if args.kernels:
            rec["kernels"] = _kernels(lambda: entry(*a, **kw), args.reps)
        print(json.dumps(rec), flush=True)
        del a
    if args.sweep and hasattr(P, "LANES_PER_WARP"):
        variants = {n: (f"SDR_PLL_LANES={n}",) for n in P.LANES_PER_WARP}
        with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
            list(pool.map(_build.build, variants.values()))
        libs = {n: _build.library(d) for n, d in variants.items()}
        t, ell = 1 << 16, 40
        for m in (64, 256, 1024, 2048, 4096, 16384, 65536):
            sym = symbols(gen, m, t, ell)
            st = (torch.zeros((m, ell - 1), dtype=torch.int32,
                              device="cuda"),
                  torch.zeros(m, dtype=torch.int32, device="cuda"),
                  torch.zeros(m, device="cuda"),
                  torch.full((m,), 1.0 / ell, device="cuda"),
                  torch.zeros(m, dtype=torch.int32, device="cuda"))
            kw = dict(omega_min=0.995 / ell, omega_max=1.005 / ell,
                      gain=0.0005, transition=True)
            times = {}
            for lanes, lib in libs.items():
                with mock.patch.object(_build, "library", lambda *a: lib):
                    times[lanes] = _ms(lambda: P.pll(sym, *st, **kw),
                                       args.reps)
            rule = P.lanes_per_warp(m)
            print(json.dumps({"sweep": [m, t], "ms": times,
                              "ns_per_step": {k: v * 1e6 / t
                                              for k, v in times.items()},
                              "rule": rule,
                              "best": min(times, key=times.get),
                              "card": smi}), flush=True)
            del sym, st
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
