"""Where the time of the digital and wideband receive paths goes on the
card.

    python -m libsdr_tpu_torch.tools.digital_profile [--out profile.json]
        [--paths P1 P2 P3 W1 W2]

Needs one CUDA card and nvcc.  For each path it drives a few carry-chained
steps under ``torch.profiler``, on the message traffic that
``chip_smoke.py`` drives (``tools/digital_signals.py``), and prints the
device time per kernel name and step, the step time on the host clock
(ended by a synchronize) and the device's busy share (kernel time over
step time):

* P1, the AX.25/APRS bank: 64 channels x 2^21 samples at 192 kHz through
  IQBaseBand(order 48, 48 kHz) -> FMDemod -> FSKDetector -> BitStream
  (AFSKFrontendFused + BitStream: K1e, then K2's two kernels);
* P2, the POCSAG bank: 256 channels x 117,760 samples at 240 kHz through
  apps/chains.pocsag_front_end (K1a, ASKDetector, K2);
* P3, the mode bank: apply_mode_chains over 3 x 64 channels x 2^18 steps
  at 24 kHz (the plain demodulators and FSK detectors, one K3 launch);
* W1, the whole-band pager scanner: 1024 channels x 2^26-sample blocks at
  24.576 MHz through parallel/wideband.build_scanner_step (K4's demod
  variant, the plain ASK detector, K2's two kernels, the windowed
  compaction), on the pages of ``tools/wideband_signals.pager_band``;
* W2, the multimode bank: 256 channels x 12,288 frames at 6.144 MHz
  through apps/multimode.build_bank (K4's channel variant, the plain FM/USB
  demodulators and FSK detectors, K3, the PSK31 group's K1b and BPSK31's
  kernel, whose share of the step's host time is printed apart), on the
  traffic of ``tools/wideband_signals.mixed_band``.

With every path (the default), it then profiles the PLL kernel alone at
2^16 steps for 64 to 65,536 lanes (a recurrence per lane: the time per
step stays flat while it is latency-bound) and writes the SASS of its
kernels (``cuobjdump``; ``pll_serial``, the serial loop, first, then
``pll_majority``, ``pll_sums``, ``pll_scan`` and ``pll_bits``) to
``--sass`` for reading the dependent chain of one step.  ``--paths``
profiles only the paths named; run as a script with ``PYTHONPATH`` set to
a tree's root, it times that tree's package, so one call can take two
trees in turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from libsdr_tpu_torch import _build
from libsdr_tpu_torch.tools.digital_signals import (ax25_bank, mode_bank,
                                                    mode_chains,
                                                    pocsag_blocks)


def _profile(label, step_fn, steps):
    """Kernel device time per name and step, host step time, busy share."""
    from torch.profiler import ProfilerActivity, profile

    step_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0 and getattr(ev, "device_type", None) is not None \
                and str(ev.device_type).endswith("CUDA"):
            kernels[ev.key] = dev_us / 1e3 / steps
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    print(f"{label}: {wall_ms:.3f} ms/step (host clock), device "
          f"{busy:.3f} ms/step, busy share {busy / wall_ms:.3f}")
    for name, ms in top[:12]:
        print(f"    {ms:9.3f} ms  {name[:100]}")
    return dict(step_ms=wall_ms, device_ms=busy, busy=busy / wall_ms,
                kernels=dict(top))


def p1(gen):
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.ops import (BitStream, FMDemod, FSKDetector,
                                      IQBaseBand)

    c, b = 64, 1 << 21
    p = L.Pipeline([IQBaseBand(fc=24e3, width=12.5e3, order=48,
                               out_rate=48e3, design="textbook"),
                    FMDemod(), FSKDetector(1200.0, 1200.0, 2200.0),
                    BitStream(1200.0, mode="transition")])
    p.bind(L.StreamSpec(np.complex64, 192_000.0, b, channels=(c,)))
    x = ax25_bank(c, b, gen)
    state = {"c": p.init_carry("cuda")}

    def step():
        state["c"], _ = p.apply(state["c"], x)
    return _profile("P1 AX.25 bank 64 x 2^21 @ 192 kHz", step, 5)


def p2(gen):
    from libsdr_tpu_torch.apps.chains import pocsag_front_end

    c, b = 256, 117_760
    fe = pocsag_front_end(240e3, b, channels=(c,))
    blocks = pocsag_blocks(c, b, 4, gen)
    state = {"c": fe.init_carry("cuda"), "k": 0}

    def step():
        state["c"], _ = fe.apply(state["c"], blocks[state["k"] % 4])
        state["k"] += 1
    return _profile("P2 POCSAG bank 256 x 117,760 @ 240 kHz", step, 8)


def p3(gen):
    from libsdr_tpu_torch.ops.bitsync import apply_mode_chains

    per, t = 64, 1 << 18
    y, groups = mode_bank(per, t, gen)
    sub, windows = mode_chains(per, t)
    state = {"c": {m: p.init_carry("cuda") for m, p in sub.items()}}

    def step():
        _, state["c"] = apply_mode_chains(sub, state["c"], y, groups,
                                          windows)
    return _profile("P3 mode bank 3 x 64 x 2^18 @ 24 kHz", step, 3)


def w1(gen):
    from libsdr_tpu_torch.core.ragged import min_valid_gap, pick_window
    from libsdr_tpu_torch.parallel.wideband import build_scanner_step
    from libsdr_tpu_torch.tools.wideband_signals import pager_band

    m, b, fs = 1024, 1 << 26, 1024 * 24_000.0
    blocks, _ = pager_band(m, 2, b, "cuda", gen=gen)
    w = pick_window(min_valid_gap(0.05 * 1.005), b // m)
    step, init, place = build_scanner_step(m, b, fs, compact_window=w,
                                           packed=True, device="cuda")
    state = {"c": init(), "k": 0}

    def one():
        state["c"], _ = step(state["c"], place(blocks[state["k"] % 2]))
        state["k"] += 1
    return _profile("W1 scanner 1024 x 2^26 @ 24.576 MHz", one, 4)


def w2(gen):
    from libsdr_tpu_torch.apps.multimode import MODES, build_bank
    from libsdr_tpu_torch.ops.psk31 import BPSK31
    from libsdr_tpu_torch.tools.wideband_signals import mixed_band

    m, frames = 256, 12_288
    b, fs = m * frames, m * 24_000.0
    mode_map = {ch: MODES[ch % 4] for ch in range(m)}
    x = mixed_band({ch: mode_map[ch] for ch in range(0, m - 5, 5)}, m,
                   "cuda", gen=gen, sigma=0.02)
    blocks = [x[i * b:(i + 1) * b] for i in range(x.shape[-1] // b)]
    step, init, _ = build_bank(fs, b, m, mode_map)
    state = {"c": init("cuda"), "k": 0}
    spent = [0.0]
    apply = BPSK31.apply

    def timed(self, carry, xin):
        t0 = time.perf_counter()
        out = apply(self, carry, xin)
        spent[0] += time.perf_counter() - t0
        return out

    def one():
        state["c"], _ = step(state["c"], blocks[state["k"] % len(blocks)])
        state["k"] += 1
    BPSK31.apply = timed
    try:
        steps = 4
        res = _profile("W2 multimode bank 256 x 12,288 @ 6.144 MHz", one,
                       steps)
    finally:
        BPSK31.apply = apply
    # the loop ran in 2 * steps + 1 steps (_profile's warm-up, timed and
    # profiled runs)
    res["bpsk31_ms"] = spent[0] / (2 * steps + 1) * 1e3
    print(f"    BPSK31.apply {res['bpsk31_ms']:.3f} ms a step "
          f"({res['bpsk31_ms'] / res['step_ms']:.1%} of the step)")
    return res


def pll_scaling(gen):
    """The PLL kernel alone: ms and ns per step at 2^16 steps by lanes."""
    from libsdr_tpu_torch.ops.pll import pll

    t, out = 1 << 16, {}
    for m in (64, 1024, 8192, 65536):
        sym = (torch.rand((m, t), generator=gen, device="cuda") > 0.5).to(
            torch.uint8)
        st = (torch.zeros((m, 39), dtype=torch.int32, device="cuda"),
              torch.zeros(m, dtype=torch.int32, device="cuda"),
              torch.zeros(m, device="cuda"),
              torch.full((m,), 0.025, device="cuda"),
              torch.zeros(m, dtype=torch.int32, device="cuda"))
        kw = dict(omega_min=0.025 * 0.995, omega_max=0.025 * 1.005,
                  gain=0.0005, transition=True)
        res = _profile(f"pll alone, {m} lanes x {t} steps",
                       lambda: pll(sym, *st, **kw), 3)
        res["ns_per_step"] = res["device_ms"] * 1e6 / t
        print(f"    {res['ns_per_step']:.2f} ns per step")
        out[m] = res
    return out


PLL_KERNELS = ("pll_serial", "pll_majority", "pll_sums", "pll_scan",
               "pll_bits")


def sass(path: Path) -> None:
    """The SASS of the PLL's kernels, from the built library, the serial
    loop first."""
    lib, _ = _build.build()
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            cur = next((k for k in PLL_KERNELS if k in line), None)
        if cur is not None:
            funcs.setdefault(cur, []).append(line)
    lines = [x for k in PLL_KERNELS for x in funcs.get(k, [])]
    path.write_text("\n".join(lines) + "\n")
    print(f"SASS of {', '.join(k for k in PLL_KERNELS if k in funcs)}: "
          f"{len(lines)} lines -> {path}")


PATHS = {"P1": p1, "P2": p2, "P3": p3, "W1": w1, "W2": w2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="digital_profile.json")
    ap.add_argument("--sass", default="pll.sass")
    ap.add_argument("--paths", nargs="+", default=list(PATHS),
                    choices=list(PATHS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    _build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    res = {"device": smi}
    for name in args.paths:
        res[name] = PATHS[name](gen)
        torch.cuda.empty_cache()
    if len(args.paths) == len(PATHS):
        res["pll_scaling"] = pll_scaling(gen)
        sass(Path(args.sass))
    Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
