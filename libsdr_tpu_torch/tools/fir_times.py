"""Time the decimating-FIR kernels at the main path's shapes on the card.

    python libsdr_tpu_torch/tools/fir_times.py [--planes f32 bf16]
        [--reps 10] [--variants default staged] [--calls K1a K1e ...]
        [--knockouts]

64 channels x 2^24 samples, T = 67 random complex taps, D = 4: K1a
(``fir_fm_exact`` with de-emphasis), K1b (``fir_exact``) and, where the
package has them, K5 (``fir_offset`` at offset 0, F1's call) and K6
(``fir_fm_mxu`` at window start 1 in fm with de-emphasis and am with the
AGC); K1c (``fir_am_exact`` with the AGC) and K1d (``fir_usb_exact`` with
the AGC and its exact NCO) at the AM and USB banks' shapes of
``chip_smoke.py`` (``apps/chains.rx_stages`` at 960 kHz, 64 channels x
16,777,200 samples: T = 71, D = 40 and T = 143, D = 80); and K1e (``fir_afsk_exact``) at the AX.25 bank P1's shape: 64
channels x 2^21 at 192 kHz, the bank's taps (T = 51), D = 4 and its
L = 40 tone templates, from a template phase of 7 and nonzero carried
products.  Each kernel is timed with CUDA events over ``--reps`` launches
after one warm-up; one JSON line per plane dtype and build variant, with
the card's name and power limit and, where the entries count them, the
routes the timed launches took.  ``--calls`` keeps the calls whose names
start with one of the prefixes given.

Build variants: ``default`` is the library as the package builds it;
``staged`` is built with ``SDR_TC_MAX_D=0``, so that every launch takes the
staged or warp kernel (the tensor-core route's comparison, in turns with
``default`` in one call: every call leaves it).  ``--knockouts`` adds, for both, the builds
without parts of K1e's epilogue (``csrc/fir_common.cuh``:
``SDR_AFSK_KO_SUM``, ``_TONE``, ``_DISC`` and all three), named
``<variant> -sum`` and so on; their outputs are wrong, and only K1e's
time is of interest in them.

The script imports ``libsdr_tpu_torch`` from the path, so one call can time
two trees in turns (say parent, change, change, parent) by running it with
``PYTHONPATH`` set to each tree's root; a tree without the tensor-core
route ignores the ``staged`` variant's define.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
from unittest import mock

import numpy as np
import torch

C, B, T, D = 64, 1 << 24, 67, 4
B_P1 = 1 << 21   # K1e: the AX.25 bank's block at 192 kHz
B_BANK = 80 * (B // 80)   # K1c, K1d: the AM and USB banks' block
VARIANTS = {"default": (), "staged": ("SDR_TC_MAX_D=0",)}
KNOCKOUTS = {"-sum": ("SDR_AFSK_KO_SUM=1",), "-tone": ("SDR_AFSK_KO_TONE=1",),
             "-disc": ("SDR_AFSK_KO_DISC=1",),
             "-all": ("SDR_AFSK_KO_SUM=1", "SDR_AFSK_KO_TONE=1",
                      "SDR_AFSK_KO_DISC=1")}


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


def _routes(entries):
    return {e.__name__: dict(e.routes) for e in entries
            if hasattr(e, "routes")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--planes", nargs="+", default=["f32", "bf16"],
                    choices=["f32", "bf16"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", nargs="+", default=["default"],
                    choices=list(VARIANTS))
    ap.add_argument("--calls", nargs="+", default=None)
    ap.add_argument("--knockouts", action="store_true")
    args = ap.parse_args(argv)
    variants = {v: VARIANTS[v] for v in args.variants}
    if args.knockouts:
        variants.update({f"{v} {k}": VARIANTS[v] + d
                         for v in args.variants
                         for k, d in KNOCKOUTS.items()})

    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import fir_fm as F
    try:
        from libsdr_tpu_torch.ops import fir_mxu as M
    except ImportError:   # a tree from before K5/K6
        M = None

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(_build.build, variants.values()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def cn(*shape):
        return Complex(torch.randn(shape, generator=gen, device="cuda"),
                       torch.randn(shape, generator=gen, device="cuda"))

    taps = cn(T) * (1 / T ** 0.5)
    x32 = cn(C, B)
    prev = cn(C)
    state = torch.full((C,), 0.5, device="cuda")
    entries = [F.fir_fm_exact, F.fir_exact, F.fir_afsk_exact,
               F.fir_am_exact, F.fir_usb_exact] + (
        [M.fir_mxu, M.fir_fm_mxu] if M is not None else [])
    op = _p1_op()
    ell = op.corr_len
    banks = {name: (bop, bop.init_carry("cuda"))
             for name, bop in (("K1c fir_am_exact", _bank_op("AM")),
                               ("K1d fir_usb_exact", _bank_op("USB")))}
    p1_x32 = cn(C, B_P1)
    p1_carry = (cn(C, op._t - 1), cn(C),
                torch.tensor(7, dtype=torch.int32, device="cuda"),
                cn(C, ell - 1), cn(C, ell - 1))
    for plane in args.planes:
        x = x32 if plane == "f32" else x32.to(torch.bfloat16)
        tail = cn(C, T - 1).to(x.re.dtype)
        p1_x = p1_x32 if plane == "f32" else p1_x32.to(torch.bfloat16)
        p1_args = (p1_x, op._taps("cuda"), op._decim,
                   p1_carry[0].to(p1_x.re.dtype), p1_carry[1], op._rot,
                   op._gain, op._on("mark", op._tones[0], "cuda"),
                   op._on("space", op._tones[1], "cuda")) + p1_carry[2:]
        calls = {
            "K1a fir_fm_exact": lambda: F.fir_fm_exact(
                x, taps, D, tail, prev, -1j, 1.0, (0.95, 0.05), state),
            "K1b fir_exact": lambda: F.fir_exact(x, taps, D, tail),
        }
        if M is not None:
            lead = Complex(prev.re[:, None], prev.im[:, None])
            calls["K5 fir_offset"] = lambda: M.fir_offset(x, taps, D, 0, tail)
            calls["K6 fir_fm_mxu fm"] = lambda: M.fir_fm_mxu(
                x, taps, D, 1, lead, -1j, 1.0, (0.95, 0.05),
                state[:, None])
            lam = float(np.exp(-1.0 / (0.1 * 960e3 / D)))
            calls["K6 fir_fm_mxu am"] = lambda: M.fir_fm_mxu(
                x, taps, D, 1, lead, 1.0, 0.125, (lam, 1 - lam),
                state[:, None], mode="am")
        calls["K1e fir_afsk_exact"] = lambda: F.fir_afsk_exact(*p1_args)
        bank_x = Complex(x.re[:, :B_BANK].contiguous(),
                         x.im[:, :B_BANK].contiguous())
        for name, (bop, bcarry) in banks.items():
            front = (bank_x, bop._taps("cuda"), bop._decim,
                     bcarry[0].to(x.re.dtype))
            if name.startswith("K1c"):
                bargs = front + (bop._gain, bop._ab, bcarry[1])
                calls[name] = lambda a=bargs: F.fir_am_exact(*a)
            else:
                bargs = front + (bcarry[1], bop._on("ramp", bop._ramp_np,
                                                     "cuda"),
                                 bop._gain, bop._ab, bcarry[2])
                calls[name] = lambda a=bargs: F.fir_usb_exact(*a)
        if args.calls:
            calls = {n: fn for n, fn in calls.items()
                     if any(n.startswith(c) for c in args.calls)}
        for variant, defines in variants.items():
            lib = _build.library(defines)
            with mock.patch.object(_build, "library", lambda *a: lib):
                before = _routes(entries)
                times = {name: _ms(fn, args.reps)
                         for name, fn in calls.items()}
                after = _routes(entries)
            taken = {name: {r: n - before[name][r] for r, n in rs.items()
                            if n > before[name][r]}
                     for name, rs in after.items()}
            print(json.dumps({"planes": plane, "variant": variant,
                              "shape": [C, B, T, D],
                              "shape_k1e": [C, B_P1, op._t, op._decim, ell],
                              "shape_banks": {
                                  n: [C, B_BANK, bop._t, bop._decim]
                                  for n, (bop, _) in banks.items()},
                              "ms": times, "routes": taken, "card": smi}),
                  flush=True)
        del x, tail, p1_x, p1_args, bank_x, calls
        torch.cuda.empty_cache()
    return 0


def _bank_op(mode: str):
    """The AM or USB bank's fused op (chip_smoke.py's phase 4 banks):
    ``apps/chains.rx_stages(mode, 960e3, 960e3 / 8)`` on 64 channels of
    B_BANK samples."""
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.apps.chains import rx_stages

    rx = L.Pipeline(rx_stages(mode, 960e3, 960e3 / 8))
    rx.bind(L.StreamSpec(np.complex64, 960e3, B_BANK, channels=(C,)))
    return rx.stages[0]


def _p1_op():
    """P1's fused AFSK op (chip_smoke.py's phase P1): IQBaseBand(fc=24e3,
    order=48, out_rate=48e3) -> FMDemod -> FSKDetector(1200, 1200, 2200)
    at 192 kHz, fused into one AFSKFrontendFused."""
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.ops import FMDemod, FSKDetector, IQBaseBand

    p = L.Pipeline([IQBaseBand(fc=24e3, width=12.5e3, order=48,
                               out_rate=48e3, design="textbook"),
                    FMDemod(), FSKDetector(1200.0, 1200.0, 2200.0)])
    p.bind(L.StreamSpec(np.complex64, 192_000.0, B_P1, channels=(C,)))
    return p.stages[0]


if __name__ == "__main__":
    raise SystemExit(main())
