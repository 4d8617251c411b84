"""Time the polyphase channelizer kernel (K4, ``ops/pfb.py::pfb_mxu``) on the
card at the wideband paths' shapes, and where its time goes.

    python libsdr_tpu_torch/tools/pfb_times.py [--reps 20]
        [--knockouts [VARIANT ...]] [--calls W1 W1-bf16 W2]

The calls, on random frames made on the card from a seed, P = 8 and the
channelizer's own folded taps:

* W1: the demod variant over 1024 channels x 65,536 frames, float32
  planes (the scanner's and WidebandFM's block);
* W1-bf16: the same with bfloat16 planes;
* W2: the channel variant over 256 channels x 12,288 frames, float32
  planes (the multimode bank's Channelizer).

Each is printed as one JSON line: ``ms``, CUDA events over ``--reps``
calls after one warm-up (the wrapper's host time included: at W2 the host
binds); ``kernel_ms``, the device time a call from the same calls replayed
in a CUDA graph (:func:`kernel_ms`), cycling through enough input sets that
the frames come from HBM (:func:`n_sets`); its bound (:func:`bound`) and
the share of the bound; the routes the launches took (where the package
counts them) and the card's name and power limit.  ``chip_smoke.py`` times
and bounds K4 with the same three functions.

``--knockouts`` times each call's ``kernel_ms`` on libraries built with
the measurement defines of ``csrc/pfb.cu``, each route without the MAC
(``SDR_PFB_KO_MAC``), the FFT's arithmetic (``SDR_PFB_KO_FFT``), the
epilogue (``SDR_PFB_KO_EPI``) and all three; the generic route at the
stream route's shapes from ``SDR_PFB_STREAM=0``.

The script imports ``libsdr_tpu_torch`` from the path, so one call can time
two trees in turns (say parent, change, change, parent) by running it with
``PYTHONPATH`` set to each tree's root.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
from unittest import mock

import numpy as np
import torch

CALLS = {  # name: (M, frames, plane dtype, demod)
    "W1": (1024, 65_536, torch.float32, True),
    "W1-bf16": (1024, 65_536, torch.bfloat16, True),
    "W2": (256, 12_288, torch.float32, False),
}
P = 8
HBM = 3.35e12          # bytes/s, H100 SXM
F32 = 67e12            # float32 operations/s outside the tensor cores
KO = ("SDR_PFB_KO_MAC=1", "SDR_PFB_KO_FFT=1", "SDR_PFB_KO_EPI=1")


def bound(b: int, m: int, p: int, isz: int, demod: bool) -> tuple:
    """(bound ms, "bytes" or "operations") of K4 over b samples: the planes
    (isz bytes an element) read once and the outputs written once (demod:
    the float32 audio; channel: two float32 planes) at the HBM rate;
    operations a sample, the MAC's 4 (P + 1), an FFT's 5 log2 M and the
    discriminator's ~50, at the float32 rate.  The taps, hist and
    twiddles (a few KB) are left out."""
    ops = b * (4 * (p + 1) + 5 * np.log2(m) + (50 if demod else 0))
    by = b * (2 * isz + (4 if demod else 8))
    t_b, t_o = by / HBM * 1e3, ops / F32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def n_sets(plane_bytes: int) -> int:
    """Input sets to cycle through, for a call that reads plane_bytes of
    planes, so that they make >= 200 MB: a call then finds its frames in
    HBM and not in the 50 MB L2 (a path's block comes from HBM)."""
    return max(1, -(-200_000_000 // plane_bytes))


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


def inputs(name: str, gen):
    """pfb_mxu's arguments and keywords for one of CALLS."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops.channelizer import (fold_commutator,
                                                  prototype_lowpass)
    from libsdr_tpu_torch.ops.pfb import pfb_twiddles

    m, f, dtype, demod = CALLS[name]

    def cn(*shape):
        return Complex(torch.randn(shape, generator=gen, device="cuda"),
                       torch.randn(shape, generator=gen, device="cuda"))
    taps = torch.from_numpy(fold_commutator(prototype_lowpass(m, P), m,
                                            P)).cuda()
    x = cn(f, m).to(dtype)
    kw = dict(twiddles=pfb_twiddles(m, "cuda"))  # as the paths' ops keep it
    if demod:
        kw.update(gain=1.7, prev=cn(1, m), demod=True)
    return (x, cn(P, m).to(dtype), taps, m), kw


def kernel_ms(fns, reps: int) -> float:
    """Device ms a call: ``reps`` calls, cycling through ``fns`` (one a
    set of inputs), captured in one CUDA graph, replayed three times
    between CUDA events; no host time in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            fns[r % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (3 * reps)


def input_sets(name: str, gen) -> list:
    """Sets of inputs for one of CALLS, :func:`n_sets` of them."""
    m, f, dtype, _ = CALLS[name]
    return [inputs(name, gen)
            for _ in range(n_sets(2 * m * f * dtype.itemsize))]


def calls(pfb_mxu, sets) -> list:
    return [(lambda a=a, kw=kw: pfb_mxu(*a, **kw)) for a, kw in sets]


def _routes(entry):
    return dict(getattr(entry, "routes", {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--calls", nargs="+", default=list(CALLS),
                    choices=list(CALLS))
    ap.add_argument("--knockouts", nargs="*", metavar="VARIANT",
                    help="time the variant builds (all when none is "
                    "named; e.g. 'stream' 'stream -mac')")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.ops import pfb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    for name in args.calls:
        sets = input_sets(name, gen)
        a, kw = sets[0]
        before = _routes(pfb.pfb_mxu)
        ms = _ms(lambda: pfb.pfb_mxu(*a, **kw), args.reps)
        k_ms = kernel_ms(calls(pfb.pfb_mxu, sets), args.reps)
        m, f, dtype, demod = CALLS[name]
        b_ms, b_by = bound(m * f, m, P, a[0].re.element_size(), demod)
        after = _routes(pfb.pfb_mxu)
        print(json.dumps({
            "call": name, "shape": [m, f], "planes": str(dtype)[6:],
            "variant": "demod" if demod else "channel", "ms": ms,
            "kernel_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share": b_ms / k_ms, "input_sets": len(sets),
            "routes": {k: n - before.get(k, 0) for k, n in after.items()
                       if n > before.get(k, 0)} or None,
            "card": smi}), flush=True)
        del a, kw, sets
        torch.cuda.empty_cache()
    variants = {}
    if args.knockouts is not None and hasattr(pfb, "ROUTES"):
        for route, base in (("stream", ()),
                            ("generic", ("SDR_PFB_STREAM=0",))):
            variants[route] = base
            for d in KO:
                variants[f"{route} -{d[11:-2].lower()}"] = base + (d,)
            variants[f"{route} -all"] = base + KO
        if args.knockouts:
            variants = {k: variants[k] for k in args.knockouts}
    if variants:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            list(pool.map(_build.build, variants.values()))
    for name in args.calls if variants else ():
        sets = input_sets(name, gen)
        times = {}
        for label, defines in variants.items():
            lib = _build.library(defines)
            with mock.patch.object(_build, "library", lambda *x: lib):
                times[label] = kernel_ms(calls(pfb.pfb_mxu, sets),
                                         args.reps)
        print(json.dumps({"variants": name, "kernel_ms": times,
                          "card": smi}), flush=True)
        del sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
