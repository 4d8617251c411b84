#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``libsdr_tpu_torch``).

    python chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Phases, each printed on
its own line; the first failure exits non-zero:

1. probe the card (name and power limit from nvidia-smi);
2. build the kernel from ``libsdr_tpu_torch/csrc`` and print the build time;
3. hold the kernel against its plain PyTorch version on the card across
   plane dtypes, strides, tap counts, channel counts, de-emphasis on/off and
   three carry-chained blocks, then at the main path's shapes;
4. drive the main path, ``Pipeline([IQBaseBand(order=64, decim=4), FMDemod(),
   FMDeemph()])`` on 64 channels x 2^24 complex samples, through bind,
   compile and the step; check that the fused op and its kernel ran and
   time carry-chained steps for float32 and bfloat16 planes;
5. demodulate a 1 kHz FM tone through ``run_pipeline`` on the card and check
   the FFT peak and its height over the median bin.

The last three lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

FS = 960_000.0
CHANNELS, BLOCK = 64, 1 << 24
# Kernel vs plain: both compute y in float32 with a different summation
# order (about T*eps relative on |y| ~ 1) and share the atan2 polynomial, so
# on a constant-envelope FM input the audio differs by ~1e-6 rad; 1e-4
# leaves a wide margin while catching any indexing or carry fault, which
# shows as errors of order 1.
ERR_BOUND = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def fm_signal(torch, gen, c, b, decim, device, t0=0):
    """(c, b) planar FM tones near FS/8 plus noise, generated on the card."""
    n = torch.arange(t0, t0 + b, dtype=torch.float64, device=device)
    xr = torch.empty((c, b), dtype=torch.float32, device=device)
    xi = torch.empty_like(xr)
    dev_hz = 0.15 * FS / decim
    for ch in range(c):
        fc = FS / 8 + (ch % 7 - 3) * 0.01 * FS / decim
        fm = 1000.0 + 100.0 * (ch % 5)
        ph = (2 * np.pi * fc / FS) * n - (dev_hz / fm) * torch.cos(
            (2 * np.pi * fm / FS) * n)
        ph = torch.remainder(ph, 2 * np.pi)
        xr[ch] = torch.cos(ph).float()
        xi[ch] = torch.sin(ph).float()
    xr += 0.05 * torch.randn(xr.shape, generator=gen, device=device)
    xi += 0.05 * torch.randn(xi.shape, generator=gen, device=device)
    return xr, xi


def fused_op(L, decim, order, c, b, plane_dtype=None):
    from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand
    from libsdr_tpu_torch.ops.fm_fused import FMBasebandFused

    width = min(FS / 4.8, 0.8 * FS / decim)
    rx = L.Pipeline([IQBaseBand(fc=FS / 8, width=width, order=order,
                                decim=decim, design="textbook"),
                     FMDemod(), FMDeemph()])
    rx.bind(L.StreamSpec(np.complex64, FS, b, channels=(c,),
                         plane_dtype=plane_dtype))
    check(len(rx.stages) == 1 and isinstance(rx.stages[0], FMBasebandFused),
          f"fusion did not install FMBasebandFused: {rx.stages}")
    return rx


def cuda_ms(torch, fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def run_pair(op, x, carry, deemph):
    """One block through the kernel and the plain version from one carry."""
    from libsdr_tpu_torch.ops.fir_fm import fir_fm_exact, fir_fm_exact_plain

    tail, prev = carry[0], carry[1]
    args = (x, op._taps(x.device), op._decim, tail, prev, op._rot, op._gain)
    kw = dict(deemph_ab=op._dab if deemph else None,
              dstate=carry[2] if deemph else None)
    return fir_fm_exact(*args, **kw), fir_fm_exact_plain(*args, **kw)


def next_carry(x, t, out, y_last, carry, deemph):
    tail = x[..., x.shape[-1] - (t - 1):].map(lambda v: v.clone())
    return (tail, y_last, out[..., -1] if deemph else carry[2])


def phase_parity(torch, L, gen):
    from libsdr_tpu_torch.core.cplx import Complex

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for d in (2, 4, 8):
            for t in (37, 67):
                for c in (3, 64):
                    for deemph in (True, False):
                        b = d * (5 * 2048 + 777)
                        op = fused_op(L, d, t - d + 1, c, b, dtype).stages[0]
                        check(op._t == t, f"tap count {op._t} != {t}")
                        carry = op.init_carry("cuda")
                        err = 0.0
                        # block 0 warms the carry up (the zero-history start
                        # is a transient of the test signal, not of the
                        # kernel); blocks 1-3 are compared, carry-chained
                        for k in range(4):
                            xr, xi = fm_signal(torch, gen, c, b, d, "cuda",
                                               k * b)
                            x = Complex(xr.to(dtype), xi.to(dtype))
                            (ok_, yk), (op_, yp) = run_pair(op, x, carry,
                                                            deemph)
                            torch.cuda.synchronize()
                            check(bool(torch.isfinite(ok_).all()),
                                  "kernel output not finite")
                            if k:
                                err = max(err,
                                          float((ok_ - op_).abs().max()),
                                          float((yk.re - yp.re).abs().max()),
                                          float((yk.im - yp.im).abs().max()))
                            else:
                                ok_, yk = op_, yp
                            carry = next_carry(x, t, ok_, yk, carry, deemph)
                        name = f"{str(dtype)[6:]} D={d} T={t} C={c} " \
                               f"deemph={int(deemph)}"
                        print(f"parity {name}: max_abs_err={err:.3e}")
                        check(err < ERR_BOUND,
                              f"kernel vs plain {name}: {err} >= {ERR_BOUND}")
                        worst[dtype] = max(worst.get(dtype, 0.0), err)
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this needs a card")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 probe: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    import libsdr_tpu_torch as L
    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.core import run_pipeline, stream_blocks
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand, siggen
    from libsdr_tpu_torch.ops.fir_fm import fir_fm_exact, fir_fm_exact_plain

    check("jax" not in sys.modules, "the port imported jax")
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.library()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s -> {lib_path}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    worst = phase_parity(torch, L, gen)
    print(f"phase 3 parity: max_abs_err f32={worst[torch.float32]:.3e} "
          f"bf16={worst[torch.bfloat16]:.3e} (bound {ERR_BOUND:g})")

    # Kernel vs plain at the main path's shapes, timed with CUDA events.
    rx = fused_op(L, 4, 64, CHANNELS, BLOCK)
    op = rx.stages[0]
    xr, xi = fm_signal(torch, gen, CHANNELS, BLOCK, 4, "cuda")
    x32 = Complex(xr, xi)
    main = {}
    for label, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16))):
        # warm carry: the plain version over the same block from rest
        _, (o0, y0) = run_pair(op, x, op.init_carry("cuda"), True)
        carry = next_carry(x, op._t, o0, y0, None, True)
        del o0
        (ok_, _), (op_, _) = run_pair(op, x, carry, True)
        err = float((ok_ - op_).abs().max())
        del op_
        check(err < ERR_BOUND, f"main-shape kernel vs plain {label}: {err}")
        args = (x, op._taps(x.device), 4, carry[0], carry[1], op._rot,
                op._gain)
        kw = dict(deemph_ab=op._dab, dstate=carry[2])
        ms = cuda_ms(torch, lambda: fir_fm_exact(*args, **kw), 5)
        plain_ms = cuda_ms(torch, lambda: fir_fm_exact_plain(*args, **kw), 2)
        main[label] = (err, ms, plain_ms)
        print(f"phase 3 main shape {label} ({CHANNELS}x{BLOCK}, T=67, D=4): "
              f"max_abs_err={err:.3e} kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms | {smi}")
    torch.cuda.synchronize()

    # Phase 4: the main path through the user's entry points.
    msps = {}
    fir_fm_exact.launches = 0
    for label, plane_dtype, x in (("f32", None, x32),
                                  ("bf16", torch.bfloat16,
                                   x32.to(torch.bfloat16))):
        rx = fused_op(L, 4, 64, CHANNELS, BLOCK, plane_dtype)
        step = rx.compile()
        carry = rx.init_carry("cuda")
        c, y = step(carry, x)
        torch.cuda.synchronize()
        check(tuple(y.shape) == (CHANNELS, BLOCK // 4), f"shape {y.shape}")
        check(bool(torch.isfinite(y).all()), "main path output not finite")
        iters, best = 10, float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            c = carry
            for _ in range(iters):
                c, y = step(c, x)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        msps[label] = CHANNELS * BLOCK * iters / best / 1e6
        print(f"phase 4 main path {label} planes: {msps[label]:.1f} Msps "
              f"({best / iters * 1e3:.2f} ms/step) | {smi}")
        del x
    launches = fir_fm_exact.launches
    print(f"phase 4 kernel launches on the main path: {launches}")
    check(launches == 2 * (1 + 3 * 10), f"launch count {launches}")
    del x32, xr, xi
    torch.cuda.empty_cache()

    # Phase 5: a real signal through run_pipeline on the card.
    audio = siggen.sine(FS, int(FS), 1000.0, amps=0.8)
    iq = siggen.fm_modulate(FS, audio, deviation=75_000.0, carrier=120_000.0)
    rx = L.Pipeline([IQBaseBand(fc=120_000, width=200_000, order=64,
                                out_rate=240_000, design="textbook"),
                     FMDemod(gain=FS / 4 / (2 * np.pi * 75_000.0)),
                     FMDeemph()])
    rx.bind(L.StreamSpec(np.complex64, FS, block_size=96_000))
    _, out = run_pipeline(rx, stream_blocks(iq, 96_000), device="cuda")
    seg = out[24_000:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1 / 240_000)
    k = int(np.argmax(spec))
    ratio = 20 * np.log10(spec[k] / np.median(spec))
    print(f"phase 5 tone: peak {freqs[k]:.1f} Hz, tone/median "
          f"{ratio:.1f} dB (need 1000 Hz, >= 60 dB)")
    check(abs(freqs[k] - 1000.0) < 1.0 and ratio >= 60, "tone check")

    err, ms, plain_ms = main["f32"]
    print(json.dumps({"kernels": [{
        "name": "fir_fm_exact", "route": "cuda",
        "source": "libsdr_tpu_torch/csrc/fir_fm_exact.cu",
        "replaces": "libsdr_tpu/ops/pallas_fir_mxu.py:777",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        sys.exit(1)
