#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``libsdr_tpu_torch``).

    python chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Phases, each printed on
its own line; the first failure exits non-zero:

1. probe the card (name and power limit from nvidia-smi);
2. build the kernels from ``libsdr_tpu_torch/csrc`` (one nvcc per source,
   in parallel) and print the build time;
3. hold each kernel against its plain PyTorch version on the card: K1a (FM)
   across plane dtypes, strides, tap counts, channel counts, de-emphasis
   on/off and three carry-chained blocks, then at the main path's shapes;
   K1b (FIR), K1c (AM) and K1d (USB) across plane dtypes, strides 2 to 200
   (the rx app's 40, 80, 100 and 200 among them),
   tap counts, channel counts and AGC on/off, three carry-chained blocks,
   with the AGC's chunk count K > 1;
4. drive the paths through the user's entry points, bind, compile and the
   step, on 64 channels x ~2^24 complex samples in float32 and bfloat16
   planes, with each path's kernel launches counted from 0 and checked: the
   main path ``Pipeline([IQBaseBand(order=64, decim=4), FMDemod(),
   FMDeemph()])`` (K1a), the AM bank ``rx_stages("AM", 960e3)`` (K1c), the
   USB bank ``rx_stages("USB", 960e3)`` (K1d) and the DDC bank
   ``[IQBaseBand(order=64, decim=4)]`` (K1b); each bank's kernel is also
   timed against its plain version at the bank's shapes;
5. demodulate a 1 kHz FM tone through ``run_pipeline`` on the card and check
   the FFT peak and its height over the median bin;
6. run the apps on the card on synthesized WAV captures with the tone checks
   of tests/test_apps.py: ``rx`` in AM, USB and LSB at 2.4 MHz (strides 100
   and 200), in WFM, and in NFM switched live to AM; ``fm_rx``; ``wavplay``;
   and hold each WAV against the same app run with ``--device cpu``.

The last three lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

FS = 960_000.0
CHANNELS, BLOCK = 64, 1 << 24
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
# Kernel vs plain, FM: both compute y in float32 with a different summation
# order (about T*eps relative on |y| ~ 1) and share the atan2 polynomial, so
# on a constant-envelope FM input the audio differs by ~1e-6 rad; 1e-4
# leaves a wide margin while catching any indexing or carry fault, which
# shows as errors of order 1.
ERR_BOUND = 1e-4
# FIR, and AM/USB without the AGC, relative to the largest plain output:
# float32 sums of T products in two orders differ by ~sqrt(T)*2^-24
# (~1e-6 at T = 263); a fault shows as errors of order 1.
REL_BOUND = 1e-5
# AM/USB with the AGC, absolute on outputs of ~0.1-1, and relative on the
# exported envelope: the kernel runs the envelope recurrence as a chunked
# float32 scan, the plain version as frame matmuls, both with lam's powers
# at full precision (lam itself does not fit float32: 1 - lam is 2.1e-5 at
# 480 kHz), so they differ by float32 round-off over the chunk (~1e-6).
AGC_BOUND = 1e-4
PEAK_HZ = 10.0  # tone check: the peak within this of the tone
# An app's WAV on the card against the same app on the CPU (plain
# versions): the kernels' bound on the audio (AGC_BOUND, the wider of the
# two) plus one 16-bit step for the two roundings to the WAV's grid.
APP_BOUND = AGC_BOUND + 1 / 32768


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


def noise(torch, gen, c, b, dtype=None):
    """(c, b) complex Gaussian noise planes on the card."""
    from libsdr_tpu_torch.core.cplx import Complex

    x = Complex(torch.randn((c, b), generator=gen, device="cuda"),
                torch.randn((c, b), generator=gen, device="cuda"))
    return x if dtype is None else x.to(dtype)


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
    # (D, T): the staged kernel's strides, the rx app's WFM stride at
    # 960 kHz (D = 5, T = 68), and its NFM strides (order 32: T = 32 + D - 1)
    shapes = [(d, t) for d in (2, 4, 8) for t in (37, 67)] + [
        (5, 68), (40, 71), (100, 131)]
    # and at D = 16 tap counts at which the staged kernel holds one output
    # per thread (R = 1: its segment at R = 2 no longer fits in shared
    # memory), on 3 channels
    r1_taps = {torch.float32: 12001, torch.bfloat16: 14001}
    for dtype in (torch.float32, torch.bfloat16):
        for d, t in shapes + [(16, r1_taps[dtype])]:
            for c in ((3,) if t > 1000 else (3, 64)):
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
                        (ok_, yk), (op_, yp) = run_pair(op, x, carry, deemph)
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
                    print(f"parity K1a {name}: max_abs_err={err:.3e}")
                    check(err < ERR_BOUND,
                          f"kernel vs plain {name}: {err} >= {ERR_BOUND}")
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
    return worst


def mode_errs(torch, entry, plain, args, agc):
    """Kernel vs plain for one block of K1b/K1c/K1d: (errors by bound,
    the kernel's result, the plain result)."""
    got, ref = entry(*args), plain(*args)
    torch.cuda.synchronize()
    if entry.__name__ == "fir_exact":
        scale = float(torch.maximum(ref.re.abs().max(), ref.im.abs().max()))
        err = max(float((got.re - ref.re).abs().max()),
                  float((got.im - ref.im).abs().max())) / scale
        check(bool(torch.isfinite(got.re).all()), "fir_exact not finite")
        return {"rel": err}, got, ref
    (out, sd), (rout, rsd) = got, ref
    check(bool(torch.isfinite(out).all()), f"{entry.__name__} not finite")
    if not agc:
        return {"rel": float((out - rout).abs().max())
                / float(rout.abs().max())}, got, ref
    return {"agc": max(float((out - rout).abs().max()),
                       float(((sd - rsd) / rsd).abs().max()))}, got, ref


def phase_modes(torch, gen):
    """K1b, K1c and K1d against their plain versions: both plane dtypes,
    strides 2..200 (the rx app's among them) with T = order + D - 1 for the rx orders 32 and 64 and
    T = 37, channels 1, 3 and 64, AGC on and off, a warm block and three
    carry-chained blocks.  Returns the worst error of each entry."""
    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import fir_fm as F

    worst = {"fir_exact": 0.0, "fir_am_exact": 0.0, "fir_usb_exact": 0.0}
    bounds = {"rel": REL_BOUND, "agc": AGC_BOUND}
    lib = _build.library()
    n_out = 3 * 4096 + 333  # several AGC chunks, a ragged last one
    agc_k = lib.sdr_agc_chunks(64, n_out)
    print(f"phase 3 modes: AGC chunks K={agc_k} at C=64, {n_out} outputs "
          f"(K={lib.sdr_agc_chunks(1, n_out)} at C=1)")
    check(agc_k > 1, "the AGC parity cases need K > 1 chunks")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (2, 4, 40, 80, 100, 200):
            for t in sorted({37, 32 + d - 1, 64 + d - 1}):
                line = {}
                for c in (1, 3, 64):
                    b = d * n_out
                    taps = Complex(torch.randn(t, generator=gen,
                                               device="cuda") / t ** 0.5,
                                   torch.randn(t, generator=gen,
                                               device="cuda") / t ** 0.5)
                    th = 2 * np.pi * 1500.0 * d / FS * np.arange(n_out)
                    ramp = Complex(torch.tensor(np.cos(th), device="cuda",
                                                dtype=torch.float32),
                                   torch.tensor(-np.sin(th), device="cuda",
                                                dtype=torch.float32))
                    lam = float(np.exp(-1.0 / (0.1 * FS / d)))
                    for agc in (False, True):
                        ab = (lam, 1 - lam) if agc else None
                        gain = 0.125 if agc else 1.0
                        tail = noise(torch, gen, c, t - 1, dtype)
                        sd = {"am": torch.full((c,), 0.5, device="cuda"),
                              "usb": torch.full((c,), 0.5, device="cuda")}
                        ph = Complex(torch.tensor(0.6, device="cuda"),
                                     torch.tensor(0.8, device="cuda"))
                        for k in range(4):
                            x = noise(torch, gen, c, b, dtype)
                            cases = [
                                ("fir_exact", F.fir_exact_plain,
                                 (x, taps, d, tail), "-"),
                                ("fir_am_exact", F.fir_am_exact_plain,
                                 (x, taps, d, tail, gain, ab, sd["am"]),
                                 "am"),
                                ("fir_usb_exact", F.fir_usb_exact_plain,
                                 (x, taps, d, tail, ph, ramp, gain, ab,
                                  sd["usb"]), "usb")]
                            for name, plain, args, key in cases:
                                if name == "fir_exact" and agc:
                                    continue
                                errs, got, ref = mode_errs(
                                    torch, getattr(F, name), plain, args,
                                    agc)
                                if agc:  # carry the plain version's sd
                                    sd[key] = ref[1]
                                if k == 0:  # the warm block
                                    continue
                                for kind, e in errs.items():
                                    check(e < bounds[kind],
                                          f"{name} vs plain {dtype} D={d} "
                                          f"T={t} C={c} agc={int(agc)}: "
                                          f"{e} >= {bounds[kind]}")
                                    line[name] = max(line.get(name, 0.0), e)
                                    worst[name] = max(worst[name], e)
                            tail = x[..., b - (t - 1):].map(torch.clone)
                            nph = ph * complex(np.exp(-1j * th[1] * n_out))
                            mag = nph.abs()
                            ph = Complex(nph.re / mag, nph.im / mag)
                print(f"parity {str(dtype)[6:]} D={d} T={t} C=1,3,64 "
                      "agc=0,1: " + " ".join(f"{k}={v:.3e}"
                                             for k, v in line.items()))
    return worst


def drive_path(torch, L, label, stages_fn, b, x32, out_len, entries):
    """A path through its entry points: bind, compile, one step, then three
    runs of 10 carry-chained steps for float32 and bfloat16 planes.  Every
    kernel's launch count is set to 0 before and read after, and must be
    the path's own: 31 launches of its kernel per plane dtype.  Returns
    {plane: (Msps, ms per step)} and the launches of the path's kernel."""
    from libsdr_tpu_torch.ops import fir_fm as F

    for e in entries:
        e.launches = 0
    res = {}
    for plane, plane_dtype, x in (("f32", None, x32),
                                  ("bf16", torch.bfloat16,
                                   x32.to(torch.bfloat16))):
        rx = L.Pipeline(stages_fn())
        rx.bind(L.StreamSpec(np.complex64, FS, b, channels=(CHANNELS,),
                             plane_dtype=plane_dtype))
        step = rx.compile()
        carry = rx.init_carry("cuda")
        c, y = step(carry, x)
        torch.cuda.synchronize()
        check(tuple(y.shape) == (CHANNELS, out_len),
              f"{label}: output shape {tuple(y.shape)}")
        if hasattr(y, "re"):
            check(bool(torch.isfinite(y.re).all()
                       and torch.isfinite(y.im).all()),
                  f"{label}: output not finite")
        else:
            check(bool(torch.isfinite(y).all()), f"{label}: not finite")
        iters, best = 10, float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            c = carry
            for _ in range(iters):
                c, y = step(c, x)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        res[plane] = (CHANNELS * b * iters / best / 1e6, best / iters * 1e3)
        print(f"phase 4 {label} {plane} planes: {res[plane][0]:.1f} Msps "
              f"({res[plane][1]:.2f} ms/step)")
        del x
    counts = {e.__name__: e.launches for e in
              (F.fir_fm_exact, F.fir_exact, F.fir_am_exact,
               F.fir_usb_exact)}
    print(f"phase 4 {label} kernel launches: {counts}")
    own = entries[0].__name__
    check(counts[own] == 2 * (1 + 3 * 10), f"{label}: {own} launches "
          f"{counts[own]}")
    check(all(v == 0 for k, v in counts.items() if k != own),
          f"{label}: other kernels launched: {counts}")
    return res, counts[own]


def bank_kernel(torch, label, entry, plain, args_fn, agc, x32, bytes_fn,
                smi):
    """The bank's kernel against its plain version at the bank's shapes in
    float32 and bfloat16 planes, timed with CUDA events, beside the HBM
    bound (bytes_fn(itemsize) bytes per call).  Returns
    {plane: (err, ms, plain_ms)}."""
    res = {}
    for plane, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16))):
        args = args_fn(x)
        errs, _, _ = mode_errs(torch, entry, plain, args, agc)
        (kind, err), = errs.items()
        check(err < {"rel": REL_BOUND, "agc": AGC_BOUND}[kind],
              f"{label} {plane} kernel vs plain: {err}")
        ms = cuda_ms(torch, lambda: entry(*args), 5)
        plain_ms = cuda_ms(torch, lambda: plain(*args), 2)
        bound = bytes_fn(x.re.element_size()) / HBM_BYTES_PER_S * 1e3
        res[plane] = (err, ms, plain_ms)
        print(f"phase 4 {label} kernel {plane}: max_err={err:.3e} kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, HBM bound "
              f"{bound:.3f} ms | {smi}")
        del x, args
    torch.cuda.empty_cache()
    return res


def phase_banks(torch, L, gen, smi):
    """The AM, USB and DDC banks: kernel vs plain at the bank shapes, then
    the path through the pipeline with its launch count."""
    from libsdr_tpu_torch.apps.chains import rx_stages
    from libsdr_tpu_torch.ops import IQBaseBand
    from libsdr_tpu_torch.ops import fir_fm as F

    out = {}
    entries = [F.fir_am_exact, F.fir_usb_exact, F.fir_exact, F.fir_fm_exact]
    # One block for both banks: 2^24 rounded down to a multiple of their
    # strides, 40 (AM) and 80 (USB).
    b = 80 * (BLOCK // 80)
    for label, mode, entry, plain in (
            ("AM bank", "AM", F.fir_am_exact, F.fir_am_exact_plain),
            ("USB bank", "USB", F.fir_usb_exact, F.fir_usb_exact_plain)):
        rx = L.Pipeline(rx_stages(mode, FS, FS / 8))
        rx.bind(L.StreamSpec(np.complex64, FS, b, channels=(CHANNELS,)))
        op = rx.stages[0]
        d, n_out = op._decim, b // op._decim
        x32 = noise(torch, gen, CHANNELS, b)
        carry = op.init_carry("cuda")

        def agc_args(x, op=op, carry=carry, mode=mode):
            front = (x, op._taps("cuda"), op._decim, carry[0].to(x.re.dtype))
            if mode == "AM":
                return front + (op._gain, op._ab, carry[1])
            return front + (carry[1], op._on("ramp", op._ramp_np, "cuda"),
                            op._gain, op._ab, carry[2])

        # HBM bytes: the planes once, then per output the kernel's write of
        # sig and the AGC's read, read and write (16 bytes)
        res = bank_kernel(
            torch, label, entry, plain, agc_args, True, x32,
            lambda isz, n_out=n_out: CHANNELS * (2 * isz * b + 16 * n_out),
            smi)
        steps, launches = drive_path(
            torch, L, label, lambda mode=mode: rx_stages(mode, FS, FS / 8),
            b, x32, n_out, [entry] + [e for e in entries if e is not entry])
        out[entry.__name__] = (res, steps, launches, d, b)
        del x32
        torch.cuda.empty_cache()

    def ddc():
        return [IQBaseBand(fc=FS / 8, width=FS / 4.8, order=64, decim=4,
                           design="textbook")]

    rx = L.Pipeline(ddc())
    rx.bind(L.StreamSpec(np.complex64, FS, BLOCK, channels=(CHANNELS,)))
    fir = rx.stages[0]._inner.stages[0]
    x32 = noise(torch, gen, CHANNELS, BLOCK)

    def fir_args(x, fir=fir):
        from libsdr_tpu_torch.core import cplx
        t = fir.taps.shape[0]
        return (x, cplx.constant(fir.taps, torch.float32, "cuda"), 4,
                cplx.zeros((CHANNELS, t - 1), x.re.dtype, "cuda"))

    # HBM bytes: the planes once, two float32 planes out at a quarter rate
    res = bank_kernel(torch, "DDC bank", F.fir_exact, F.fir_exact_plain,
                      fir_args, False, x32,
                      lambda isz: CHANNELS * BLOCK * (2 * isz + 2), smi)
    steps, launches = drive_path(
        torch, L, "DDC bank", ddc, BLOCK, x32, BLOCK // 4,
        [F.fir_exact] + [e for e in entries if e is not F.fir_exact])
    out["fir_exact"] = (res, steps, launches, 4, BLOCK)
    del x32
    torch.cuda.empty_cache()
    return out


def peak_hz(audio, rate, lo=100.0):
    seg = np.asarray(audio, np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1 / rate)
    spec[freqs < lo] = 0
    return float(freqs[np.argmax(spec)])


def phase_apps(tmp: Path):
    """The apps on the card: rx (AM, USB, LSB at 2.4 MHz; WFM; NFM switched
    to AM), fm_rx and wavplay, with tone checks; each run's WAV is also held
    against the same app's run on the CPU (the plain versions), within
    APP_BOUND."""
    from libsdr_tpu_torch.apps import fm_rx, rx, wavplay
    from libsdr_tpu_torch.io import read_wav, write_wav, write_wav_iq
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops import siggen

    entries = (F.fir_fm_exact, F.fir_exact, F.fir_am_exact, F.fir_usb_exact)

    def run(main, args, expect):
        for e in entries:
            e.launches = 0
        out, ref = tmp / "out.wav", tmp / "ref.wav"
        main(args + ["-o", str(out), "--device", "cuda"])
        counts = {e.__name__: e.launches for e in entries}
        for name in expect:
            check(counts[name] > 0, f"{args}: {name} did not launch: "
                                    f"{counts}")
        main(args + ["-o", str(ref), "--device", "cpu"])
        (got, rate), (want, ref_rate) = read_wav(str(out)), read_wav(str(ref))
        check(rate == ref_rate and got.shape == want.shape,
              f"{args}: card and CPU WAVs differ in rate or length")
        err = float(np.abs(got - want).max())
        label = " ".join([main.__module__.rsplit(".", 1)[-1]] + [
            a for a in args if not a.startswith(str(tmp))])
        print(f"phase 6 {label}: card vs CPU max error "
              f"{err:.2e} ({err * 32768:.1f} LSB; bound {APP_BOUND:.2e})")
        check(err <= APP_BOUND, f"{args}: card vs CPU {err} > {APP_BOUND}")
        return (got, rate), counts

    fs = 2_400_000
    n = fs
    cap = tmp / "cap.wav"
    for mode, tone in (("AM", 800.0), ("USB", 700.0), ("LSB", 600.0)):
        if mode == "AM":
            base = (1.0 + siggen.sine(fs, n, tone, amps=0.5)) * \
                siggen.iq_carrier(fs, n, 5000.0)
            entry = "fir_am_exact"
        else:
            sign = 1.0 if mode == "USB" else -1.0
            base = siggen.iq_carrier(fs, n, 5000.0 + sign * tone)
            entry = "fir_usb_exact"
        write_wav_iq(str(cap), 0.5 * base, fs)
        (got, rate), counts = run(rx.main, [
            "--file", str(cap), "-m", mode, "-F", "5000",
            "--block-size", "240000"], [entry])
        pk = peak_hz(got[rate // 4:-rate // 4], rate)
        print(f"phase 6 rx {mode} @ {fs} Hz: {len(got)} samples @ {rate} "
              f"Hz, peak {pk:.1f} Hz (tone {tone:g}), launches {counts}")
        check(abs(pk - tone) < PEAK_HZ, f"rx {mode} tone")

    fs = 960_000
    audio = siggen.sine(fs, fs, 1000.0, amps=0.7)
    write_wav_iq(str(cap), siggen.fm_modulate(fs, audio, deviation=75e3,
                                              carrier=60e3), fs)
    for name, main, extra in (("rx WFM", rx.main, ["-m", "WFM"]),
                              ("fm_rx", fm_rx.main, [])):
        (got, rate), counts = run(main, ["--file", str(cap), "-F", "60000",
                                         "--block-size", "96000"] + extra,
                                  ["fir_fm_exact"])
        pk = peak_hz(got[4800:-4800], rate, 0.0)
        print(f"phase 6 {name}: {len(got)} samples @ {rate} Hz, peak "
              f"{pk:.1f} Hz (tone 1000), launches {counts}")
        check(abs(pk - 1000.0) < PEAK_HZ, f"{name} tone")

    t = np.arange(fs) / fs
    fm = np.exp(1j * 2 * np.pi * 4500.0 * np.cumsum(
        np.sin(2 * np.pi * 800.0 * t[: fs // 2])) / fs)
    am = 0.6 + 0.4 * np.sin(2 * np.pi * 1100.0 * t[fs // 2:])
    write_wav_iq(str(cap), 0.5 * np.concatenate([fm, am]).astype(
        np.complex64), fs)
    (got, rate), counts = run(rx.main, [
        "--file", str(cap), "-m", "NFM", "--switch", "0.5:AM",
        "--block-size", "96000"], ["fir_fm_exact", "fir_am_exact"])
    half = len(got) // 2
    pk1 = peak_hz(got[half // 4:half], rate)
    pk2 = peak_hz(got[half + half // 4:], rate)
    print(f"phase 6 rx NFM --switch 0.5:AM: peaks {pk1:.1f} Hz (tone 800) "
          f"and {pk2:.1f} Hz (tone 1100), launches {counts}")
    check(abs(pk1 - 800.0) < PEAK_HZ and abs(pk2 - 1100.0) < PEAK_HZ,
          "rx NFM->AM tones")

    src = tmp / "in.wav"
    tone = siggen.sine(8000, 8000, 440.0, amps=0.5)
    write_wav(str(src), tone, 8000)
    (got, rate), _ = run(wavplay.main, [str(src), "--gain", "0.5",
                                        "--block-size", "1000"], [])
    err = float(np.abs(got - 0.5 * tone).max())
    print(f"phase 6 wavplay: {len(got)} samples @ {rate} Hz, max error "
          f"{err:.2e} vs 0.5 x input")
    check(rate == 8000 and err < 2e-3, "wavplay output")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this needs a card")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
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
    print(f"phase 3 parity K1a: max_abs_err f32={worst[torch.float32]:.3e} "
          f"bf16={worst[torch.bfloat16]:.3e} (bound {ERR_BOUND:g})")
    mode_worst = phase_modes(torch, gen)
    print(f"phase 3 parity K1b/K1c/K1d: {mode_worst} (bounds: relative "
          f"{REL_BOUND:g}, AGC {AGC_BOUND:g})")

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

    # Phase 4: the main path through the user's entry points, then the
    # banks.
    from libsdr_tpu_torch.ops import fir_fm as F
    _, launches = drive_path(
        torch, L, "main path",
        lambda: [IQBaseBand(fc=FS / 8, width=FS / 4.8, order=64, decim=4,
                            design="textbook"), FMDemod(), FMDeemph()],
        BLOCK, x32, BLOCK // 4,
        [F.fir_fm_exact, F.fir_exact, F.fir_am_exact, F.fir_usb_exact])
    del x32, xr, xi
    torch.cuda.empty_cache()
    banks = phase_banks(torch, L, gen, smi)

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

    with tempfile.TemporaryDirectory() as tmp:
        phase_apps(Path(tmp))

    err, ms, plain_ms = main["f32"]
    record = [{
        "name": "fir_fm_exact", "route": "cuda",
        "source": "libsdr_tpu_torch/csrc/fir_fm_exact.cu",
        "replaces": "libsdr_tpu/ops/pallas_fir_mxu.py:777",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]
    # at the banks' strides K1b (D = 4) runs the staged kernel, K1c (D = 40)
    # and K1d (D = 80) the warp kernel and the AGC passes (agc.cu)
    for name, src in (("fir_exact", "fir_fm_exact.cu"),
                      ("fir_am_exact", "fir_warp.cu"),
                      ("fir_usb_exact", "fir_warp.cu")):
        res, _, n_launch, _, _ = banks[name]
        err, ms, plain_ms = res["f32"]
        record.append({
            "name": name, "route": "cuda",
            "source": f"libsdr_tpu_torch/csrc/{src}",
            "replaces": "libsdr_tpu/ops/pallas_fir_mxu.py:777",
            "launches": n_launch, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms})
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        sys.exit(1)
