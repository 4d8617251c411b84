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
   with the AGC's chunk count K > 1; K1e (AFSK) across strides 2-100 (the
   tensor-core, staged and warp kernels) and windows 2-128, and at D = 1,
   L = 2 also against the function in float64; K2/K3 (the bit-clock PLL) bit-exact across windows
   2-896, 1-1000 lanes, both bit mappings and widened bounds, blocks of
   1-2056 steps, every lanes-per-warp layout of the serial pass, 4,096 to
   65,536 lanes at the layout the lane cut gives them, and a block with no
   emit; the scanner's windowed compaction (``csrc/window_pack.cu``) bit
   for bit at the pager cell's shape, the scanner app's and the edges of
   its routes, timed at the cell's shape; K4 (the
   polyphase channelizer, ``csrc/pfb.cu``) against ``pfb_plain`` over M
   8-4096 (the FFT and, at M = 1000, the direct DFT), P 1/8/32, F 1-4096,
   C 1/3, both variants and plane dtypes, on both routes (the stream
   route at M 16-1024 with P = 8, each launch's route checked), and three
   chained blocks; K5 and
   K6 (the v1 FIR with any window start, ``ops/fir_mxu.py``, and its fm /
   am epilogues) against their plain versions over strides 2-200, taps
   17-263, window starts 0, 1, D-2, D-1, D and 2D+1, C 1/3/64, both plane
   dtypes, every output and the AGC's state, K5's launches on the
   tensor-core route also against its split emulation, and K5 at K1b's
   window start against K1b bit for bit (the same route at every shape);
   the tensor-core route (``csrc/fir_tc.cu``, K1a and K6 at strides 4-16,
   4-40 with bf16 planes; K1b, K1c, K1d and K5 at strides of their cuts,
   K1d's to D = 120 with bf16 planes) against the split emulation of its bf16 passes
   (``ops/fir_tc.py``) and, at 'high', the float32 plain versions, over
   its strides, both plane dtypes, 'high' and 'fast', de-emphasis on/off,
   chunks K > 1 and three carry-chained blocks, K6 in fm and am with and
   without the IIR, K1c and K1d with and without the AGC, K5 at every
   window form of its callers (starts in the tail, wrap 0 and 128*D); at
   the main path's shapes too (two channels against the emulation), K1a
   timed in both precisions;
4. drive the paths through the user's entry points, bind, compile and the
   step, on 64 channels x ~2^24 complex samples in float32 and bfloat16
   planes, with each path's kernel launches counted from 0 and checked,
   and each launch's route (tensor-core, staged or warp kernel): the
   main path ``Pipeline([IQBaseBand(order=64, decim=4), FMDemod(),
   FMDeemph()])`` (K1a, on the tensor-core route; then 'fast' against
   'high' through its chain, at least 70 dB SNR on the JAX gate's FM
   tone, and through the DDC, AM and USB banks' chains and F1's call, K1b,
   K1c, K1d and K5, at least an 8-bit source's 49.9 dB), the AM
   bank ``rx_stages("AM", 960e3)`` (K1c, on the tensor-core route), the
   USB bank ``rx_stages("USB", 960e3)`` (K1d, on the route of its cut) and
   the DDC bank ``[IQBaseBand(order=64, decim=4)]`` (K1b, on the
   tensor-core route; BANK_ROUTES); each bank's kernel is also
   timed against its plain version at the bank's shapes, beside its bound
   on its route; then the digital
   receive paths on message traffic (``libsdr_tpu_torch/tools/
   digital_signals.py``), each with its launches counted from 0, every
   message decoded, and its kernels held against their plain versions on
   the path's own inputs (K2 and K3 also timed there, in ns a step beside
   their chain's floor, with the layouts their launches took): P1, the AX.25 bank (64 ch x 2^21 at 192 kHz,
   K1e + K2, both plane dtypes); P2, the POCSAG bank (256 ch x 117,760 at
   240 kHz, 4 blocks, K1a + K2); P3, the multi-mode bank's PLL (3 x 64 ch
   x 2^18 at 24 kHz, one K3 launch a step); then the wideband paths on
   traffic from ``libsdr_tpu_torch/tools/wideband_signals.py``: W1, the
   whole-band pager scanner (``apps/scanner.scan_blocks``) at 1024
   channels x 2^26-sample blocks, 24.576 MHz, two chained blocks in f32 and
   bf16 planes, a page on 67 channels (some across the block edge) each
   decoded on its own channel, K4 (demod) + K2, with K4's two variants and
   K2 timed at its shapes; ``WidebandFM`` alone at the same width; W2, the
   multimode bank (``apps/multimode.scan_multimode``) at 256 channels x
   12,288 frames, 6.144 MHz, every active channel of every mode decoded,
   K4 (channel) + K3 + K1b + BPSK31's kernel a block, and the share of
   the scan spent in ``BPSK31.apply``; BPSK31's kernel held bit for bit
   against its plain version on the path's own call of block 2 (bits,
   valid flags and every carried leaf on all 64 channels) and timed there;
   then F1, the arbitrary-offset FIR bank: ``fir_overlap_save`` at
   offsets 0 and 1 over 64 ch x 2^24 with the DDC bank's T = 67, D = 4,
   one K5 launch a block on the tensor-core route (F1_ROUTES), K5 held
   against its plain version on the path's own call and against its split
   emulation on two of its channels, and timed beside the strided
   ``conv1d`` the port used before;
   and K6 at the same width (D = 4, window start 1) in fm with
   de-emphasis and am with the AGC; then slice 11: the streaming config
   (``tools/stream_times.py``: the main path on 128 ch x 2^19 and 2^16 at
   960 kHz, f32 and bf16 planes) through ``run_pipeline`` at K = 1, 2, 4
   and 8 blocks a dispatch (one CUDA graph a K blocks), each K bit for
   bit equal to K = 1 with K1a launched once a block; P2 and P1 through
   ``Pipeline.compile_chunked`` (whether they capture, and bit for bit
   their eager steps); checkpoint after block 4 of 8 and resume, bit for
   bit; the Q14 chain at 64 channels bit for bit against the CPU; the
   resamplers within 1e-6 of the CPU;
5. demodulate a 1 kHz FM tone through ``run_pipeline`` on the card and check
   the FFT peak and its height over the median bin;
6. run the apps on the card on synthesized WAV captures with the tone checks
   of tests/test_apps.py: ``rx`` in AM, USB and LSB at 2.4 MHz (strides 100
   and 200), in WFM, and in NFM switched live to AM; ``fm_rx``; ``wavplay``;
   and hold each WAV against the same app run with ``--device cpu``; then
   ``pocsag_rx``, ``ax25_rx`` (IQ and ``--audio``) and ``rtty_rx`` on
   captures from ``tx``, their messages against ``--device cpu``'s; then
   ``scanner``, ``multimode --map``, ``spectrum`` and ``psk31_rx`` against
   ``--device cpu`` (the same decodes, the same peaks);
7. slice 14, on traffic from a generator of its own (the native host
   runtime is built in phase 2): the pump-fed POCSAG bank at P2's shape
   (``tools/ingest_bank.py``: P2's traffic on the u8 wire in a file, the
   native file pump and ring, one upload of the raw u8 a step,
   ``u8_wire_to_planes`` on the card, K1a + K2, ``compact_device``, the
   native POCSAG state machine; bf16 and f32 planes; every page, the bits
   of the same chain fed the same bytes on the card, one launch of each a
   step, the native messages equal to ``POCSAGDecoder``'s); the live
   scanner at W1's shape on a loopback TCP wire paced to 24.576
   Msamples/s (no byte dropped, the file-fed decode of the same bytes,
   every page on its own channel, K4 and K2 launched); ``tx pocsag
   --wire`` into the live POCSAG receiver, ``scanner --live`` with and
   without ``--bf16`` against ``--raw``, and ``aprs_service --live``
   fed by ``tx afsk --wire``, its spot read by GET /spots;
8. slice 15, on W2's traffic from a generator of its own: the sharded
   multimode bank (``parallel/multimode.py``) at n == 1 through
   ``apps/multimode.scan_multimode_sharded`` (every active channel its own
   message, the decodes of ``scan_multimode`` with the pattern's map, K4 +
   K1b + K3 once a block, held against their plain versions on the path's
   own calls), its step bit for bit ``build_bank``'s, ``multimode --raw
   --bf16 --pattern`` on the band's u8 wire (K4's channel variant with bf16
   planes, held and timed on the path's call) and ``--live tcp-listen://
   --bf16 --pattern`` on the same bytes, and the step's ms a block;
9. slice 16: BPSK31's kernel (``csrc/psk31.cu``; on W2 in phases W2 and
   15) at psk31_rx's shape, bit for bit its plain version, timed there;
   ``compile_chunked`` at K = 8 of psk31_rx's pipeline and of W2's PSK31
   group on a draw of its own (both capture, bit for bit their eager
   steps).
10. slice 17: FMDeemphInt's kernel (``csrc/fixedpoint.cu``) on the Q14
   chain of phase slice 11 (once a block; held bit for bit against its
   plain version on the path's call of block 1 and timed there), and
   ``Channelizer`` outside K4's gate (M = 16384; P = 40) and inside it (M
   = 8192) on the card against the CPU, K4 launched inside the gate only.

Summary lines of slices 15-17 come before the last three lines.  The last
three lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  In the record every ``ms``
is CUDA events around the calls; K4's rows add ``device_ms`` (the same
calls replayed in a CUDA graph, no host time) and ``kernel_route`` (the
route of ``csrc/pfb.cu`` the path's launches took); the banks' rows (K1b,
K1c, K1d) and F1's (K5) give float32 planes' numbers under the common
keys and ``kernel_route``, and bfloat16 planes' under ``bf16_*``.
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
FLOPS_F32 = 67e12          # float32 outside the tensor cores, the same
FLOPS_BF16_TC = 989e12     # bf16 on the tensor cores, dense, the same
# K1e against its plain version: disc relative to each channel's largest
# |disc| (both compute y and the discriminator in float32 in two orders,
# ~1e-6 relative, and sum each window oldest first); the carried products,
# audio times a unit template, absolutely within the discriminator's bound
# ERR_BOUND (on noisy inputs their error relative to the largest product
# reached 1.7e-5).  A fault shows as errors of order 1.
AFSK_BOUND = 1e-4
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
# The route each bank's kernel takes, by plane dtype (csrc/fir_common.cuh::
# route_of at the banks' shapes): the AM bank's K1c (T = 71, D = 40), the
# USB bank's K1d (T = 143, D = 80), the DDC bank's K1b (T = 67, D = 4);
# and F1's K5 (T = 67, D = 4, mode fir's cut)
BANK_ROUTES = {"AM bank": {"f32": "tc", "bf16": "tc"},
               "USB bank": {"f32": "warp", "bf16": "tc"},
               "DDC bank": {"f32": "tc", "bf16": "tc"}}
F1_ROUTES = {"f32": "tc", "bf16": "tc"}
# The kernel source of each route
ROUTE_SOURCES = {"tc": "fir_tc.cu", "staged": "fir_fm_exact.cu",
                 "warp": "fir_warp.cu"}
# float32 operations an output of the banks' epilogues on the CUDA cores:
# K1b sums its passes' accumulators (~4); K1c |y| and the gain (~5) and the
# AGC's two passes over the outputs (~15); K1d adds the NCO rotation
EPILOGUE_OPS = {"fir_exact": 4, "fir_am_exact": 20, "fir_usb_exact": 30}
# The tensor-core route (csrc/fir_tc.cu: K1a, K6) against the split
# emulation of its arithmetic (ops/fir_tc.py, the same bf16 passes: 3 on
# float32 planes, 2 on bfloat16, 1 after set_mxu_precision('fast')): the
# same exact bf16 products summed in float32 in another order, ~1e-7 of
# |y| apart, so FM audio within TC_SPLIT_FM rad and y, |y| and the AGC's
# state within TC_SPLIT_REL of the largest; an indexing or carry fault
# shows as errors of order 1.  Against the float32 plain versions the
# route is held to the gates above: its three passes keep ~2^-16 of each
# product (bf16 planes: two, the samples being exact), ~1e-5 of |y|, so
# the FM audio stays within ERR_BOUND (1e-4 rad), K6 am within REL_BOUND
# (the JAX test allows 1e-4 of max |y| for this arithmetic) and the AGC
# within AGC_BOUND; 'fast' (one pass, ~2^-9 of each product) is held to
# the split emulation only, and to FAST_SNR_DB against 'high'.
TC_SPLIT_FM = 1e-5
TC_SPLIT_REL = 2e-6
# the JAX package's gate (tests/test_tpu_smoke.py, fast precision on chip)
FAST_SNR_DB = 70.0
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
    from libsdr_tpu_torch.ops.fir_fm import fir_fm_exact

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
                    routes = dict(fir_fm_exact.routes)
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
                    route = [r for r, n in fir_fm_exact.routes.items()
                             if n > routes[r]]
                    name = f"{str(dtype)[6:]} D={d} T={t} C={c} " \
                           f"deemph={int(deemph)}"
                    print(f"parity K1a {name}: max_abs_err={err:.3e} "
                          f"route {route}")
                    check(err < ERR_BOUND,
                          f"kernel vs plain {name}: {err} >= {ERR_BOUND}")
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
    return worst


def mode_errs(torch, entry, plain, args, agc):
    """Kernel vs plain for one block of K1b/K1c/K1d (or K5's y): (errors
    by bound, the kernel's result, the plain result)."""
    from libsdr_tpu_torch.core.cplx import Complex

    got, ref = entry(*args), plain(*args)
    torch.cuda.synchronize()
    if isinstance(got, Complex):
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


def drive_path(torch, L, label, stages_fn, b, x32, out_len, entries,
               route):
    """A path through its entry points: bind, compile, one step, then three
    runs of 10 carry-chained steps for float32 and bfloat16 planes.  Every
    kernel's launch count is set to 0 before and read after, and must be
    the path's own: 31 launches of its kernel per plane dtype, every one on
    ``route`` (the kernel that runs it: "tc", "staged" or "warp"; or
    {"f32": route, "bf16": route} where the plane dtypes' routes differ).
    Returns {plane: (Msps, ms per step)} and the launches of the path's
    kernel."""
    from libsdr_tpu_torch.ops import fir_fm as F

    set_counts_zero(entries)
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
    own = entries[0].__name__
    print(f"phase 4 {label} kernel launches: {counts}, {own} by route "
          f"{entries[0].routes}")
    check(counts[own] == 2 * (1 + 3 * 10), f"{label}: {own} launches "
          f"{counts[own]}")
    want = {}
    for plane in ("f32", "bf16"):
        r = route[plane] if isinstance(route, dict) else route
        want[r] = want.get(r, 0) + 1 + 3 * 10
    check({r: n for r, n in entries[0].routes.items() if n} == want,
          f"{label}: {own} launches by route {entries[0].routes}, not "
          f"{want}")
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

        # HBM bytes the function must move: the planes once, the audio
        # once (4 bytes an output; bank_bound)
        res = bank_kernel(
            torch, label, entry, plain, agc_args, True, x32,
            lambda isz, n_out=n_out: CHANNELS * (2 * isz * b + 4 * n_out),
            smi)
        steps, launches = drive_path(
            torch, L, label, lambda mode=mode: rx_stages(mode, FS, FS / 8),
            b, x32, n_out, [entry] + [e for e in entries if e is not entry],
            BANK_ROUTES[label])
        out[entry.__name__] = (res, steps, launches, d, b, op._t,
                               BANK_ROUTES[label])
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
    # The library call that computes the same function: one strided
    # conv1d of the stacked planes (its input stacked beforehand), in full
    # float32 as the plain version runs it.
    import torch.nn.functional as tf
    from libsdr_tpu_torch.ops.fir import full_f32
    taps = fir_args(x32)[1]
    t = taps.re.shape[0]
    zt = torch.zeros((CHANNELS, t - 1), device="cuda")   # the zero tail
    xb = torch.stack([torch.cat([zt, x32.re], -1),
                      torch.cat([zt, x32.im], -1)], dim=1)[..., 3:]
    w = torch.stack([torch.stack([taps.re, -taps.im]),
                     torch.stack([taps.im, taps.re])])
    with full_f32():
        lib_ms = cuda_ms(torch, lambda: tf.conv1d(xb, w, stride=4), 2)
    del xb
    print(f"phase 4 DDC bank library conv1d (stacked planes, full f32): "
          f"{lib_ms:.3f} ms | {smi}")
    steps, launches = drive_path(
        torch, L, "DDC bank", ddc, BLOCK, x32, BLOCK // 4,
        [F.fir_exact] + [e for e in entries if e is not F.fir_exact],
        BANK_ROUTES["DDC bank"])
    out["fir_exact"] = (res, steps, launches, 4, BLOCK, t,
                        BANK_ROUTES["DDC bank"])
    out["library_fir_exact"] = lib_ms
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
        set_counts_zero(entries)
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


def chain_floor(t):
    """ms that a PLL's loop-carried chain takes over t steps however many
    lanes run: 3 dependent instructions a step (add, compare, select) at ~4
    cycles each, at the H100's 1.98 GHz boost clock."""
    return t * 3 * 4 / 1.98e9 * 1e3


def bound(nbytes, ops):
    """The least time (ms) the card could take for a call and what sets it:
    the bytes it must move at the HBM rate, or its operations at the
    float32 (non-tensor-core) rate, H100 SXM published peaks."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / FLOPS_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bound_tc(nbytes, tc_ops, f32_ops):
    """bound() of a call on the tensor-core route: the bytes at the HBM
    rate, or its operations, the FIR's products on the tensor cores at the
    dense bf16 rate and the epilogue's on the CUDA cores at the float32
    rate (two units that run at once), whichever takes longest."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(tc_ops / FLOPS_BF16_TC, f32_ops / FLOPS_F32) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bank_bound(TC, name, route, isz, b, d, t):
    """The bound of a bank's kernel (K1b fir_exact, and K5 at F1's shape,
    the same function; K1c fir_am_exact, K1d fir_usb_exact) on its route
    for one block of CHANNELS x b samples of itemsize isz: (ms, what sets
    it, the bound line's text).  Bytes: what
    the function must move, the planes read once and its outputs written
    once (y's two float32 planes, K1b; the audio, 4 bytes an output, K1c
    and K1d).  Operations: on the tc route the FIR's 8T an output a bf16
    pass (3 for float32 planes, 2 for bfloat16) at the tensor cores' dense
    rate and the epilogue's (EPILOGUE_OPS) at the float32 rate; on the
    staged and warp kernels 8T + 20 float32 operations an output.  The
    text also gives the port's own bytes (K1c, K1d: the kernel writes sig,
    and the AGC passes of agc.cu read it twice and write the audio, 12
    bytes an output more) and, on the tc route, the tensor cores as run
    (the band's m16n8k16 tiles of the plan)."""
    n = b // d
    out_bytes = 8 * n if name == "fir_exact" else 4 * n
    agc_bytes = 0 if name == "fir_exact" else 12 * n
    nb = CHANNELS * (2 * isz * b + out_bytes)
    text = f"bytes {nb / HBM_BYTES_PER_S * 1e3:.3f} ms"
    if agc_bytes:
        text += (f" (the port's with the AGC's round trip of sig "
                 f"{(nb + CHANNELS * agc_bytes) / HBM_BYTES_PER_S * 1e3:.3f}"
                 f" ms)")
    if route != "tc":
        b_ms, b_by = bound(nb, CHANNELS * n * (8 * t + 20))
        return b_ms, b_by, text + (
            f"; float32 operations "
            f"{CHANNELS * n * (8 * t + 20) / FLOPS_F32 * 1e3:.3f} ms")
    passes = 3 if isz == 4 else 2
    plan = TC.tc_plan(t, d, isz, passes)
    dense = CHANNELS * n * passes * 8 * t
    epi = CHANNELS * n * EPILOGUE_OPS[name]
    run_ops = CHANNELS * n * TC.mma_ops(t, d, plan, passes)
    b_ms, b_by = bound_tc(nb, dense, epi)
    return b_ms, b_by, text + (
        f"; tensor cores {dense / FLOPS_BF16_TC * 1e3:.3f} ms dense "
        f"({passes} passes of 8T), {run_ops / FLOPS_BF16_TC * 1e3:.3f} ms as "
        f"run (S={plan.S}, {plan.F} frames a tile); "
        f"epilogue "
        f"{epi / FLOPS_F32 * 1e3:.3f} ms")


def phase_fast_snr(torch, x32, smi):
    """set_mxu_precision('fast') against 'high' through the main path's
    chain (IQBaseBand(order=64, decim=4) -> FMDemod -> FMDeemph, fused, on
    the tc route), the JAX package's gate
    (tests/test_tpu_smoke.py::test_fast_precision_mode_on_chip): its FM
    signal, a 900 Hz tone at 75 kHz deviation on a 120 kHz carrier at
    960 kHz, on 64 channels x 2^17, audio SNR at least FAST_SNR_DB on
    channel 0.  Also printed, not held: the same on the main path's own
    test signal x32 (FM tones with noise, where the audio has clicks at
    outputs with |y| near 0 that one pass can move).  Then the kernels
    without a discriminator to gain from, each on the tc route at both
    precisions, held to an 8-bit source's 49.9 dB as the JAX kernel
    describes 'fast' (pallas_fir_mxu.py::_make_mm): K1b through the DDC
    bank's chain on the FM signal, K1c through the AM bank's, K1d through
    the USB bank's (D = 80, in the plane dtype its cut puts on the tc
    route), K5 through F1's call (fir_overlap_save at offset 0, D = 4) on
    the FM signal (tools/fast_precision.py's cases, as the card tests run
    them).  Returns the gate's SNR and {kernel: SNR}."""
    from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.tools import fast_precision as FP

    n_ch, block = 64, 1 << 17
    tone = FP.fm_tone(n_ch, block)

    def snr_db(run, entry):
        try:
            return FP.fast_snr_db(run, entry)
        except AssertionError as e:
            raise SmokeFailure(str(e))

    def bb(**kw):
        return IQBaseBand(order=64, decim=4, design="textbook", **kw)

    gate = float(snr_db(FP.chain(lambda: [bb(fc=120_000, width=200_000),
                                          FMDemod(), FMDeemph()],
                                 tone, block), F.fir_fm_exact)[0])
    main = snr_db(FP.chain(lambda: [bb(fc=FS / 8, width=FS / 4.8), FMDemod(),
                                    FMDeemph()], x32, BLOCK),
                  F.fir_fm_exact)
    print(f"phase 4 'fast' vs 'high' audio SNR through the main path's "
          f"chain: {gate:.1f} dB on the JAX gate's tone (gate "
          f"{FAST_SNR_DB:g} dB); on the main path's noisy test signal "
          f"channel 0 {float(main[0]):.1f} dB, worst of {CHANNELS} "
          f"{float(main.min()):.1f} dB (not held) | {smi}")
    check(gate >= FAST_SNR_DB, f"'fast' SNR {gate} dB < {FAST_SNR_DB}")
    usb_dtype = (torch.float32 if BANK_ROUTES["USB bank"]["f32"] == "tc"
                 else torch.bfloat16)
    flat = {}
    for name, entry, run in FP.flat_cases(n_ch, usb_dtype, block):
        flat[name] = float(snr_db(run, entry)[0])
        check(flat[name] >= FP.FAST_8BIT_DB,
              f"'fast' {name} SNR {flat[name]} dB < {FP.FAST_8BIT_DB}")
    print("phase 4 'fast' vs 'high' SNR without a discriminator, channel 0: "
          + ", ".join(f"{k} {v:.1f} dB" for k, v in flat.items())
          + f" (K1d in {str(usb_dtype)[6:]} planes; gate "
          f"{FP.FAST_8BIT_DB:.1f} dB, an 8-bit source's) | {smi}")
    return gate, flat


def afsk_op(L, d, ell, c, b, plane_dtype=None):
    """The fused AFSK op at stride d with correlator window ell (the tone
    rate chosen so that int(audio_fs / baud) == ell)."""
    from libsdr_tpu_torch.ops import FMDemod, FSKDetector, IQBaseBand
    from libsdr_tpu_torch.ops.afsk_fused import AFSKFrontendFused

    audio_fs = FS / d
    rx = L.Pipeline([IQBaseBand(fc=FS / 8, width=min(FS / 4.8, 0.8 * FS / d),
                                order=48, decim=d, design="textbook"),
                     FMDemod(), FSKDetector(audio_fs / (ell + 0.5),
                                            0.05 * audio_fs,
                                            0.09 * audio_fs)])
    rx.bind(L.StreamSpec(np.complex64, FS, b, channels=(c,),
                         plane_dtype=plane_dtype))
    op = rx.stages[0]
    check(isinstance(op, AFSKFrontendFused) and op.corr_len == ell,
          f"fusion did not install AFSKFrontendFused: {rx.stages}")
    return op


def afsk_args(op, x, carry):
    tail, prev, n0, um, us = carry
    return (x, op._taps(x.re.device), op._decim, tail, prev, op._rot,
            op._gain, op._on("mark", op._tones[0], x.re.device),
            op._on("space", op._tones[1], x.re.device), n0, um, us)


def afsk_errs(torch, got, ref):
    """K1e against its plain version: (disc error over each channel's
    largest |disc|, absolute tail error, y_last error); the symbols must
    agree wherever |disc| is above the bound."""
    disc, y_last, um, us = got
    rdisc, ry, rum, rus = ref
    check(bool(torch.isfinite(disc).all()), "fir_afsk_exact not finite")
    scale = rdisc.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    err = float(((disc - rdisc).abs() / scale).max())
    clear = rdisc.abs() > AFSK_BOUND * scale
    check(bool(((disc > 0) == (rdisc > 0))[clear].all()),
          "fir_afsk_exact symbols differ where |disc| is above the bound")
    terr = max(float((a - r).abs().max())
               for t, rt in ((um, rum), (us, rus))
               for a, r in ((t.re, rt.re), (t.im, rt.im)))
    yerr = max(float((y_last.re - ry.re).abs().max()),
               float((y_last.im - ry.im).abs().max()))
    return err, terr, yerr


def afsk_case(torch, L, d, ell, c, dtype, g, f64=False):
    """K1e against its plain version at (D, L, C): n0 != 0 and nonzero
    carried products, a warm block and three carry-chained blocks of
    several chunks each, the signal from ``g``.  Returns the worst (disc,
    tails, y_last) errors and, with ``f64``, the kernel's and the plain
    version's largest disc error against the function in float64
    (``tools/afsk_accuracy.exact_f64``), over each channel's largest
    |disc|."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.tools.afsk_accuracy import exact_f64

    n_out = 3 * 4096 + 333
    b = d * n_out
    op = afsk_op(L, d, ell, c, b, dtype)
    tail, prev, _, _, _ = op.init_carry("cuda")
    carry = (tail, prev,
             torch.tensor(7 % ell, dtype=torch.int32, device="cuda"),
             noise(torch, g, c, ell - 1), noise(torch, g, c, ell - 1))
    errs, e64 = [0.0, 0.0, 0.0], [0.0, 0.0]
    for k in range(4):
        xr, xi = fm_signal(torch, g, c, b, d, "cuda", k * b)
        x = Complex(xr.to(dtype), xi.to(dtype))
        args = afsk_args(op, x, carry)
        ref = F.fir_afsk_exact_plain(*args)
        got = F.fir_afsk_exact(*args)
        torch.cuda.synchronize()
        if k:  # block 0 warms the discriminator up
            errs = [max(a, b_) for a, b_ in
                    zip(errs, afsk_errs(torch, got, ref))]
            if f64:
                d64 = exact_f64(*args)[2]
                scale = d64.abs().amax(dim=1, keepdim=True)
                e64 = [max(e, float(((v.double() - d64).abs()
                                     / scale).max()))
                       for e, v in zip(e64, (got[0], ref[0]))]
        carry = (x[..., b - (op._t - 1):].map(torch.clone), ref[1],
                 (carry[2] + n_out) % ell, ref[2], ref[3])
    return errs, e64


def phase_afsk_parity(torch, L, gen):
    """K1e against its plain version: both plane dtypes, strides 2-100 on
    all three routes (the tensor-core kernel at 2-16, 2-40 with bf16
    planes; the staged kernel above 16 up to 40 with f32 planes; the warp
    kernel above 40), windows 2-128, channels 1, 3 and 64 in turn, n0 != 0
    and nonzero carried products, a warm block and three carry-chained
    blocks of several chunks each; then D = 1, L = 2 (the staged kernel)
    on 1, 3 and 64 channels, with the kernel and the plain version each
    held against the function in float64."""
    from libsdr_tpu_torch.ops import fir_fm as F

    worst = 0.0
    before = dict(F.fir_afsk_exact.routes)
    # D = 24 (the staged kernel with float32 planes, the tc route with
    # bfloat16) and D = 1 draw from generators of their own, so that the
    # traffic of the phases after this one does not depend on them
    own = torch.Generator(device="cuda")
    own.manual_seed(24)
    sweep = [(d, ell, gen) for d in (2, 4, 5, 10, 40, 100)
             for ell in (2, 20, 40, 128)]
    sweep += [(24, ell, own) for ell in (2, 20, 40, 128)]
    for dtype in (torch.float32, torch.bfloat16):
        for i, (d, ell, g) in enumerate(sweep):
            c = (1, 3, 64)[(i // 4 + i % 4) % 3]
            errs, _ = afsk_case(torch, L, d, ell, c, dtype, g)
            name = f"{str(dtype)[6:]} D={d} L={ell} C={c}"
            print(f"parity K1e {name}: disc {errs[0]:.3e} (of max), "
                  f"tails {errs[1]:.3e} (abs), y_last {errs[2]:.3e}")
            check(errs[0] < AFSK_BOUND and errs[1] < ERR_BOUND
                  and errs[2] < ERR_BOUND,
                  f"fir_afsk_exact vs plain {name}: {errs}")
            worst = max(worst, errs[0])
    d24 = own.get_offset()
    one = torch.Generator(device="cuda")
    one.manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        for c in (1, 3, 64):
            errs, e64 = afsk_case(torch, L, 1, 2, c, dtype, one, f64=True)
            name = f"{str(dtype)[6:]} D=1 L=2 C={c}"
            print(f"parity K1e {name}: disc {errs[0]:.3e} (of max), "
                  f"tails {errs[1]:.3e} (abs), y_last {errs[2]:.3e}; "
                  f"against float64: kernel {e64[0]:.3e}, plain "
                  f"{e64[1]:.3e}")
            check(errs[0] < AFSK_BOUND and errs[1] < ERR_BOUND
                  and errs[2] < ERR_BOUND,
                  f"fir_afsk_exact vs plain {name}: {errs}")
            check(e64[0] < AFSK_BOUND and e64[1] < AFSK_BOUND,
                  f"fir_afsk_exact {name} against float64: {e64}")
            worst = max(worst, errs[0])
    taken = {r: n - before[r] for r, n in F.fir_afsk_exact.routes.items()}
    print(f"parity K1e launches by route: {taken}; the D = 24 cases drew "
          f"{d24} of their generator's Philox offset")
    check(all(taken.values()), f"K1e parity missed a route: {taken}")
    return worst


def pll_symbols(rng, m, t, run):
    """(m, t) uint8 symbols in runs of about ``run`` steps, with flips."""
    sym = np.repeat(rng.integers(0, 2, (m, t // run + 2)), run, axis=1)
    flips = rng.random((m, sym.shape[1])) < 0.02
    return (sym ^ flips)[:, :t].astype(np.uint8)


def bank_params(ells, trans):
    """Per-lane pll_bank parameters of BitStreams at windows ``ells`` (the
    BitStream's omega0 = 1/L at fs = L * baud)."""
    om0 = (1.0 / np.asarray(ells, np.float64))
    return dict(omega_min=(om0 * 0.995).astype(np.float32),
                omega_max=(om0 * 1.005).astype(np.float32),
                gain=np.full(len(ells), 0.0005, np.float32),
                transition=np.asarray(trans, np.int32),
                ell=np.asarray(ells, np.int32)), om0.astype(np.float32)


def phase_pll_parity(torch):
    """K2 and K3 bit-exact against their plain versions: windows 2-896,
    1-1000 lanes, both bit mappings, the real +-0.5% bounds and bounds
    widened to 0.5-2x omega0, chained blocks of 2048 or 2056 steps, then 1,
    31 and 33 (whole and part mask words); every lanes-per-warp layout of
    the serial pass, at the lane counts the rule maps to each (1,000 to
    34,000 lanes), and 4,096 to 65,536 lanes; a block with no emit and
    one with omega started above its bound; then a bank mixing three
    configurations at 192 and 17,001 lanes (1 and 32 lanes a warp).
    Returns the layouts the parity calls took."""
    from libsdr_tpu_torch.ops.pll import (LANES_PER_WARP, lanes_per_warp,
                                          pll, pll_bank, pll_bank_plain,
                                          pll_plain)

    rng = np.random.default_rng(11)
    taken = dict.fromkeys(LANES_PER_WARP, 0)

    def chain(m, ell, mode, lo, hi, ts, start=1.0):
        om0 = 1.0 / ell
        kw = dict(omega_min=om0 * lo, omega_max=om0 * hi, gain=0.0005,
                  transition=mode == "transition")
        st = [torch.zeros(m, ell - 1, dtype=torch.int32),
              torch.zeros(m, dtype=torch.int32), torch.zeros(m),
              torch.full((m,), om0 * start),
              torch.from_numpy(rng.integers(0, 1 << 16, m, dtype=np.int32))]
        sg = [v.cuda() for v in st]
        lanes = lanes_per_warp(m)
        emits = 0
        for t in ts:
            sym = torch.from_numpy(pll_symbols(rng, m, t, ell))
            n0 = pll.routes[lanes]
            got = pll(sym.cuda(), *sg, **kw)
            ref = pll_plain(sym, *st, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a.cpu(), r) for a, r in zip(got, ref))
                  and pll.routes[lanes] == n0 + 1,
                  f"pll vs plain L={ell} M={m} {mode} bounds {lo}-{hi} "
                  f"T={t} {lanes} lanes a warp: not bit-exact")
            emits += int((ref[0] >> 1).sum())
            st, sg = list(ref[1:]), list(got[1:])
        taken[lanes] += len(ts)
        return emits

    cases = 0
    for ell in (2, 20, 40, 264, 512, 896):
        for m in (1, 64, 256, 1000):
            for mode in ("normal", "transition"):
                for lo, hi, t in ((0.995, 1.005, 2048), (0.5, 2.0, 2056)):
                    chain(m, ell, mode, lo, hi, (t, t, 1, 31, 33))
                    cases += 1
    print(f"parity K2: {cases} cases (L 2-896, M 1-1000, both mappings, "
          "real and widened bounds, chained blocks of 2048/2056, 1, 31 and "
          "33 steps): bit-exact")
    layout_m = (1000, 2000, 4000, 8000, 16000, 34000)
    for m in layout_m:
        for mode in ("normal", "transition"):
            chain(m, 40, mode, 0.5, 2.0, (2056, 33))
    for m in (4096, 16384, 65536):
        chain(m, 20, "transition", 0.995, 1.005, (2056, 31))
    check(sorted({lanes_per_warp(m) for m in layout_m})
          == list(LANES_PER_WARP), "a layout without a parity case")
    check(chain(64, 40, "normal", 0.01, 2.0, (33,), start=0.02) == 0,
          "the no-emit block emitted")
    chain(64, 40, "normal", 0.995, 1.005, (96, 2056), start=3.0)
    print("parity K2 layouts: M (lanes a warp) "
          f"{', '.join(f'{m} ({lanes_per_warp(m)})' for m in layout_m + (4096, 16384, 65536))}, "
          "a block with no emit, omega started above its bound: "
          "bit-exact")
    for n in (64, 5667):
        cfg = [(20, 0, n), (20, 1, n), (264, 0, n)]
        ells = np.concatenate([np.full(k, e) for e, _, k in cfg])
        trans = np.concatenate([np.full(k, tr) for _, tr, k in cfg])
        kw, om0 = bank_params(ells, trans)
        m, r = len(ells), int(ells.max()) - 1
        st = [torch.zeros(m, r, dtype=torch.int32),
              torch.zeros(m, dtype=torch.int32), torch.zeros(m),
              torch.from_numpy(om0), torch.zeros(m, dtype=torch.int32)]
        sg = [v.cuda() for v in st]
        layout = lanes_per_warp(m)
        for t in (4096, 4104, 33):
            sym = torch.from_numpy(pll_symbols(rng, m, t, 20))
            got = pll_bank(sym.cuda(), *sg, **kw)
            ref = pll_bank_plain(sym, *st, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a.cpu(), b_) for a, b_ in zip(got, ref)),
                  f"pll_bank vs plain, M={m}, {layout} lanes a warp: not "
                  "bit-exact")
            st, sg = list(ref[1:]), list(got[1:])
            taken[layout] += 1
        print("parity K3: a bank of L=20 normal, L=20 transition and L=264 "
              f"normal lanes, M={m} ({layout} lanes a warp), 3 chained "
              "blocks: bit-exact")
    return taken


def phase_window_pack(torch, smi):
    """The scanner's windowed compaction kernel (``csrc/window_pack.cu``)
    bit for bit against its plain version at every shape of
    ``tools/window_pack_times.PARITY`` (the pager cell's, the scanner
    app's, T not a multiple of 16, every window of the vector route, a
    window of 3, sums past 255, an input off 16-byte alignment), each on
    the route its shape takes; then timed at the pager cell's shape (1024
    x 65,536, w = 16, the lane map) beside its bound and the plain version
    on the card."""
    from libsdr_tpu_torch.tools import window_pack_times as WP

    for label, equal, taken, want in WP.parity():
        check(equal and taken == want,
              f"window_pack {label}: {'bit-exact' if equal else 'DIFFERS'}"
              f", route {taken} (expected {want})")
    print(f"phase 3 parity window_pack: {len(WP.PARITY)} shapes bit-exact, "
          "each on its route")
    return WP.time_shape(*WP.TIMED[0], 50, smi)


def pll_layouts(entry):
    """The serial pass's layouts an entry's launches took since its counts
    were last set to 0: {lanes per warp: launches}."""
    return {k: n for k, n in entry.routes.items() if n}


class Capture:
    """Within ``with``, every call of ``module.name`` (a path's own calls of
    a kernel entry) goes to the real entry, its arguments kept in
    ``calls``; the real entry is back in place while it runs, so the launch
    count it keeps is its own."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self._call)
        return self

    def _call(self, *args, **kw):
        self.calls.append((args, kw))
        setattr(self.module, self.name, self.real)
        try:
            return self.real(*args, **kw)
        finally:
            setattr(self.module, self.name, self._call)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def counts_now(entries):
    return {e.__name__: e.launches for e in entries}


def set_counts_zero(entries):
    """Every entry's launch count to 0, and its counts by route."""
    for e in entries:
        e.launches = 0
        if hasattr(e, "routes"):
            e.routes = dict.fromkeys(e.routes, 0)


def phase_p1(torch, L, gen, smi):
    """P1, the AX.25/APRS bank: 64 channels x 2^21 samples at 192 kHz
    through [IQBaseBand(fc=24e3, order=48, out_rate=48e3), FMDemod,
    FSKDetector(1200, 1200, 2200), BitStream(1200, transition)], which
    fusion makes AFSKFrontendFused (K1e) + BitStream (K2).  Every channel
    carries FM-modulated AX.25 frames (tools/digital_signals.ax25_bank)
    and must decode all of them, in both plane dtypes.  Then K1e and K2
    are timed at the path's shapes against their plain versions on the
    same inputs, and K2 held bit-exact to its plain version: over the
    whole block with float32 planes, on an 8,192-step prefix with
    bfloat16 planes."""
    from libsdr_tpu_torch.core.ragged import Ragged, compact
    from libsdr_tpu_torch.decode import AX25Decoder
    from libsdr_tpu_torch.ops import (BitStream, FMDemod, FSKDetector,
                                      IQBaseBand)
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops.afsk_fused import AFSKFrontendFused
    from libsdr_tpu_torch.ops.pll import pll, pll_plain
    from libsdr_tpu_torch.tools.digital_signals import AX25_INFO, ax25_bank

    fs, c, b = 192_000.0, CHANNELS, 1 << 21
    entries = all_entries()
    res = {}
    for plane, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = ax25_bank(c, b, gen, fs).to(dtype)
        p = L.Pipeline([IQBaseBand(fc=24e3, width=12.5e3, order=48,
                                   out_rate=48e3, design="textbook"),
                        FMDemod(), FSKDetector(1200.0, 1200.0, 2200.0),
                        BitStream(1200.0, mode="transition")])
        p.bind(L.StreamSpec(np.complex64, fs, b, channels=(c,),
                            plane_dtype=dtype))
        check([type(s) for s in p.stages] == [AFSKFrontendFused, BitStream],
              f"P1 stages {p.stages}")
        op = p.stages[0]
        check(op._t == 51 and op._decim == 4 and op.corr_len == 40,
              f"P1 shape T={op._t} D={op._decim} L={op.corr_len}")
        step = p.compile()
        set_counts_zero(entries)
        carry = p.init_carry("cuda")
        carry, y = step(carry, x)
        torch.cuda.synchronize()
        check(tuple(y.data.shape) == (c, b // 4), "P1 output shape")
        bits = compact(Ragged(y.data.cpu().numpy(), y.valid.cpu().numpy()))
        decoded = 0
        want = [AX25_INFO + str(f).encode() for f in range(8)]
        for ch_bits in bits:
            dec = AX25Decoder()
            dec.process(ch_bits)
            decoded += sum(any(m.payload.endswith(w) for m in dec.messages)
                           for w in want)
        iters, best = 5, float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            cc = carry
            for _ in range(iters):
                cc, y = step(cc, x)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        counts = counts_now(entries)
        layouts = pll_layouts(pll)
        n_steps = 1 + 3 * iters
        check(counts["fir_afsk_exact"] == n_steps and counts["pll"] == n_steps
              and all(v == 0 for k, v in counts.items()
                      if k not in ("fir_afsk_exact", "pll")),
              f"P1 {plane} launches {counts}")
        k1e_routes = dict(F.fir_afsk_exact.routes)
        check(k1e_routes["tc"] == n_steps,
              f"P1 {plane} K1e off the tc route: {k1e_routes}")
        ms_step = best / iters * 1e3
        # The kernels at the path's shapes, timed with CUDA events, on the
        # second block's inputs (the carry after the first block).
        args = afsk_args(op, x, carry[0])
        got, ref = F.fir_afsk_exact(*args), F.fir_afsk_exact_plain(*args)
        torch.cuda.synchronize()
        e_afsk = afsk_errs(torch, got, ref)
        check(e_afsk[0] < AFSK_BOUND and e_afsk[1] < ERR_BOUND,
              f"P1 {plane} K1e vs plain {e_afsk}")
        sym = (ref[0] > 0).to(torch.uint8)
        del got, ref
        k1e_ms = cuda_ms(torch, lambda: F.fir_afsk_exact(*args), 5)
        k1e_plain = cuda_ms(torch, lambda: F.fir_afsk_exact_plain(*args), 2)
        bs = p.stages[1]
        st = carry[1]
        pargs = (st["signs"], st["sym_sum"], st["phase"], st["omega"],
                 st["last_bits"])
        kw = dict(omega_min=bs._omega_min, omega_max=bs._omega_max,
                  gain=bs._pll_gain, transition=True)
        # kernel and plain on the same symbols: the whole block (f32) or
        # an 8,192-step prefix (bf16: the plain loop takes ~10 s a block)
        held = sym if plane == "f32" else sym[:, :8192].contiguous()
        k2_ms = cuda_ms(torch, lambda: pll(sym, *pargs, **kw), 3)
        k2_held = cuda_ms(torch, lambda: pll(held, *pargs, **kw), 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = pll_plain(held.cpu(), *(v.cpu() for v in pargs), **kw)
        k2_plain = (time.perf_counter() - t0) * 1e3
        got = pll(held, *pargs, **kw)
        check(all(torch.equal(a.cpu(), r) for a, r in zip(got, ref)),
              f"P1 {plane} K2 vs plain on {held.shape[1]} steps")
        n_out = b // 4
        isz = x.re.element_size()
        # K1e on the tc route: on the tensor cores the FIR's 8T operations
        # an output in its bf16 passes (3 for float32 planes, 2 for
        # bfloat16); on the CUDA cores the discriminator's ~50 and ~30 for
        # the tone products, their prefix sums, the window sums from the
        # blocks' sums (csrc/fir_tc.cu::afsk_sums) and the squares
        passes = 3 if isz == 4 else 2
        k1e_bound = bound_tc(c * (2 * isz * b + 4 * n_out),
                             c * n_out * passes * 8 * op._t,
                             c * n_out * (50 + 30))
        k2_bound = bound(2 * c * n_out, 30 * c * n_out)
        res[plane] = dict(decoded=decoded, ms_step=ms_step, counts=counts,
                          k1e_routes=k1e_routes,
                          k1e=(e_afsk[0], k1e_ms, k1e_plain, k1e_bound),
                          k2=(k2_ms, k2_plain, k2_held, held.shape[1],
                              k2_bound))
        print(f"phase P1 {plane} planes ({c}x{b} @ 192 kHz, T={op._t}, D=4, "
              f"L=40): {ms_step:.2f} ms/step "
              f"({c * b / ms_step / 1e3:.1f} Msps), frames decoded "
              f"{decoded}/{8 * c}, launches {counts} | {smi}")
        print(f"phase P1 {plane} K1e: max_err={e_afsk[0]:.3e} (of max "
              f"|disc|) kernel {k1e_ms:.3f} ms (routes {k1e_routes}), "
              f"plain {k1e_plain:.3f} ms, bound {k1e_bound[0]:.3f} ms "
              f"({k1e_bound[1]})")
        print(f"phase P1 {plane} K2: kernel {k2_ms:.3f} ms ({n_out} steps x "
              f"{c} lanes, {k2_ms * 1e6 / n_out:.2f} ns a step, layouts "
              f"{layouts} lanes a warp: launches); on {held.shape[1]} steps "
              f"kernel {k2_held:.3f} ms, plain {k2_plain:.1f} ms "
              f"(bit-exact); bound {k2_bound[0]:.4f} ms ({k2_bound[1]}), "
              f"chain floor {chain_floor(n_out):.3f} ms")
        check(decoded == 8 * c, f"P1 {plane}: {decoded} of {8 * c} frames")
        del x, carry, y, args, sym, held
        torch.cuda.empty_cache()
    return res


def phase_p2(torch, L, gen, smi):
    """P2, the POCSAG decoder bank: 256 channels x 117,760 samples at
    240 kHz, 4 blocks, through apps/chains.pocsag_front_end (K1a without
    de-emphasis, ASKDetector, BitStream: K2), one page per channel at
    per-channel gains with noise (tools/digital_signals.pocsag_blocks);
    every channel must decode its page.  Then, on the second block and
    the carries the path left after the first, K1a is held against its
    plain version and K2 bit-exact against its plain version on the
    symbols of the path's own ASKDetector."""
    from libsdr_tpu_torch.apps.chains import pocsag_front_end
    from libsdr_tpu_torch.core.ragged import Ragged, compact
    from libsdr_tpu_torch.decode import pocsag_decode_bits
    from libsdr_tpu_torch.ops.pll import pll, pll_plain
    from libsdr_tpu_torch.tools.digital_signals import (POCSAG_ADDRESS,
                                                        pocsag_blocks)

    fs, c, blk, nb = 240e3, 256, 117_760, 4
    blocks = pocsag_blocks(c, blk, nb, gen, fs)
    fe = pocsag_front_end(fs, blk, channels=(c,))
    op, ask, bs = fe.stages
    check(type(op).__name__ == "FMBasebandFused" and op._decim == 10
          and op._t == 41 and bs.corr_len == 20, f"P2 stages {fe.stages}")
    step = fe.compile()
    entries = all_entries()
    best, outs = float("inf"), None
    for rep in range(2):
        set_counts_zero(entries)
        carry = fe.init_carry("cuda")
        ys, first = [], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in blocks:
            carry, y = step(carry, x)
            first = carry if first is None else first
            ys.append(y)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        counts = counts_now(entries)
        layouts = pll_layouts(pll)
        outs = ys
    from libsdr_tpu_torch.ops import fir_fm as F
    check(counts["fir_fm_exact"] == nb and counts["pll"] == nb
          and all(v == 0 for k, v in counts.items()
                  if k not in ("fir_fm_exact", "pll"))
          and F.fir_fm_exact.routes["tc"] == nb,
          f"P2 launches {counts}, K1a routes {F.fir_fm_exact.routes}")
    t0 = time.perf_counter()
    chan_bits = compact(Ragged(
        np.concatenate([y.data.cpu().numpy() for y in outs], -1),
        np.concatenate([y.valid.cpu().numpy() for y in outs], -1)))
    decoded = sum(1 for cb in chan_bits
                  if any(m.address == POCSAG_ADDRESS
                         for m in pocsag_decode_bits(cb)))
    host_s = time.perf_counter() - t0
    ms_step = best / nb * 1e3
    # The path's kernels against their plain versions on its own inputs.
    (audio, y_last), (ref, ry) = run_pair(op, blocks[1], first[0], False)
    torch.cuda.synchronize()
    k1a_err = max(float((audio - ref).abs().max()),
                  float((y_last.re - ry.re).abs().max()),
                  float((y_last.im - ry.im).abs().max()))
    _, sym = ask.apply(first[1], ref)
    st = first[2]
    pargs = (st["signs"], st["sym_sum"], st["phase"], st["omega"],
             st["last_bits"])
    kw = dict(omega_min=bs._omega_min, omega_max=bs._omega_max,
              gain=bs._pll_gain, transition=False)
    got = pll(sym, *pargs, **kw)
    ref = pll_plain(sym.cpu(), *(v.cpu() for v in pargs), **kw)
    k2_exact = all(torch.equal(a.cpu(), r) for a, r in zip(got, ref))
    k2_ms = cuda_ms(torch, lambda: pll(sym, *pargs, **kw), 5)
    n_sym = sym.shape[-1]
    print(f"phase P2 POCSAG bank ({c}x{blk} @ 240 kHz, T=41, D=10, L=20, "
          f"{nb} blocks): {ms_step:.2f} ms/step, pages decoded "
          f"{decoded}/{c} (host decode {host_s:.1f} s), launches {counts} "
          f"| {smi}")
    print(f"phase P2 kernels on block 2: K1a max_abs_err={k1a_err:.3e} "
          f"(bound {ERR_BOUND:g}); K2 on {tuple(sym.shape)} ASKDetector "
          f"symbols: {'bit-exact' if k2_exact else 'DIFFERS'}, kernel "
          f"{k2_ms:.3f} ms ({k2_ms * 1e6 / n_sym:.2f} ns a step, chain "
          f"floor {chain_floor(n_sym):.3f} ms), layouts {layouts} lanes a "
          "warp: launches")
    check(k1a_err < ERR_BOUND, f"P2 K1a vs plain: {k1a_err}")
    check(k2_exact, "P2 K2 vs plain: not bit-exact")
    check(decoded == c, f"P2: {decoded} of {c} pages decoded")
    return dict(ms_step=ms_step, decoded=decoded, counts=counts,
                k2_ms=k2_ms)


def mode_decoded(mode, bits):
    """Whether one channel of the mode bank decoded its mode's message."""
    from libsdr_tpu_torch.decode import (AX25Decoder, BaudotDecoder,
                                         pocsag_decode_bits)
    from libsdr_tpu_torch.tools import digital_signals as S

    if mode == "pocsag":
        return any(m.address == S.POCSAG_ADDRESS
                   for m in pocsag_decode_bits(bits))
    if mode == "ax25":
        dec = AX25Decoder()
        dec.process(bits)
        return any(m.payload.endswith(S.AX25_INFO) for m in dec.messages)
    return S.RTTY_TEXT in BaudotDecoder(stop_bits="1.5").process(bits)


def phase_p3(torch, L, gen, smi):
    """P3, the mode bank's PLL: apply_mode_chains over a 24 kHz complex bank
    of three 64-channel groups (pocsag FMDemod -> ASKDetector ->
    BitStream(normal); ax25 FMDemod -> FSKDetector -> BitStream
    (transition); rtty USBDemod -> FSKDetector(2 x 45.45) -> BitStream
    (normal)), 2^18 steps a block, each channel carrying its mode's
    messages (tools/digital_signals.mode_bank): one K3 launch per step for
    the three BitStreams, and every channel decodes its messages.  K3 is
    then timed, and held bit-exact to its plain version, on the arguments
    of the path's own pll_bank call (its detectors' symbols)."""
    from libsdr_tpu_torch.core.ragged import Ragged, compact
    from libsdr_tpu_torch.ops import bitsync
    from libsdr_tpu_torch.ops.pll import pll_bank, pll_bank_plain
    from libsdr_tpu_torch.tools.digital_signals import mode_bank, mode_chains

    fs, per, t = 24_000.0, 64, 1 << 18
    y, groups = mode_bank(per, t, gen, fs)
    sub, windows = mode_chains(per, t, fs)
    check(sorted(p.stages[-1].corr_len for p in sub.values()) ==
          [20, 20, 264], "P3 windows")
    carries = {m: p.init_carry("cuda") for m, p in sub.items()}
    entries = all_entries()
    # The first step, with the arguments of its one pll_bank call kept.
    with Capture(bitsync, "pll_bank") as k3:
        outs, carries = bitsync.apply_mode_chains(sub, carries, y, groups,
                                                 windows)
    calls = k3.calls
    torch.cuda.synchronize()
    check(len(calls) == 1, f"P3: {len(calls)} pll_bank calls in a step")
    t0 = time.perf_counter()
    decoded = {}
    for mode, out in outs.items():
        rows = compact(Ragged(out.data.cpu().numpy(),
                              out.valid.cpu().numpy()))
        decoded[mode] = sum(mode_decoded(mode, bits) for bits in rows)
    host_s = time.perf_counter() - t0
    set_counts_zero(entries)
    steps, t0 = 3, time.perf_counter()
    for _ in range(steps):
        outs, carries = bitsync.apply_mode_chains(sub, carries, y, groups,
                                                 windows)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / steps * 1e3
    counts = counts_now(entries)
    layouts = pll_layouts(pll_bank)
    check(counts["pll_bank"] == steps and all(
        v == 0 for k, v in counts.items() if k != "pll_bank"),
        f"P3 launches {counts}")
    check(all(outs[m].data.shape[-1] == t // windows[m] for m in sub),
          "P3 compacted output shapes")
    # K3 on the path's own call, kernel and plain on the whole block.
    args, kw = calls[0]
    k3_ms = cuda_ms(torch, lambda: pll_bank(*args, **kw), 3)
    t0 = time.perf_counter()
    ref = pll_bank_plain(*(a.cpu() for a in args), **kw)
    k3_plain = (time.perf_counter() - t0) * 1e3
    got = pll_bank(*args, **kw)
    check(all(torch.equal(a.cpu(), b_) for a, b_ in zip(got, ref)),
          "P3 K3 vs plain on the path's block: not bit-exact")
    m = args[0].shape[0]
    k3_bound = bound(2 * m * t, 30 * m * t)
    print(f"phase P3 mode bank (3 x {per} ch x {t} steps @ 24 kHz, L=20/20/"
          f"264): {ms_step:.2f} ms/step, launches {counts}; channels "
          f"decoded {decoded} of {per} each (host decode {host_s:.1f} s); "
          f"K3 kernel {k3_ms:.3f} ms ({k3_ms * 1e6 / t:.2f} ns a step, "
          f"layouts {layouts} lanes a warp: launches), plain "
          f"{k3_plain:.1f} ms on the same block (bit-exact), bound "
          f"{k3_bound[0]:.4f} ms ({k3_bound[1]}), chain floor "
          f"{chain_floor(t):.3f} ms | {smi}")
    check(all(v == per for v in decoded.values()),
          f"P3: channels decoded {decoded} of {per} each")
    return dict(ms_step=ms_step, counts=counts, decoded=decoded,
                k3=(k3_ms, k3_plain, k3_bound))


def phase_digital_apps(tmp: Path):
    """The digital apps on the card against the same app with --device cpu:
    pocsag_rx, ax25_rx from IQ and with --audio, rtty_rx, on captures from
    the tx app; the same decoded messages, and the path's kernels launched."""
    from libsdr_tpu_torch.apps import ax25_rx, pocsag_rx, rtty_rx, tx
    from libsdr_tpu_torch.io import read_wav, write_wav_iq
    from libsdr_tpu_torch.ops import siggen

    entries = all_entries()

    def run(label, main, args, expect, summary):
        set_counts_zero(entries)
        got = main(args + ["--device", "cuda"])
        counts = counts_now(entries)
        for name in expect:
            check(counts[name] > 0, f"{label}: {name} did not launch: "
                                    f"{counts}")
        ref = main(args + ["--device", "cpu"])
        check(summary(got) == summary(ref) and summary(got),
              f"{label}: card {summary(got)} != CPU {summary(ref)}")
        print(f"phase apps {label}: card == CPU: {summary(got)!r}, "
              f"launches {counts}")

    f = tx.main(["pocsag", "-o", str(tmp / "p.wav"), "--address", "777",
                 "--text", "LOOPBACK"])
    run("pocsag_rx", pocsag_rx.main, ["--file", f, "--block-size", "24000"],
        ["fir_fm_exact", "pll"],
        lambda ms: [(m.address, m.as_text()) for m in ms])
    f = tx.main(["afsk", "-o", str(tmp / "a.wav"), "--from-call", "K2TX"])
    run("ax25_rx --audio", ax25_rx.main,
        ["--file", f, "--audio", "--block-size", "12000"], ["pll"],
        lambda d: [str(m) for m in d.messages])
    audio, fs = read_wav(f)
    iq = siggen.fm_modulate(10 * fs, np.repeat(audio, 10), deviation=3e3)
    write_wav_iq(str(tmp / "aiq.wav"), 0.8 * iq, 10 * fs)
    run("ax25_rx IQ", ax25_rx.main,
        ["--file", str(tmp / "aiq.wav"), "--block-size", "24000"],
        ["fir_fm_exact", "pll"], lambda d: [str(m) for m in d.messages])
    f = tx.main(["rtty", "-o", str(tmp / "r.wav"), "--text", "RYRY TX LOOP",
                 "--fs", "8000"])
    run("rtty_rx", rtty_rx.main, ["--file", f, "--block-size", "8000"],
        ["pll"], lambda text: text.strip())


# K4 against its plain version: Y within 2e-5 of the largest |Y| (float32
# MAC and DFT in two orders: the kernel's FFT or direct sum against
# torch.fft; the JAX package's bound for its kernel against its XLA
# channelizer); the demod's error median < 5e-5 and 99th percentile < 1e-3
# rad (the angle of a near-zero z is amplified), the exports within 2e-5 of
# the largest |Y|.  A fault shows as errors of order 1.
PFB_REL, PFB_MEDIAN, PFB_P99 = 2e-5, 5e-5, 1e-3
W1_M, W1_BLOCK = 1024, 1 << 26
W1_FS = W1_M * 24_000.0
W2_M, W2_FRAMES = 256, 12_288
W2_FS = W2_M * 24_000.0


def pfb_inputs(torch, gen, c, f, m, p, dtype):
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops.channelizer import (fold_commutator,
                                                  prototype_lowpass)

    def cn(*shape):
        return Complex(torch.randn(shape, generator=gen, device="cuda"),
                       torch.randn(shape, generator=gen, device="cuda"))
    taps = torch.from_numpy(fold_commutator(prototype_lowpass(m, p), m,
                                            p)).cuda()
    return cn(c, f, m).to(dtype), cn(c, p, m).to(dtype), cn(c, 1, m), taps


def pfb_errs(torch, got, ref, demod, gain):
    """K4 against plain: (Y or the exports' error of max |Y|, the demod's
    median, 99th percentile and max error in rad)."""
    if not demod:
        check(bool(torch.isfinite(got.re).all()), "pfb_mxu not finite")
        scale = float(torch.maximum(ref.re.abs().max(), ref.im.abs().max()))
        return (max(float((got.re - ref.re).abs().max()),
                    float((got.im - ref.im).abs().max())) / scale,
                0.0, 0.0, 0.0)
    (a, yl, y0), (ra, ryl, ry0) = got, ref
    check(bool(torch.isfinite(a).all()), "pfb_mxu audio not finite")
    scale = max(float(v.abs().max()) for v in (ryl.re, ryl.im, ry0.re,
                                               ry0.im))
    ex = max(float((u - v).abs().max()) for u, v in (
        (yl.re, ryl.re), (yl.im, ryl.im), (y0.re, ry0.re), (y0.im, ry0.im)))
    half = np.pi * gain
    d = (torch.remainder(a - ra + half, 2 * half) - half).abs().flatten()
    sample = d[torch.randperm(d.numel(), device=d.device)[:1 << 24]] \
        if d.numel() > (1 << 24) else d
    return (ex / scale, float(d.median()),
            float(torch.quantile(sample.double(), 0.99)), float(d.max()))


def phase_k4_parity(torch, gen):
    """K4 against pfb_plain on the card: M 8-4096 (the FFT and the direct
    DFT at M = 1000), P 1/8/32, F 1, P-1, P, 33 and 4096, C 1 and 3, both
    variants and plane dtypes, over both routes (the stream route at M 16,
    64, 256 and 1024 with P = 8, the generic one for the rest; each launch
    checked against the route its shape gives); then three carry-chained
    blocks against one block.  Returns the worst errors and the cases by
    route."""
    from libsdr_tpu_torch.ops.pfb import (pfb_mxu, pfb_plain, reset_counts,
                                          stream_route)

    worst = dict(y=0.0, med=0.0, p99=0.0, max=0.0)
    cases = dict(generic=0, stream=0)
    reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        for m in (8, 16, 64, 128, 256, 384, 1000, 1024, 4096):
            line = dict(y=0.0, med=0.0, p99=0.0, max=0.0)
            for p in (1, 8, 32):
                for f in sorted({1, max(1, p - 1), p, 33, 4096}):
                    for c in (1, 3):
                        x, hist, prev, taps = pfb_inputs(torch, gen, c, f, m,
                                                         p, dtype)
                        for demod in (False, True):
                            args = (x, hist, taps, m, 1.7, prev, demod)
                            got, ref = pfb_mxu(*args), pfb_plain(*args)
                            torch.cuda.synchronize()
                            e = pfb_errs(torch, got, ref, demod, 1.7)
                            name = (f"{str(dtype)[6:]} M={m} P={p} F={f} "
                                    f"C={c} demod={int(demod)}")
                            check(e[0] < PFB_REL and e[1] < PFB_MEDIAN
                                  and e[2] < PFB_P99,
                                  f"pfb_mxu vs plain {name}: {e}")
                            for k, v in zip(("y", "med", "p99", "max"), e):
                                line[k] = max(line[k], v)
                            route = ("stream" if stream_route(m, p)
                                     else "generic")
                            cases[route] += 1
                            check(pfb_mxu.routes == cases,
                                  f"pfb_mxu {name}: routes {pfb_mxu.routes}"
                                  f", expected {cases}")
            print(f"parity K4 {str(dtype)[6:]} M={m} P=1,8,32 F=1..4096 "
                  f"C=1,3: Y/exports {line['y']:.3e} of max |Y|, demod "
                  f"median {line['med']:.2e} p99 {line['p99']:.2e} max "
                  f"{line['max']:.2e} rad")
            for k in worst:
                worst[k] = max(worst[k], line[k])
    # three chained blocks (hist = the last P frames, prev = y_last) give
    # what one block of all their frames gives
    for m in (16, 256, 384, 1024):
        x, hist, prev, taps = pfb_inputs(torch, gen, 2, 3 * 48, m, 8,
                                         torch.float32)
        one = pfb_mxu(x, hist, taps, m, prev=prev, demod=True)[0]
        outs, h, pv = [], hist, prev
        for i in range(3):
            blk = x[:, 48 * i:48 * (i + 1), :]
            a, pv, _ = pfb_mxu(blk, h, taps, m, prev=pv, demod=True)
            outs.append(a)
            h = blk[:, 40:, :]
        err = float((torch.cat(outs, 1) - one).abs().max())
        check(err < 1e-6, f"pfb_mxu chained vs one block M={m}: {err}")
    check(min(cases.values()) > 0, f"parity K4 misses a route: {cases}")
    print(f"parity K4: {sum(cases.values())} cases ({cases['stream']} on the "
          f"stream route, {cases['generic']} generic), worst Y/exports "
          f"{worst['y']:.3e} of "
          f"max |Y| (bound {PFB_REL:g}), demod median {worst['med']:.2e} "
          f"(bound {PFB_MEDIAN:g}) p99 {worst['p99']:.2e} (bound "
          f"{PFB_P99:g}) max {worst['max']:.2e} rad; 3 chained blocks == "
          "one block at M = 16, 256, 384, 1024")
    return worst, cases


def k4_at(torch, args, kw, label, smi):
    """K4 on one call's arguments (``pfb_mxu(*args, **kw)``) against its
    plain version, then K4 timed with CUDA events around the calls (the
    wrapper's host time in it), as the plain version and the library path
    (the MAC plus torch.fft on cuFFT: several calls) are, and on the device
    alone (``tools/pfb_times.py``'s kernel_ms: a CUDA graph cycling through
    copies of the frames that make >= 200 MB, so that they come from HBM
    and not from L2, as a path's block does); returns (err tuple, ms,
    plain_ms, library_ms, (bound_ms, bound_by), device_ms)."""
    from libsdr_tpu_torch.ops.pfb import (pfb_frames_plain, pfb_mxu,
                                          pfb_plain)
    from libsdr_tpu_torch.tools.pfb_times import bound as k4_bound
    from libsdr_tpu_torch.tools.pfb_times import kernel_ms, n_sets

    demod, gain = kw.get("demod", False), kw.get("gain", 1.0)
    got, ref = pfb_mxu(*args, **kw), pfb_plain(*args, **kw)
    torch.cuda.synchronize()
    e = pfb_errs(torch, got, ref, demod, gain)
    check(e[0] < PFB_REL and e[1] < PFB_MEDIAN and e[2] < PFB_P99,
          f"{label}: pfb_mxu vs plain {e}")
    del got, ref
    x, hist, taps, m = args[:4]
    n = n_sets(2 * x.re.numel() * x.re.element_size())
    sets = [args] + [(x.map(torch.clone),) + tuple(args[1:])
                     for _ in range(n - 1)]
    device_ms = kernel_ms([lambda a=a: pfb_mxu(*a, **kw) for a in sets], 10)
    ms = cuda_ms(torch, lambda: pfb_mxu(*args, **kw), 5)
    del sets
    plain_ms = cuda_ms(torch, lambda: pfb_plain(*args, **kw), 2)
    lib_ms = cuda_ms(torch, lambda: pfb_frames_plain(x, hist, taps), 2)
    b_ms, b_by = k4_bound(x.re.numel(), m, hist.re.shape[-2],
                          x.re.element_size(), demod)
    print(f"{label}: max_err {e[0]:.3e} of max |Y|"
          + (f", demod median {e[1]:.2e} p99 {e[2]:.2e} rad" if demod
             else "")
          + f"; kernel {ms:.4f} ms a call with the host's ({device_ms:.4f} "
          f"ms on the device), plain {plain_ms:.3f} ms, library "
          f"(MAC + torch.fft, several calls) {lib_ms:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by}) | {smi}")
    torch.cuda.empty_cache()
    return e, ms, plain_ms, lib_ms, (b_ms, b_by), device_ms


def phase_w1(torch, gen, smi):
    """W1, the whole-band pager scanner at 1024 channels x 2^26-sample
    blocks (24.576 MHz), float32 and bfloat16 planes, two chained blocks
    through apps/scanner.scan_blocks (build_scanner_step: WidebandFM's K4
    demod variant, ASKDetector, BitStream's K2, windowed compaction, POCSAG
    decoding of every channel).  Pages on 67 channels
    (tools/wideband_signals.pager_band: band-limited channels, each page
    with its channel's address), some across the block edge; every page
    must decode on its own channel and its address on no other.  Then K4
    and K2 are held against their plain versions on the arguments of the
    path's own calls for the second block (K2 bit-exact over the whole
    block) and timed; K4's channel variant is timed on the same frames (the
    bound's reference case; W2 runs it)."""
    from libsdr_tpu_torch.apps.scanner import scan_blocks
    from libsdr_tpu_torch.core.ragged import min_valid_gap, pick_window
    from libsdr_tpu_torch.ops import bitsync, wideband_rx
    from libsdr_tpu_torch.ops.pfb import pfb_mxu
    from libsdr_tpu_torch.ops.pll import pll, pll_plain
    from libsdr_tpu_torch.parallel.wideband import build_scanner_step
    from libsdr_tpu_torch.tools import wideband_signals as W

    m, b = W1_M, W1_BLOCK
    entries = all_entries()
    print(f"phase W1 traffic from the run's generator at Philox offset "
          f"{gen.get_offset()}")
    plan = W.pager_plan(m, 2 * b // m)
    edge = W.crosses_edge(plan, b // m)
    res = {}
    for plane, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        blocks, pages = W.pager_band(m, 2, b, "cuda", gen=gen)
        if dtype is not None:
            blocks = [x.to(dtype) for x in blocks]
        torch.cuda.synchronize()
        set_counts_zero(entries)
        t0 = time.perf_counter()
        with Capture(wideband_rx, "pfb_mxu") as k4, \
                Capture(bitsync, "pll") as k2:
            found = scan_blocks(blocks, W1_FS, m, b, plane_dtype=dtype,
                                device="cuda")
        scan_s = time.perf_counter() - t0
        counts = counts_now(entries)
        layouts = pll_layouts(pll)
        k4_routes = dict(pfb_mxu.routes)
        on_path = ("pfb_mxu", "pll", "window_pack")
        check(all(counts[k] == 2 for k in on_path) and all(
            v == 0 for k, v in counts.items() if k not in on_path),
            f"W1 {plane} launches {counts}")
        check(k4_routes == {"generic": 0, "stream": 2},
              f"W1 {plane}: K4 routes {k4_routes}")
        where = {ch: sorted(c for c, msgs in found.items()
                            if any(x.address == addr for x in msgs))
                 for ch, (addr, _) in pages.items()}
        ok = [ch for ch, (addr, text) in pages.items()
              if where[ch] == [ch] and any(
                  x.address == addr and x.as_text().startswith(text)
                  for x in found[ch])]
        astray = {ch: w for ch, w in where.items() if w != [ch]}
        addrs = {addr for addr, _ in pages.values()}
        other = sum(1 for msgs in found.values() for x in msgs
                    if x.address not in addrs)
        # the device steps alone: best of 3 runs of the 2 chained blocks
        gap = min_valid_gap((1200.0 / 24_000.0) * 1.005)
        step, init, place = build_scanner_step(
            m, b, W1_FS, compact_window=pick_window(gap, b // m),
            plane_dtype=dtype, packed=True, device="cuda")
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = init()
            for x in blocks:
                c, y = step(c, place(x))
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        ms_block = best / 2 * 1e3
        # K4 and K2 on the path's own calls for the second block
        check(len(k4.calls) == 2 and len(k2.calls) == 2,
              f"W1 {plane}: {len(k4.calls)} pfb_mxu, {len(k2.calls)} pll "
              "calls")
        (a4, kw4), (a2, kw2) = k4.calls[1], k2.calls[1]
        frames = f"{m} x {b // m:,} frames"
        k4d = k4_at(torch, a4, kw4, f"phase W1 {plane} K4 demod ({frames})",
                    smi)
        k4c = k4_at(torch, a4[:4], {},
                    f"phase W1 {plane} K4 channel ({frames}, the path's "
                    "frames)", smi)
        k2_ms = cuda_ms(torch, lambda: pll(*a2, **kw2), 3)
        t0 = time.perf_counter()
        ref = pll_plain(*(v.cpu() for v in a2), **kw2)
        k2_plain = (time.perf_counter() - t0) * 1e3
        got = pll(*a2, **kw2)
        k2_exact = all(torch.equal(u.cpu(), r) for u, r in zip(got, ref))
        n_steps = a2[0].numel()
        t2 = a2[0].shape[-1]
        k2_bound = bound(2 * n_steps, 30 * n_steps)
        print(f"phase W1 {plane} planes ({m} ch x {b:,} @ "
              f"{W1_FS / 1e6:g} MHz, 2 blocks): {ms_block:.2f} ms/block "
              f"({b / ms_block / 1e3:.1f} "
              f"Msamples/s), scan_blocks with host decode {scan_s:.1f} s; "
              f"pages decoded {len(ok)}/{len(pages)} on their own channel "
              f"and nowhere else ({len(edge)} across the block edge; "
              f"{other} decodes of other addresses); launches {counts}, "
              f"K4 by route {k4_routes} | {smi}")
        print(f"phase W1 {plane} K2 on the path's {tuple(a2[0].shape)} "
              f"ASKDetector symbols: kernel {k2_ms:.3f} ms "
              f"({k2_ms * 1e6 / t2:.2f} ns a step, layouts {layouts} lanes "
              f"a warp: launches), plain {k2_plain:.1f} ms, "
              f"{'bit-exact' if k2_exact else 'DIFFERS'}; bound "
              f"{k2_bound[0]:.4f} ms ({k2_bound[1]}), chain floor "
              f"{chain_floor(t2):.3f} ms | {smi}")
        check(k2_exact, f"W1 {plane} K2 vs plain: not bit-exact")
        check(len(ok) == len(pages),
              f"W1 {plane}: pages lost on "
              f"{sorted(set(pages) - set(ok) - set(astray))}, decoded off "
              f"their channel {astray}")
        res[plane] = dict(ms_block=ms_block, counts=counts, k4=k4d, k4c=k4c,
                          k4_routes=k4_routes, k2_ms=k2_ms,
                          decoded=len(ok), sent=len(pages))
        del blocks, c, y, k4, k2, a4, a2, got, ref
        torch.cuda.empty_cache()
    return res


def phase_wfm(torch, gen, smi):
    """WidebandFM alone at 1024 x 2^26, lane layout, float32 and bfloat16
    planes: best of 3 runs of 5 carry-chained steps, one K4 launch each."""
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.ops import WidebandFM
    from libsdr_tpu_torch.ops.pfb import pfb_mxu, reset_counts

    m, b = W1_M, W1_BLOCK
    x32 = noise(torch, gen, 1, b)
    x32 = x32.reshape(b)
    res = {}
    for plane, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        op = WidebandFM(m, 8, layout="lane")
        op.bind(L.StreamSpec(np.complex64, W1_FS, b, plane_dtype=dtype))
        x = x32 if dtype is None else x32.to(dtype)
        carry = op.init_carry("cuda")
        reset_counts()
        carry, y = op.apply(carry, x)
        torch.cuda.synchronize()
        check(tuple(y.shape) == (b // m, m) and bool(torch.isfinite(y).all()),
              f"WidebandFM {plane} output")
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            c = carry
            for _ in range(5):
                c, y = op.apply(c, x)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        check(pfb_mxu.launches == 16, f"WidebandFM launches "
                                      f"{pfb_mxu.launches}")
        check(pfb_mxu.routes["stream"] == 16,
              f"WidebandFM K4 routes {pfb_mxu.routes}")
        res[plane] = best / 5 * 1e3
        print(f"phase WidebandFM {plane} planes ({m} x {b:,}, lane layout): "
              f"{res[plane]:.3f} ms/step ({b / res[plane] / 1e3:.1f} "
              f"Msamples/s), 16 K4 launches, all on the stream route | "
              f"{smi}")
        del x, carry, c, y
    del x32
    torch.cuda.empty_cache()
    return res


def _named_leaves(carry):
    """[(name, tensor)] of a BPSK31 carry, planes as name.re / name.im."""
    out = []
    for k, v in carry.items():
        if hasattr(v, "re"):
            out += [(f"{k}.re", v.re), (f"{k}.im", v.im)]
        else:
            out.append((k, v))
    return out


def phase_w2(torch, gen, smi):
    """W2, the multimode bank at 256 channels x 12,288 frames (6.144 MHz),
    channel ch in mode ("pocsag", "ax25", "rtty", "psk31")[ch % 4], through
    apps/multimode.scan_multimode (Channelizer: K4's channel variant, then
    apply_mode_chains: K3 for the three BitStreams, the PSK31 group's
    IQBaseBand: K1b, and BPSK31: csrc/psk31.cu).  Traffic on every fifth
    channel, 51 channels of all four modes (tools/wideband_signals.
    mixed_band: band-limited channels, each message with its channel's
    number); every active channel must decode its own message, and no
    channel another's.  Then K4, K1b, K3 and BPSK31's kernel are held
    against their plain versions on the arguments of the path's own calls
    for the second block (K3 and BPSK31 bit-exact: BPSK31's bits, valid
    flags and every carried leaf on all 64 channels, the active ones and
    the noise channels counted apart), K4 and BPSK31 timed there."""
    from libsdr_tpu_torch.apps import multimode
    from libsdr_tpu_torch.ops import bitsync
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops import psk31 as PS
    from libsdr_tpu_torch.ops.pfb import pfb_mxu
    from libsdr_tpu_torch.ops.pll import pll_bank, pll_bank_plain
    from libsdr_tpu_torch.ops.psk31 import BPSK31
    from libsdr_tpu_torch.parallel import wideband as pwb
    from libsdr_tpu_torch.tools import psk31_times as PT
    from libsdr_tpu_torch.tools import wideband_signals as W
    from libsdr_tpu_torch.tools.pfb_times import kernel_ms

    m, b = W2_M, W2_M * W2_FRAMES
    modes = multimode.MODES
    mode_map = {ch: modes[ch % 4] for ch in range(m)}
    active = {ch: mode_map[ch] for ch in range(0, m - 5, 5)}
    x = W.mixed_band(active, m, "cuda", gen=gen, sigma=0.02)
    n_blocks = -(-x.shape[-1] // b)
    pad = n_blocks * b - x.shape[-1]
    x = x.map(lambda a: torch.nn.functional.pad(a, (0, pad)))
    blocks = [x[i * b:(i + 1) * b] for i in range(n_blocks)]
    entries = all_entries()
    spent = [0.0]
    apply = BPSK31.apply

    def timed(self, carry, xin):
        t0 = time.perf_counter()
        out = apply(self, carry, xin)
        spent[0] += time.perf_counter() - t0
        return out
    BPSK31.apply = timed
    try:
        set_counts_zero(entries)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Capture(pwb, "pfb_mxu") as k4, Capture(F, "fir_exact") as k1b, \
                Capture(bitsync, "pll_bank") as k3, \
                Capture(PS, "bpsk31_scan") as k31:
            found = multimode.scan_multimode(
                None, W2_FS, m, mode_map, block=b,
                blocks=lambda blk: iter(blocks), device="cuda")
        total = time.perf_counter() - t0
        counts = counts_now(entries)
        layouts = pll_layouts(pll_bank)
        k4_routes = dict(pfb_mxu.routes)
    finally:
        BPSK31.apply = apply
    path = ("pfb_mxu", "pll_bank", "fir_exact", "bpsk31_scan")
    check(all(counts[k] == n_blocks for k in path)
          and all(v == 0 for k, v in counts.items() if k not in path),
          f"W2 launches {counts}")
    check(k4_routes == {"generic": 0, "stream": n_blocks},
          f"W2: K4 routes {k4_routes}")
    marks = {ch: W.mixed_marks(mo, dec) for ch, (mo, dec) in found.items()}
    ok = {mo: sum(1 for ch, v in active.items() if v == mo
                  and found.get(ch, (None,))[0] == mo and marks[ch] == {ch})
          for mo in modes}
    astray = {ch: sorted(v) for ch, v in marks.items()
              if v - {ch} or (v and ch not in active)}
    want = {mo: sum(1 for v in active.values() if v == mo) for mo in modes}
    # the device steps alone, per block
    step, init, _ = multimode.build_bank(W2_FS, b, m, mode_map)
    c = init("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for blk in blocks:
        c, _ = step(c, blk)
    torch.cuda.synchronize()
    ms_block = (time.perf_counter() - t0) / n_blocks * 1e3
    print(f"phase W2 multimode bank ({m} ch x {W2_FRAMES:,} frames @ "
          f"{W2_FS / 1e6:g} MHz, {n_blocks} blocks): {ms_block:.2f} "
          f"ms/block; BPSK31.apply (its kernel's launch) "
          f"{spent[0] / total:.1%} of scan_multimode's "
          f"{total:.2f} s; channels decoded (their own message) {ok} of "
          f"{want}, messages off their channel {astray}; launches "
          f"{counts}, K4 by route {k4_routes} | {smi}")
    check(ok == want and not astray,
          f"W2: decoded {ok} of {want}, off their channel {astray}")
    # K4, K1b and K3 on the path's own calls for the second block
    (a4, kw4), (a1, _), (a3, kw3) = k4.calls[1], k1b.calls[1], k3.calls[1]
    k4c = k4_at(torch, a4, kw4, f"phase W2 K4 channel ({m} x "
                f"{W2_FRAMES:,} frames)", smi)
    k1b_err = mode_errs(torch, F.fir_exact, F.fir_exact_plain, a1,
                        False)[0]["rel"]
    got = pll_bank(*a3, **kw3)
    ref = pll_bank_plain(*(v.cpu() for v in a3), **kw3)
    k3_exact = all(torch.equal(u.cpu(), r) for u, r in zip(got, ref))
    k3_ms = cuda_ms(torch, lambda: pll_bank(*a3, **kw3), 5)
    t3 = a3[0].shape[-1]
    print(f"phase W2 K3 on the path's {tuple(a3[0].shape)} symbols: kernel "
          f"{k3_ms:.3f} ms ({k3_ms * 1e6 / t3:.2f} ns a step, chain floor "
          f"{chain_floor(t3):.3f} ms), layouts {layouts} lanes a warp: "
          f"launches | {smi}")
    print(f"phase W2 kernels on block 2: K1b on the PSK31 group's "
          f"{tuple(a1[0].shape)} planes max_err {k1b_err:.3e} of max |y| "
          f"(bound {REL_BOUND:g}); K3 on {tuple(a3[0].shape)} symbols: "
          f"{'bit-exact' if k3_exact else 'DIFFERS'}")
    check(k1b_err < REL_BOUND, f"W2 K1b vs plain: {k1b_err}")
    check(k3_exact, "W2 K3 vs plain: not bit-exact")
    # BPSK31's kernel on the path's call of block 2, bit for bit everywhere
    (xk, ck), kw = k31.calls[1]
    group = [ch for ch in range(m) if mode_map[ch] == "psk31"]
    act = np.isin(group, list(active))
    got = PS.bpsk31_scan(xk, ck, **kw)
    torch.cuda.synchronize()
    host = {k: v.to("cpu") for k, v in ck.items()}
    t0 = time.perf_counter()
    ref = PS.bpsk31_scan_plain(xk.to("cpu"), host, **kw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    per_ch = ((got[1].cpu() != ref[1]) | (got[2].cpu() != ref[2])).sum(
        1).numpy()
    leaf_err = {name: float((u.cpu().double() - v.double()).abs().max())
                for (name, u), (_, v) in zip(_named_leaves(got[0]),
                                             _named_leaves(ref[0]))}
    err = max(leaf_err.values())
    c31, t31 = xk.re.shape
    ms31 = cuda_ms(torch, lambda: PS.bpsk31_scan(xk, ck, **kw), 20)
    device31 = kernel_ms([lambda: PS.bpsk31_scan(xk, ck, **kw)], 20)
    bound31 = PT.bound_ms(c31, t31)
    print(f"phase W2 BPSK31 kernel vs plain on block 2 ({c31} x {t31}): bits "
          f"or valid flags differing on the {int(act.sum())} active channels "
          f"{int(per_ch[act].sum())}, on the {int((~act).sum())} noise "
          f"channels {int(per_ch[~act].sum())}; largest leaf difference "
          f"{err:.3e} ({leaf_err}); kernel {ms31:.4f} ms a call, "
          f"{device31:.4f} on the device ({device31 * 1e6 / t31:.1f} ns a "
          f"step), plain {plain_ms:.1f} ms, bound {bound31[0]:.5f} ms "
          f"({bound31[1]}), chain floor as counted from the source "
          f"{PT.chain_floor_ms(t31):.4f} ms | {smi}")
    check(per_ch.sum() == 0 and err == 0.0,
          f"W2 BPSK31 kernel vs plain: bits apart by channel {per_ch}, "
          f"leaves {leaf_err}")
    del x, blocks, c, k4, k1b, k3, k31, a4, a1, a3, got, ref, xk, ck
    torch.cuda.empty_cache()
    return dict(ms_block=ms_block, counts=counts, decoded=ok, k4c=k4c,
                k4_routes=k4_routes, bpsk31_share=spent[0] / total,
                k3_ms=k3_ms, bpsk31=dict(ms=ms31, device_ms=device31,
                                         plain_ms=plain_ms, err=err,
                                         bound=bound31))


# -- slice 5: the v1 FIR (K5) and its FM/AM epilogues (K6) -----------------

# (D, T) of the K5/K6 sweep: strides 2-200, taps 17-263, the staged kernel
# (modes fir/am up to D = 16, fm up to 40) and the warp kernel above
MXU_SHAPES = [(2, 17), (2, 37), (4, 67), (5, 68), (16, 67), (40, 71),
              (80, 143), (100, 131), (200, 263)]
F1_T, F1_D = 67, 4


def mxu_fm_bank(torch, gen, c, b, d, t, dtype):
    """(c, b) FM tones near FS/8 on the card (fm_signal), a T-tap band-pass
    around them and the rotation that takes their carrier out of the
    discriminator: the K6 fm cases' inputs."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import firdesign

    xr, xi = fm_signal(torch, gen, c, b, d, "cuda")
    g = firdesign.complex_bandpass(t, FS / 8, min(FS / 4.8, 0.8 * FS / d),
                                   FS)
    taps = Complex(torch.tensor(g.real, dtype=torch.float32, device="cuda"),
                   torch.tensor(g.imag, dtype=torch.float32, device="cuda"))
    return Complex(xr, xi).to(dtype), taps, np.exp(-2j * np.pi * d / 8)


def k6_errs(torch, got, ref, mode, agc):
    """K6 against its plain version under the mode's bound: fm absolute in
    rad (ERR_BOUND), am without the AGC relative to the largest output
    (REL_BOUND), am with the AGC absolute and the exported state relative
    (AGC_BOUND)."""
    out, rout = got[0], ref[0]
    check(bool(torch.isfinite(out).all()), f"fir_fm_mxu {mode} not finite")
    if mode == "fm":
        return float((out - rout).abs().max()), ERR_BOUND
    if not agc:
        return (float((out - rout).abs().max()) / float(rout.abs().max()),
                REL_BOUND)
    return max(float((out - rout).abs().max()),
               float(((got[1] - ref[1]) / ref[1]).abs().max())), AGC_BOUND


# K5 at K1b's window start (offset D - 1), which takes K1b's route at every
# shape: (D, T) where both stay off the tensor-core route with either plane
# dtype (D = 1, below every cut; D = 200, above mode fir's; T = 3,228 at
# the DDC bank's D = 4, where no tensor-core plan fits), and where both
# take it.  The
# shapes of K5_AT_K1B draw from the run's generator, those of
# K5_AT_K1B_MORE from one of their own (K5_SEED), so that the run's
# generator reaches the later paths (W1's band among them) at the offset it
# did before they were added.
K5_AT_K1B_OFF_TC = ((1, 33), (4, 3228), (200, 263))
K5_AT_K1B = ((2, 37), (4, 67), (40, 71), (200, 263))
K5_AT_K1B_MORE = ((1, 33), (4, 3228))
K5_SEED = 13


def phase_mxu_parity(torch, gen):
    """K5 and K6 against their plain versions on the card: strides 2-200,
    taps 17-263, window starts 0, 1, D-2, D-1, D and 2D+1, channels 1, 3
    and 64 in turn, float32 and bfloat16 planes, 80 frames of 128 outputs
    (chunks K > 1); every output, the clamped last frame included; K6 in fm
    with and without de-emphasis and am with and without the AGC ((lam,
    1 - lam) and a b of its own), from nonzero y[-1] and IIR states, the
    AGC's exported state too; K5's launches on the tensor-core route also
    against its split emulation (ops/fir_tc.py::fir_mxu_split, cut into
    the launch's chunks) within TC_SPLIT_REL.  Then K5 in its overlap-save
    form at K1b's window start (offset D-1) against K1b at K5_AT_K1B and
    K5_AT_K1B_MORE: the same route as K1b (the tensor-core route but at
    K5_AT_K1B_OFF_TC) and bit for bit K1b's output, both within
    REL_BOUND of K1b's plain version.  Returns the worst errors."""
    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops import fir_mxu as M
    from libsdr_tpu_torch.ops import fir_tc as TC

    worst = {"fir_mxu": 0.0, "k5 split": 0.0, "fm": 0.0, "am": 0.0,
             "agc": 0.0}
    lib = _build.library()
    k5_tc = 0
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (d, t) in enumerate(MXU_SHAPES):
            line = dict.fromkeys(worst, 0.0)
            for j, s0 in enumerate(sorted({0, 1, max(0, d - 2), d - 1, d,
                                           2 * d + 1})):
                c = (1, 3, 64)[(i + j) % 3]
                b = 80 * 128 * d
                check(M.mxu_fir_supported(t, d, s0, c, b, dtype),
                      f"K5 gate refuses D={d} T={t} s0={s0}")
                taps = Complex(
                    torch.randn(t, generator=gen, device="cuda") / t ** 0.5,
                    torch.randn(t, generator=gen, device="cuda") / t ** 0.5)
                x = noise(torch, gen, c, b, dtype)
                name = f"{str(dtype)[6:]} D={d} T={t} s0={s0} C={c}"
                errs, _, _ = mode_errs(
                    torch, lambda *a: M.fir_mxu(*a)[0],
                    lambda *a: M.fir_mxu_plain(*a)[0], (x, taps, d, s0),
                    False)
                check(errs["rel"] < REL_BOUND,
                      f"fir_mxu vs plain {name}: {errs['rel']}")
                line["fir_mxu"] = max(line["fir_mxu"], errs["rel"])
                kk, route = F._chunks(name, lib, F._MODE_FIR, c, b // d, t,
                                      d, 0, x.re)
                if route == "tc":
                    y = M.fir_mxu(x, taps, d, s0)[0]
                    emu = TC.fir_mxu_split(x, taps, d, s0, b // d, 128 * d,
                                           passes=TC.passes_for(dtype, False),
                                           chunks=kk)
                    e = max(float((y.re - emu.re).abs().max()),
                            float((y.im - emu.im).abs().max())) / max(
                        float(emu.re.abs().max()), float(emu.im.abs().max()))
                    check(e < TC_SPLIT_REL, f"fir_mxu vs split {name}: {e}")
                    line["k5 split"] = max(line["k5 split"], e)
                    k5_tc += 1
                    del y, emu
                fm, fm_taps, rot = mxu_fm_bank(torch, gen, c, b, d, t, dtype)
                lead = Complex(torch.full((c, 1), 0.6, device="cuda"),
                               torch.full((c, 1), -0.8, device="cuda"))
                state = torch.full((c, 1), 0.4, device="cuda")
                lam = float(np.exp(-1.0 / (0.1 * FS / d)))
                for mode, xin, g, ab, gain in (
                        ("fm", fm, fm_taps, None, 1.3),
                        ("fm", fm, fm_taps, (0.95, 0.05), 1.3),
                        ("am", x, taps, None, 1.0),
                        ("am", x, taps, (lam, 1 - lam), 0.125),
                        ("am", x, taps, (0.9, 0.2), 0.125)):
                    args = (xin, g, d, s0, lead, rot, gain, ab,
                            None if ab is None else state, mode)
                    got = M.fir_fm_mxu(*args)
                    ref = M.fir_fm_mxu_plain(*args)
                    torch.cuda.synchronize()
                    check(len(got) == len(ref) and got[0].shape == (c, b // d),
                          f"fir_fm_mxu {mode} {name}: results' shapes")
                    e, bnd = k6_errs(torch, got, ref, mode, ab is not None)
                    check(e < bnd, f"fir_fm_mxu {mode} ab={ab} vs plain "
                                   f"{name}: {e} >= {bnd}")
                    key = "agc" if mode == "am" and ab else mode
                    line[key] = max(line[key], e)
                cases += 1
                del x, fm
            print(f"parity K5/K6 {str(dtype)[6:]} D={d} T={t} s0=0..{2 * d + 1}"
                  f" C=1,3,64: K5 {line['fir_mxu']:.2e} (of max |y|; vs "
                  f"split {line['k5 split']:.2e}), K6 fm "
                  f"{line['fm']:.2e} rad, am {line['am']:.2e} (of max), AGC "
                  f"{line['agc']:.2e}")
            for k in worst:
                worst[k] = max(worst[k], line[k])
    k5_vs_tc, k5_routes = 0.0, []
    k5_gen = torch.Generator(device="cuda")
    k5_gen.manual_seed(K5_SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for g, (d, t) in ([(gen, s) for s in K5_AT_K1B]
                          + [(k5_gen, s) for s in K5_AT_K1B_MORE]):
            taps = Complex(torch.randn(t, generator=g, device="cuda"),
                           torch.randn(t, generator=g, device="cuda"))
            x = noise(torch, g, 3, d * 9000, dtype)
            tail = noise(torch, g, 3, t - 1, dtype)
            name = f"{str(dtype)[6:]} D={d} T={t}"
            _, route = F._chunks("K1b", lib, F._MODE_FIR, 3, 9000, t, d, 0,
                                 x.re)
            check((route == "tc") == ((d, t) not in K5_AT_K1B_OFF_TC),
                  f"K1b {name} on the {route} route")
            n0, m0 = dict(F.fir_exact.routes), dict(M.fir_mxu.routes)
            a = M.fir_offset(x, taps, d, d - 1, tail)
            k1b = F.fir_exact(x, taps, d, tail)
            check(F.fir_exact.routes[route] == n0[route] + 1
                  and M.fir_mxu.routes[route] == m0[route] + 1,
                  f"K5/K1b {name}: not both on the {route} route")
            check(torch.equal(a.re, k1b.re) and torch.equal(a.im, k1b.im),
                  f"K5 at offset D-1 != K1b ({name})")
            ref = F.fir_exact_plain(x, taps, d, tail)
            scale = float(torch.maximum(ref.re.abs().max(),
                                        ref.im.abs().max()))
            e = max(float((a.re - ref.re).abs().max()),
                    float((a.im - ref.im).abs().max())) / scale
            check(e < REL_BOUND, f"K5 at K1b's window start vs plain "
                  f"({name}): {e}")
            k5_vs_tc = max(k5_vs_tc, e)
            k5_routes.append(f"{str(dtype)[6:]} D={d} T={t}: {route}")
    print(f"parity K5/K6: {cases} cases, worst K5 {worst['fir_mxu']:.3e} of "
          f"max |y| (bound {REL_BOUND:g}), on the tc route ({k5_tc} cases) "
          f"{worst['k5 split']:.3e} vs split (bound {TC_SPLIT_REL:g}), K6 "
          f"fm {worst['fm']:.3e} rad "
          f"(bound {ERR_BOUND:g}), am {worst['am']:.3e} (bound "
          f"{REL_BOUND:g}), AGC {worst['agc']:.3e} (bound {AGC_BOUND:g}); "
          "K5 at offset D-1 == K1b bit for bit on K1b's route (off the tc "
          f"route at {K5_AT_K1B_OFF_TC}), both within {k5_vs_tc:.2e} of max "
          f"|y| of K1b's plain version (by route: {', '.join(k5_routes)})")
    return worst, cases


# The tc route's strides (csrc/fir_common.cuh::tc_stride): K1a's
# (D, T) with T = order + D - 1 (the P2 bank's D = 10, T = 41 among them),
# K6's (D, T, s0, C), by plane dtype.
TC_K1A_SHAPES = {"float32": ((4, 67), (5, 68), (8, 67), (10, 41), (16, 47)),
                 "bfloat16": ((4, 67), (5, 68), (8, 67), (10, 41), (16, 47),
                              (24, 55), (40, 71))}
# K1b (mode fir), K1c (mode am, +- the AGC) and K1d (mode usb, +- the AGC)
# on the route, by mode and plane dtype: (D, T, C) at both ends of their
# cuts and inside them (with float32 planes fir 2-40 and am 13-40, each
# with gaps; 2-40 with bfloat16; usb's to D = 120), the DDC bank's D = 4,
# T = 67, the AM bank's D = 40, T = 71 and the USB bank's D = 80, T = 143
# among them; and K5 (mode fir's cut) at every window form of its callers
# (tools/k1_parity.py's k5_case), F1's D = 4, T = 67 among them
K1BC_SEED = 12
TC_K1BC_SHAPES = {
    ("fir", "float32"): ((2, 65, 3), (4, 67, 64), (5, 68, 3), (7, 70, 3),
                         (10, 73, 3), (20, 83, 1), (33, 96, 1),
                         (40, 103, 1)),
    ("fir", "bfloat16"): ((2, 65, 3), (4, 67, 64), (24, 87, 3),
                          (40, 103, 1)),
    ("am", "float32"): ((13, 44, 3), (16, 47, 3), (20, 51, 1), (33, 64, 1),
                        (40, 71, 64)),
    ("am", "bfloat16"): ((2, 33, 3), (4, 35, 64), (40, 71, 64),
                         (40, 71, 1)),
    ("usb", "float32"): ((4, 67, 3), (13, 76, 1), (33, 96, 3),
                         (31, 94, 64)),
    ("usb", "bfloat16"): ((2, 65, 3), (40, 103, 1), (60, 123, 3),
                          (80, 143, 64), (100, 163, 3), (120, 183, 1))}
TC_K5_SHAPES = {"float32": ((4, 67, 64), (5, 68, 3), (20, 83, 1)),
                "bfloat16": ((2, 37, 3), (4, 67, 64), (40, 71, 3))}
TC_K6_SHAPES = {"float32": ((4, 67, 1, 64), (4, 67, 0, 3), (4, 67, 4, 1),
                            (8, 67, 9, 3), (16, 67, 9, 3)),
                "bfloat16": ((4, 67, 1, 64), (4, 67, 0, 3), (8, 67, 9, 3),
                             (16, 67, 9, 3), (40, 71, 1, 3))}


def phase_tc_parity(torch, L, gen):
    """The tensor-core route (csrc/fir_tc.cu) on the card: K1a (mode fm of
    fir_fm_exact) at the route's strides (TC_K1A_SHAPES), float32 and
    bfloat16 planes, de-emphasis on
    and off, 'high' and 'fast', on 3 channels (64 at D = 4) of FM tones:
    a warm block and three carry-chained blocks of 11,017 outputs (2 chunks
    a channel, a ragged last tile), every output and y_last against the
    split emulation (ops/fir_tc.py) within TC_SPLIT_FM / TC_SPLIT_REL, and
    at 'high' against the plain version within ERR_BOUND; every launch on
    the tc route.  Then K6 (fir_fm_mxu, TC_K6_SHAPES) at window starts 0-9
    in fm with and
    without de-emphasis and am with and without the AGC, the same way;
    then K1b (fir_exact), K1c (fir_am_exact, +- the AGC) and K1d
    (fir_usb_exact, +- the AGC) at TC_K1BC_SHAPES (tools/k1_parity.py's
    tc_case: against the split emulation within TC_SPLIT_REL and the plain
    version under REL_BOUND or AGC_BOUND), and K5 at TC_K5_SHAPES (its
    k5_case, the same gates).  Returns the worst errors and the case
    count."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import fir_mxu as M
    from libsdr_tpu_torch.ops import fir_tc as TC
    from libsdr_tpu_torch.ops.fir import set_mxu_precision
    from libsdr_tpu_torch.tools.k1_parity import k5_case
    from libsdr_tpu_torch.tools.k1_parity import tc_case as k1_tc_case

    worst = dict.fromkeys(("k1a split", "k1a plain", "k6 split",
                           "k6 plain", "k1bc split", "k1bc plain",
                           "k5 split", "k5 plain"), 0.0)
    cases = 0
    # K1b/K1c's cases draw from a generator of their own, so that the run's
    # generator reaches the later paths (W1's band among them: its margin,
    # PERF.md §6) at the offset it did before they were added
    k1bc_gen = torch.Generator(device="cuda")
    k1bc_gen.manual_seed(K1BC_SEED)
    try:
        for fast in (False, True):
            set_mxu_precision("fast" if fast else "high")
            for dtype in (torch.float32, torch.bfloat16):
                passes = TC.passes_for(dtype, fast)
                for d, t in TC_K1A_SHAPES[str(dtype)[6:]]:
                    c = 64 if d == 4 else 3
                    for deemph in (True, False):
                        e_split, e_plain = phase_tc_k1a(
                            torch, L, gen, d, t, c, dtype, deemph, passes)
                        worst["k1a split"] = max(worst["k1a split"],
                                                 e_split)
                        worst["k1a plain"] = max(worst["k1a plain"],
                                                 e_plain)
                        cases += 1
                        print(f"parity tc K1a {str(dtype)[6:]} D={d} T={t} "
                              f"C={c} deemph={int(deemph)} passes={passes}"
                              f": vs split {e_split:.3e} rad"
                              + ("" if fast else
                                 f", vs plain {e_plain:.3e} rad"))
                for d, t, s0, c in TC_K6_SHAPES[str(dtype)[6:]]:
                    b = 80 * 128 * d
                    taps = Complex(
                        torch.randn(t, generator=gen, device="cuda") / t ** 0.5,
                        torch.randn(t, generator=gen, device="cuda") / t ** 0.5)
                    x = noise(torch, gen, c, b, dtype)
                    fm, fm_taps, rot = mxu_fm_bank(torch, gen, c, b, d, t,
                                                   dtype)
                    lead = Complex(torch.full((c, 1), 0.6, device="cuda"),
                                   torch.full((c, 1), -0.8, device="cuda"))
                    state = torch.full((c, 1), 0.4, device="cuda")
                    lam = float(np.exp(-1.0 / (0.1 * FS / d)))
                    line = []
                    for mode, xin, g, ab, gain in (
                            ("fm", fm, fm_taps, None, 1.3),
                            ("fm", fm, fm_taps, (0.95, 0.05), 1.3),
                            ("am", x, taps, None, 1.0),
                            ("am", x, taps, (lam, 1 - lam), 0.125),
                            ("am", x, taps, (0.9, 0.2), 0.125)):
                        args = (xin, g, d, s0, lead, rot, gain, ab,
                                None if ab is None else state, mode)
                        n0 = M.fir_fm_mxu.routes["tc"]
                        got = M.fir_fm_mxu(*args)
                        emu = TC.fm_mxu_split(*args, passes=passes)
                        torch.cuda.synchronize()
                        check(M.fir_fm_mxu.routes["tc"] == n0 + 1,
                              f"K6 {mode} D={d}: not on the tc route")
                        es = k6_split_err(torch, got, emu, mode, ab)
                        check(es < (TC_SPLIT_FM if mode == "fm"
                                    else TC_SPLIT_REL),
                              f"tc K6 {mode} ab={ab} {dtype} D={d} T={t} "
                              f"s0={s0} passes={passes} vs split: {es}")
                        worst["k6 split"] = max(worst["k6 split"], es)
                        ep = 0.0
                        if not fast:
                            ref = M.fir_fm_mxu_plain(*args)
                            ep, bnd = k6_errs(torch, got, ref, mode,
                                              ab is not None)
                            check(ep < bnd, f"tc K6 {mode} ab={ab} {dtype} "
                                            f"D={d} vs plain: {ep}")
                            worst["k6 plain"] = max(worst["k6 plain"], ep)
                        line.append(f"{mode}{'+iir' if ab else ''} "
                                    f"{es:.1e}/{ep:.1e}")
                        cases += 1
                    print(f"parity tc K6 {str(dtype)[6:]} D={d} T={t} "
                          f"s0={s0} C={c} passes={passes} (vs split / vs "
                          f"plain): " + ", ".join(line))
                    del x, fm
                for mode, agcs in (("fir", (False,)),
                                   ("am", (False, True)),
                                   ("usb", (False, True))):
                    for d, t, c in TC_K1BC_SHAPES[mode, str(dtype)[6:]]:
                        line = []
                        for agc in agcs:
                            try:
                                es, ep = k1_tc_case(k1bc_gen, mode, agc,
                                                    dtype, d, t, c)
                            except AssertionError as e:
                                raise SmokeFailure(f"tc K1b/K1c/K1d {e}")
                            worst["k1bc split"] = max(worst["k1bc split"],
                                                      es)
                            worst["k1bc plain"] = max(worst["k1bc plain"],
                                                      ep)
                            line.append(f"{'agc' if agc else 'no agc'} "
                                        f"{es:.1e}/{ep:.1e}")
                            cases += 1
                        kid = {"fir": "K1b", "am": "K1c", "usb": "K1d"}[mode]
                        print(f"parity tc {kid} {mode} {str(dtype)[6:]} D={d} "
                              f"T={t} C={c} passes={passes} (vs split / vs "
                              "plain): " + ", ".join(line))
                for d, t, c in TC_K5_SHAPES[str(dtype)[6:]]:
                    try:
                        es, ep = k5_case(k1bc_gen, dtype, d, t, c)
                    except AssertionError as e:
                        raise SmokeFailure(f"tc K5 {e}")
                    worst["k5 split"] = max(worst["k5 split"], es)
                    worst["k5 plain"] = max(worst["k5 plain"], ep)
                    cases += 1
                    print(f"parity tc K5 {str(dtype)[6:]} D={d} T={t} C={c} "
                          f"passes={passes}, 7 window forms (vs split / vs "
                          f"plain): {es:.1e}/{ep:.1e}")
    finally:
        set_mxu_precision("high")
    return worst, cases


def phase_tc_k1a(torch, L, gen, d, t, c, dtype, deemph, passes):
    """One K1a case of phase_tc_parity: (worst error vs split, vs plain;
    0 for 'fast', which is held to the split emulation only)."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops import fir_tc as TC
    from libsdr_tpu_torch.ops.fir_fm import fir_fm_exact_plain

    b = d * (5 * 2048 + 777)
    op = fused_op(L, d, t - d + 1, c, b, dtype).stages[0]
    carry = op.init_carry("cuda")
    e_split = e_plain = 0.0
    for k in range(4):
        xr, xi = fm_signal(torch, gen, c, b, d, "cuda", k * b)
        x = Complex(xr.to(dtype), xi.to(dtype))
        args = (x, op._taps(x.device), d, carry[0], carry[1], op._rot,
                op._gain)
        kw = dict(deemph_ab=op._dab if deemph else None,
                  dstate=carry[2] if deemph else None)
        emu, y_emu = TC.fm_exact_split(*args, **kw, passes=passes)
        if k == 0:
            out, y_last = emu, y_emu
        else:
            n0 = F.fir_fm_exact.routes["tc"]
            out, y_last = F.fir_fm_exact(*args, **kw)
            torch.cuda.synchronize()
            check(F.fir_fm_exact.routes["tc"] == n0 + 1,
                  f"K1a D={d} T={t}: not on the tc route")
            check(bool(torch.isfinite(out).all()), "tc K1a not finite")
            scale = float(torch.maximum(y_emu.re.abs().max(),
                                        y_emu.im.abs().max()))
            ey = max(float((y_last.re - y_emu.re).abs().max()),
                     float((y_last.im - y_emu.im).abs().max())) / scale
            es = float((out - emu).abs().max())
            name = f"{dtype} D={d} T={t} C={c} deemph={int(deemph)} " \
                   f"passes={passes}"
            check(es < TC_SPLIT_FM and ey < TC_SPLIT_REL,
                  f"tc K1a vs split {name}: {es} rad, y_last {ey}")
            e_split = max(e_split, es)
            if passes > 1:
                ref, y_ref = fir_fm_exact_plain(*args, **kw)
                ep = max(float((out - ref).abs().max()),
                         float((y_last.re - y_ref.re).abs().max()),
                         float((y_last.im - y_ref.im).abs().max()))
                check(ep < ERR_BOUND, f"tc K1a vs plain {name}: {ep}")
                e_plain = max(e_plain, ep)
        carry = next_carry(x, t, out, y_last, carry, deemph)
    return e_split, e_plain


def k6_split_err(torch, got, emu, mode, ab):
    """K6 on the tc route against the split emulation: fm absolute in rad,
    am relative to the largest output, the AGC's state relative."""
    out, eout = got[0], emu[0]
    check(bool(torch.isfinite(out).all()), f"tc K6 {mode} not finite")
    if mode == "fm":
        return float((out - eout).abs().max())
    e = float((out - eout).abs().max()) / float(eout.abs().max())
    if ab is not None:
        e = max(e, float(((got[1] - emu[1]) / emu[1]).abs().max()))
    return e


def f1_taps(torch, L):
    """The DDC bank's T = 67 taps (IQBaseBand(order=64, decim=4)) as float32
    planes on the card."""
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.ops import IQBaseBand

    rx = L.Pipeline([IQBaseBand(fc=FS / 8, width=FS / 4.8, order=64,
                                decim=F1_D, design="textbook")])
    rx.bind(L.StreamSpec(np.complex64, FS, BLOCK, channels=(CHANNELS,)))
    taps = rx.stages[0]._inner.stages[0].taps
    check(taps.shape == (F1_T,), f"F1 taps {taps.shape}")
    return cplx.constant(taps, torch.float32, "cuda")


def phase_f1(torch, L, gen, smi):
    """F1, the arbitrary-offset FIR bank: fir_overlap_save(taps, x, tail,
    stride=4, offset=0 and 1) over 64 channels x 2^24-sample blocks with the
    DDC bank's T = 67 taps, float32 and bfloat16 planes, best of 3 runs of
    10 carry-chained steps, K5's launches counted from 0 (one a block,
    each on its route, F1_ROUTES).  Then K5 against its plain version on
    the arguments of the path's own call, on its first two channels
    against its split emulation (ops/fir_tc.py::fir_mxu_split, the
    launch's chunks) within TC_SPLIT_REL where it takes the tc route, and
    the kernel, the plain version and the library call (one strided conv1d
    over the stacked concat(tail, x), full float32: the route the port
    took before) timed with CUDA events, beside its bound on its route
    (bank_bound: K1b's at the same shape)."""
    import torch.nn.functional as tf

    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops import fir_mxu as M
    from libsdr_tpu_torch.ops import fir_tc as TC
    from libsdr_tpu_torch.ops.fir import fir_overlap_save, full_f32

    taps = f1_taps(torch, L)
    x32 = noise(torch, gen, CHANNELS, BLOCK)
    entries = all_entries()
    res, launches = {}, 0
    for offset in (0, 1):
        for plane, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            tail0 = cplx.zeros((CHANNELS, F1_T - 1), dtype, "cuda")
            set_counts_zero(entries)
            with Capture(M, "fir_offset") as k5:
                y, tail = fir_overlap_save(taps, x, tail0, stride=F1_D,
                                           offset=offset)
            torch.cuda.synchronize()
            n = (BLOCK - offset - 1) // F1_D + 1
            check(tuple(y.re.shape) == (CHANNELS, n) and bool(
                torch.isfinite(y.re).all() and torch.isfinite(y.im).all()),
                f"F1 {plane} offset {offset}: output {tuple(y.re.shape)}")
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                tl = tail
                for _ in range(10):
                    y, tl = fir_overlap_save(taps, x, tl, stride=F1_D,
                                             offset=offset)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            ms_step = best / 10 * 1e3
            counts = counts_now(entries)
            check(counts["fir_mxu"] == 1 + 3 * 10 and all(
                v == 0 for k, v in counts.items() if k != "fir_mxu"),
                f"F1 {plane} offset {offset} launches {counts}")
            route = F1_ROUTES[plane]
            check(M.fir_mxu.routes[route] == counts["fir_mxu"],
                  f"F1 {plane} offset {offset} routes {M.fir_mxu.routes}, "
                  f"not all {route}")
            launches += counts["fir_mxu"]
            del y, tl
            (args, kw), = k5.calls
            errs, got, _ = mode_errs(torch, M.fir_offset, M.fir_offset_plain,
                                     args, False)
            check(errs["rel"] < REL_BOUND,
                  f"F1 {plane} offset {offset} K5 vs plain: {errs}")
            e_split = None
            if route == "tc":
                kk, _ = F._chunks("K5", _build.library(), F._MODE_FIR,
                                  CHANNELS, n, F1_T, F1_D, 0, x.re)
                emu = TC.fir_mxu_split(
                    args[0][:2], args[1], F1_D, offset - (F1_T - 1), n, 0,
                    args[4][:2], TC.passes_for(dtype, False), kk)
                e_split = max(
                    float((got.re[:2] - emu.re).abs().max()),
                    float((got.im[:2] - emu.im).abs().max())) / max(
                    float(emu.re.abs().max()), float(emu.im.abs().max()))
                check(e_split < TC_SPLIT_REL,
                      f"F1 {plane} offset {offset} K5 vs split: {e_split}")
                del emu
            del got
            ms = cuda_ms(torch, lambda: M.fir_offset(*args), 5)
            plain_ms = cuda_ms(torch, lambda: M.fir_offset_plain(*args), 2)
            # the library call: one strided conv1d over concat(tail, x)
            xb = torch.stack([torch.cat([tail0.re, x.re], -1),
                              torch.cat([tail0.im, x.im], -1)],
                             dim=1)[..., offset:].float()
            w = torch.stack([torch.stack([taps.re, -taps.im]),
                             torch.stack([taps.im, taps.re])])
            with full_f32():
                lib_ms = cuda_ms(torch, lambda: tf.conv1d(xb, w,
                                                          stride=F1_D), 2)
            del xb
            b_ms, b_by, text = bank_bound(TC, "fir_exact", route,
                                          x.re.element_size(), BLOCK, F1_D,
                                          F1_T)
            res[(offset, plane)] = dict(ms_step=ms_step, err=errs["rel"],
                                        ms=ms, plain_ms=plain_ms,
                                        lib_ms=lib_ms, bound=(b_ms, b_by),
                                        route=route, split=e_split)
            print(f"phase F1 offset={offset} {plane} planes ({CHANNELS}x"
                  f"{BLOCK}, T={F1_T}, D={F1_D}): {ms_step:.3f} ms/step "
                  f"({CHANNELS * BLOCK / ms_step / 1e3:.1f} Msamples/s), "
                  f"launches {counts} on the {route} route; K5 on the "
                  f"path's call: max_err {errs['rel']:.3e} of max |y|"
                  + ("" if e_split is None else
                     f" ({e_split:.2e} vs split on 2 channels)")
                  + f", kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"library conv1d {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by}) | {smi}")
            print(f"bound K5 F1 {route} route {plane} planes: {text}; kernel "
                  f"{ms:.3f} ms")
            del x, args, k5
            torch.cuda.empty_cache()
    del x32
    torch.cuda.empty_cache()
    return res, launches


def phase_k6(torch, L, gen, smi):
    """K6 at full width: fir_fm_mxu over 64 channels x 2^24 samples with the
    DDC bank's T = 67 taps, D = 4, window start 1, in fm with de-emphasis
    (FM tones near FS/8) and am with the AGC (noise), float32 and bfloat16
    planes: best of 3 runs of 10 steps with the launches counted from 0,
    then the kernel against its plain version and both timed with CUDA
    events beside the bound."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import fir_mxu as M

    taps = f1_taps(torch, L)
    d, s0, c, b = F1_D, 1, CHANNELS, BLOCK
    n = b // d
    xr, xi = fm_signal(torch, gen, c, b, d, "cuda")
    fm32 = Complex(xr, xi)
    del xr, xi
    am32 = noise(torch, gen, c, b)
    lead = Complex(torch.full((c, 1), 0.6, device="cuda"),
                   torch.full((c, 1), -0.8, device="cuda"))
    rot = complex(np.exp(-2j * np.pi * (FS / 8) * d / FS))
    lam = float(np.exp(-1.0 / (0.1 * FS / d)))
    entries = all_entries()
    res, launches = {}, 0
    for mode, x32, ab, state, gain in (
            ("fm", fm32, (0.95, 0.05), torch.zeros((c, 1), device="cuda"),
             1.0),
            ("am", am32, (lam, 1 - lam), torch.full((c, 1), 0.5,
                                                    device="cuda"), 0.125)):
        for plane, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            args = (x, taps, d, s0, lead, rot, gain, ab, state, mode)
            set_counts_zero(entries)
            out = M.fir_fm_mxu(*args)
            torch.cuda.synchronize()
            check(tuple(out[0].shape) == (c, n) and bool(
                torch.isfinite(out[0]).all()), f"K6 {mode} {plane} output")
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(10):
                    out = M.fir_fm_mxu(*args)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            ms_step = best / 10 * 1e3
            counts = counts_now(entries)
            check(counts["fir_fm_mxu"] == 1 + 3 * 10 and all(
                v == 0 for k, v in counts.items() if k != "fir_fm_mxu")
                and M.fir_fm_mxu.routes["tc"] == counts["fir_fm_mxu"],
                f"K6 {mode} {plane} launches {counts}, routes "
                f"{M.fir_fm_mxu.routes}")
            launches += counts["fir_fm_mxu"]
            ref = M.fir_fm_mxu_plain(*args)
            torch.cuda.synchronize()
            e, bnd = k6_errs(torch, out, ref, mode, True)
            check(e < bnd, f"K6 {mode} {plane} vs plain: {e} >= {bnd}")
            del out, ref
            ms = cuda_ms(torch, lambda: M.fir_fm_mxu(*args), 5)
            plain_ms = cuda_ms(torch, lambda: M.fir_fm_mxu_plain(*args), 2)
            # bytes: the planes read once, the float32 audio written once;
            # operations an output: the FIR's 8T in the tc route's passes
            # on the tensor cores, the epilogue's ~50 (fm) or ~5 (am)
            passes = 3 if plane == "f32" else 2
            b_ms, b_by = bound_tc(c * (2 * x.re.element_size() * b + 4 * n),
                                  c * n * passes * 8 * F1_T,
                                  c * n * (50 if mode == "fm" else 5))
            res[(mode, plane)] = dict(ms_step=ms_step, err=e, ms=ms,
                                      plain_ms=plain_ms, bound=(b_ms, b_by))
            print(f"phase K6 {mode} {plane} planes ({c}x{b}, T={F1_T}, "
                  f"D={d}, s0={s0}, {'de-emphasis' if mode == 'fm' else 'AGC'}"
                  f"): {ms_step:.3f} ms/step, launches {counts}; max_err "
                  f"{e:.3e} (bound "
                  f"{bnd:g}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {b_ms:.3f} ms ({b_by}) | {smi}")
            del x, args
            torch.cuda.empty_cache()
    del fm32, am32
    torch.cuda.empty_cache()
    return res, launches


def phase_wide_apps(tmp: Path):
    """scanner, multimode --map, spectrum and psk31_rx with --device cuda
    against --device cpu: the same decodes, the same peaks."""
    from libsdr_tpu_torch.apps import multimode, psk31_rx, scanner, spectrum
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.decode import varicode_encode_bits
    from libsdr_tpu_torch.io import write_wav_iq
    from libsdr_tpu_torch.ops import siggen
    from libsdr_tpu_torch.tools import wideband_signals as W

    entries = all_entries()

    def run(label, main, args, expect, summary):
        set_counts_zero(entries)
        got = main(args + ["--device", "cuda"])
        counts = counts_now(entries)
        for name in expect:
            check(counts[name] > 0, f"{label}: {name} did not launch: "
                                    f"{counts}")
        ref = main(args + ["--device", "cpu"])
        check(summary(got) == summary(ref) and summary(got),
              f"{label}: card {summary(got)} != CPU {summary(ref)}")
        print(f"phase 6 {label}: card == CPU: {str(summary(got))[:160]}, "
              f"launches {counts}")

    m = 16
    plan = [(ch, W.page_iq(25_000.0, 500 + ch, f"APP CH {ch}"), 100 * ch)
            for ch in (2, 7, 13)]
    band = cplx.to_numpy(W.upmix(plan, m, m * 30_000, "cpu"))
    write_wav_iq(str(tmp / "band.wav"), band, m * 25_000)
    run("scanner", scanner.main, ["--file", str(tmp / "band.wav"),
                                  "--channels", "16"], ["pfb_mxu", "pll"],
        lambda f: sorted((ch, x.address, x.as_text())
                         for ch, msgs in f.items() for x in msgs))
    active = {2: "pocsag", 3: "ax25", 5: "rtty", 6: "psk31"}
    write_wav_iq(str(tmp / "mixed.wav"),
                 cplx.to_numpy(W.mixed_band(active, 8, "cpu")), 8 * 24_000)
    run("multimode --map", multimode.main,
        ["--file", str(tmp / "mixed.wav"), "--channels", "8", "--map",
         "2:pocsag,3:ax25,5:rtty,6:psk31"],
        ["pfb_mxu", "pll_bank", "fir_exact", "bpsk31_scan"],
        lambda f: sorted((ch, mo, str(d)) for ch, (mo, d) in f.items()))
    fs, n = 96_000, 96_000
    iq = (0.8 * siggen.iq_carrier(fs, n, 12_000)
          + 0.2 * siggen.iq_carrier(fs, n, -25_000)
          + 0.01 * (np.random.default_rng(0).normal(size=n)
                    + 1j * np.random.default_rng(1).normal(size=n))
          ).astype(np.complex64)
    write_wav_iq(str(tmp / "tones.wav"), iq, fs)
    run("spectrum", spectrum.main, ["--file", str(tmp / "tones.wav"),
                                    "--nfft", "4096"], [],
        lambda o: [p["freq_hz"] for p in o["peaks"]])
    bits = np.concatenate([np.ones(16, np.uint8),
                           varicode_encode_bits("cq de tpu"),
                           np.ones(16, np.uint8)])
    sig = np.exp(1j * np.repeat(np.cumsum(np.where(bits == 0, np.pi, 0.0)),
                                640)).astype(np.complex64)
    write_wav_iq(str(tmp / "psk.wav"), 0.8 * sig, 20_000)
    run("psk31_rx", psk31_rx.main, ["--file", str(tmp / "psk.wav"),
                                    "--block-size", "20000"],
        ["fir_exact", "bpsk31_scan"],
        lambda text: text if "cq de tpu" in text else "")


# -- slice 11: chunked dispatch, checkpoint, the Q14 chain, resamplers -----

def ragged_equal(torch, a, b):
    return torch.equal(a.data, b.data) and torch.equal(a.valid, b.valid)


def try_capture(torch, L, label, pipe, blocks, k):
    """compile_chunked("unroll") of a digital path over its first k
    blocks: whether its step captures into a CUDA graph and, where it does,
    the graph's outputs bit for bit against k eager steps.  Returns (True,
    launches per capture) or (False, the ConfigError's reason)."""
    from libsdr_tpu_torch.core import ConfigError
    from libsdr_tpu_torch.core.graph import _leaves

    step = pipe.compile()
    carry = pipe.init_carry("cuda")
    ys = []
    for x in blocks[:k]:
        carry, y = step(carry, x)
        ys.append(y)
    chunked = pipe.compile_chunked("unroll")
    try:
        c2, ys2 = chunked(pipe.init_carry("cuda"), tuple(blocks[:k]))
    except ConfigError as e:
        return False, str(e).splitlines()[0][:300]
    torch.cuda.synchronize()
    check(all(ragged_equal(torch, a, b) for a, b in zip(ys2, ys)),
          f"{label}: the graph's bits differ from {k} eager steps")
    check(all(torch.equal(a, b) for a, b in zip(_leaves(c2)[0],
                                                _leaves(carry)[0])),
          f"{label}: the graph's carry differs from {k} eager steps")
    (g,) = chunked.graphs.values()
    return True, dict(g.launches)


def phase_slice11(torch, L, smi):
    """Slice 11 on the card: the streaming config (tools/stream_times.py:
    the main path on 128 ch x 2^19 at 960 kHz and its small-block section
    at 2^16, f32 and bf16 planes) through run_pipeline at K = 1, 2, 4 and
    8, each K's output bit for bit equal to K = 1's and K1a launched once a
    block at every K (graph launches per capture times replays); whether
    P2 and P1 capture into a CUDA graph (and then equal their eager steps);
    checkpoint after block 4 of 8 and resume into a fresh pipeline, bit for
    bit, f32 and bf16; the Q14 chain at 64 channels, bit for bit against
    the CPU, each stage's time, FMDeemphInt's kernel (csrc/fixedpoint.cu)
    launched once a block and held bit for bit against its plain version
    on the path's call of block 1, and timed there; the resamplers on 64
    channels within 1e-6 of the CPU.  Every generator here is its own."""
    import tempfile

    from libsdr_tpu_torch.apps.chains import pocsag_front_end
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.core.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import (BitStream, FMDeemphInt, FMDemod,
                                      FMDemodInt, FSKDetector, InpolSubSampler,
                                      IQBaseBand, IQBaseBandInt, Resampler)
    from libsdr_tpu_torch.tools.digital_signals import (ax25_bank,
                                                        pocsag_blocks)
    from libsdr_tpu_torch.tools.stream_times import (CHANNELS as SC,
                                                     stream_blocks_on_card,
                                                     stream_pipeline,
                                                     time_config)

    res = {}
    # 1. the streaming config at K = 1, 2, 4, 8
    for block in (1 << 19, 1 << 16):
        for planes, dtype in (("f32", torch.float32),
                              ("bf16", torch.bfloat16)):
            lines = time_config(block, dtype, (1, 2, 4, 8), 8, 3,
                                keep_outputs=True)
            base = lines[0]["out"]
            for line in lines:
                same = np.array_equal(line.pop("out"), base)
                print(f"phase slice 11 streaming {SC} ch x {block:,} "
                      f"{planes} K={line['K']}: run_pipeline "
                      f"{line['run_ms']:.3f} ms a block "
                      f"({line['run_msps']:.1f} Msamples/s), steps alone "
                      f"{line['device_ms']:.3f} ms a block "
                      f"({line['device_msps']:.1f} Msamples/s), K1a "
                      f"launches a block {line['launches']:g}, "
                      f"{'bit-identical to K=1' if same else 'DIFFERS'} "
                      f"| {smi}")
                check(same, f"streaming {block} {planes} K={line['K']}: "
                      "output differs from K=1")
                check(line["launches"] == 1, f"streaming {block} {planes} "
                      f"K={line['K']}: K1a launches a block "
                      f"{line['launches']}")
                res[(block, planes, line["K"])] = line
            del lines, base
            torch.cuda.empty_cache()

    # 2. captures on the digital paths
    gen = torch.Generator(device="cuda")
    gen.manual_seed(111)
    fs2, c2, blk2 = 240e3, 256, 117_760
    p2_blocks = pocsag_blocks(c2, blk2, 2, gen, fs2)
    captured = {"P2": try_capture(torch, L, "P2", pocsag_front_end(
        fs2, blk2, channels=(c2,)), p2_blocks, 2)}
    del p2_blocks
    fs1, c1, b1 = 192_000.0, CHANNELS, 1 << 21
    p1 = L.Pipeline([IQBaseBand(fc=24e3, width=12.5e3, order=48,
                                out_rate=48e3, design="textbook"),
                     FMDemod(), FSKDetector(1200.0, 1200.0, 2200.0),
                     BitStream(1200.0, mode="transition")])
    p1.bind(L.StreamSpec(np.complex64, fs1, b1, channels=(c1,)))
    x1 = ax25_bank(c1, 2 * b1, gen, fs1)
    captured["P1"] = try_capture(torch, L, "P1", p1,
                                 [x1[..., :b1].map(torch.clone),
                                  x1[..., b1:].map(torch.clone)], 2)
    del x1
    torch.cuda.empty_cache()
    for name, (ok, what) in captured.items():
        print(f"phase slice 11 capture {name}: "
              + (f"captures, bit-identical to 2 eager steps, launches per "
                 f"capture {what}" if ok else f"does not capture: {what}"))
    res["captured"] = {k: v[0] for k, v in captured.items()}

    # 3. checkpoint after block 4 of 8 and resume, the streaming config
    block = 1 << 19
    with tempfile.TemporaryDirectory() as tmp:
        for planes, dtype in (("f32", torch.float32),
                              ("bf16", torch.bfloat16)):
            xs = stream_blocks_on_card(block, 8, dtype, seed=4)
            p = stream_pipeline(block, dtype)
            carry, outs = p.init_carry("cuda"), []
            for i, x in enumerate(xs):
                carry, y = p.apply(carry, x)
                outs.append(y)
                if i == 3:
                    save_checkpoint(f"{tmp}/ck.npz", carry, i + 1)
            p2 = stream_pipeline(block, dtype)
            c, pos, _ = load_checkpoint(f"{tmp}/ck.npz", p2.init_carry())
            same = pos == 4
            for i in range(pos, 8):
                c, y = p2.apply(c, xs[i])
                same = same and torch.equal(y, outs[i])
            print(f"phase slice 11 checkpoint {planes}: resumed after block "
                  f"4 of 8, {'bit-identical' if same else 'DIFFERS'}")
            check(same, f"checkpoint/resume {planes} differs")
            del xs, outs

    # 4. the Q14 chain at 64 channels, card against CPU
    rng = np.random.default_rng(14)
    fs, b, c = 240_000.0, 24_000, CHANNELS
    t = np.arange(3 * b) / fs
    ph = (2 * np.pi * (3000.0 + 50.0 * np.arange(c))[:, None] * t
          + 3.0 * np.sin(2 * np.pi * 700.0 * t))
    iq = np.round(9000 * np.exp(1j * ph) + 300 * (
        rng.normal(size=ph.shape) + 1j * rng.normal(size=ph.shape)))
    outs, times = {}, {}
    from libsdr_tpu_torch.ops import fixedpoint as FX
    for dev in ("cpu", "cuda"):
        if dev == "cuda":     # the path's launches, read just after it
            set_counts_zero(all_entries())
        stages = (IQBaseBandInt(fc=3000.0, width=12.5e3, order=21, decim=10),
                  FMDemodInt(ref_block_quirk=True), FMDeemphInt())
        specs = (L.StreamSpec(np.complex64, fs, b, channels=(c,)),
                 L.StreamSpec(np.complex64, fs / 10, b // 10, channels=(c,)),
                 L.StreamSpec(np.float32, fs / 10, b // 10, channels=(c,)))
        for st, sp in zip(stages, specs):
            st.bind(sp)
        cs = [st.init_carry(dev) for st in stages]
        ys, spent = [], [0.0, 0.0, 0.0]
        for k in range(3):
            blk = iq[:, k * b:(k + 1) * b]
            y = Complex(torch.tensor(blk.real, dtype=torch.int32, device=dev),
                        torch.tensor(blk.imag, dtype=torch.int32, device=dev))
            for i, st in enumerate(stages):
                if dev == "cuda" and i == 2 and k == 1:
                    q14_in = (y, cs[2])     # FMDeemphInt's call of block 1
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cs[i], y = st.apply(cs[i], y)
                torch.cuda.synchronize()
                spent[i] += time.perf_counter() - t0
            ys.append(y.cpu().numpy())
        outs[dev] = np.concatenate(ys, -1)
        times[dev] = [v / 3 * 1e3 for v in spent]
        if dev == "cuda":
            q14_launches = {e.__name__: e.launches for e in all_entries()
                            if e.launches}
    exact = np.array_equal(outs["cuda"], outs["cpu"])
    tc = times["cuda"]
    check(q14_launches == {"deemph_int": 3},
          f"Q14 chain: launches {q14_launches}, want deemph_int once a "
          "block")
    # FMDeemphInt's kernel (csrc/fixedpoint.cu) on the path's call of
    # block 1, against its plain version on the same inputs, and timed
    from libsdr_tpu_torch.tools.pfb_times import kernel_ms
    xq, aq = q14_in
    alpha = stages[2]._alpha
    ka, ky = FX.deemph_int(xq, aq, alpha)
    pa, py = FX.deemph_int_plain(xq.cpu(), aq.cpu(), alpha)
    q14_err = max(int((ky.cpu() - py).abs().max()),
                  int((ka.cpu() - pa).abs().max()))
    check(q14_err == 0, f"Q14 kernel: {q14_err} apart from its plain "
          "version")
    n_k = FX.deemph_int.launches
    k_ms = cuda_ms(torch, lambda: FX.deemph_int(xq, aq, alpha), 20)
    k_dev = kernel_ms([lambda: FX.deemph_int(xq, aq, alpha)], 20)
    plain_ms = cuda_ms(torch, lambda: FX.deemph_int_plain(xq, aq, alpha), 1)
    FX.deemph_int.launches = n_k
    cq, tq = xq.shape
    # bytes: the samples read once and the audio written once (int32), the
    # carry in and out; the chain of ~10 integer operations a step with a
    # division (~30 ns a step, counted from the source, not measured)
    q14_bound = bound(8 * cq * tq + 8 * cq, 10 * cq * tq)
    q14_chain = tq * 30e-9 * 1e3
    print(f"phase slice 11 Q14 kernel (FMDeemphInt, csrc/fixedpoint.cu) on "
          f"the path's call of block 1 ({cq} x {tq:,}, alpha {alpha}): "
          f"{'bit-exact' if q14_err == 0 else 'DIFFERS'} against its plain "
          f"version; {k_ms:.4f} ms a call, {k_dev:.4f} on the device, "
          f"plain {plain_ms:.1f} ms; bound {q14_bound[0]:.5f} "
          f"({q14_bound[1]}), the chain as estimated from the source "
          f"{q14_chain:.3f} ms | {smi}")
    res["q14_k"] = dict(launches=q14_launches["deemph_int"], err=q14_err,
                        ms=k_ms, device_ms=k_dev, plain_ms=plain_ms,
                        bound=q14_bound, shape=(cq, tq))
    print(f"phase slice 11 Q14 chain ({c} ch x {b:,} @ 240 kHz, decim 10, "
          f"3 blocks): card {'bit-exact' if exact else 'DIFFERS'} against "
          f"the CPU; card {sum(tc):.1f} ms a block (IQBaseBandInt "
          f"{tc[0]:.2f}, FMDemodInt {tc[1]:.2f}, FMDeemphInt {tc[2]:.1f}: "
          f"{100 * tc[2] / sum(tc):.1f}%), CPU {sum(times['cpu']):.1f} ms "
          f"| {smi}")
    check(exact, "Q14 chain: the card differs from the CPU")
    check(np.abs(outs["cuda"]).max() > 100, "Q14 chain: no audio")
    res["q14_ms"], res["q14_deemph_ms"] = sum(tc), tc[2]

    # 5. the resamplers on 64 channels, card against CPU
    x = (rng.normal(size=(c, 3 * 1200)) + 1j * rng.normal(size=(c, 3 * 1200))
         ).astype(np.complex64)
    for name, make in (("Resampler(p=3, q=2)", lambda: Resampler(p=3, q=2)),
                       ("InpolSubSampler(2.5)", lambda: InpolSubSampler(2.5))):
        got = {}
        for dev in ("cpu", "cuda"):
            op = make()
            op.bind(L.StreamSpec(np.complex64, 48000, 1200, channels=(c,)))
            cc, ys = op.init_carry(dev), []
            for k in range(3):
                cc, y = op.apply(cc, cplx.as_block(
                    x[:, k * 1200:(k + 1) * 1200], torch.float32, dev))
                ys.append(cplx.to_numpy(y))
            got[dev] = np.concatenate(ys, -1)
        err = float(np.abs(got["cuda"] - got["cpu"]).max())
        print(f"phase slice 11 {name} ({c} ch, 3 blocks of 1,200): card "
              f"against CPU max_abs_err {err:.3e} (bound 1e-06)")
        check(err < 1e-6, f"{name}: card against CPU {err}")
    return res


# -- slice 14: the native host runtime, file and live ingest, APRS ---------

def phase_pump_p2(torch, gen, smi, tmp: Path):
    """The pump-fed POCSAG bank at P2's shape (256 ch x 117,760 at 240 kHz,
    4 steps; tools/ingest_bank.py): P2's traffic quantized to the u8 wire
    (send_live_iq's rounding, scaled so that nothing clips) and written as
    one file of (256, 2 x 117,760) u8 steps; FilePump -> RingBuffer -> one
    upload of the raw u8 a step -> u8_wire_to_planes on the card -> the
    bank's stages (K1a at D = 10, K2) -> compact_device -> the native
    POCSAG state machine, with bf16 and f32 planes.  Every channel decodes
    its page; the bits equal the same chain fed the same bytes already on
    the card; K1a and K2 launch once a step each and nothing else; the
    native state machine's messages equal POCSAGDecoder's."""
    from libsdr_tpu_torch.decode import POCSAGDecoder, pocsag_decode_bits
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.tools import ingest_bank as IB
    from libsdr_tpu_torch.tools.digital_signals import (POCSAG_ADDRESS,
                                                        pocsag_blocks)

    fs, c, blk, nb = 240e3, 256, 117_760, 4
    dev = torch.device("cuda")
    blocks = pocsag_blocks(c, blk, nb, gen, fs)
    steps = [IB.quantize_u8(b, IB.unclipped_scale(blocks)) for b in blocks]
    del blocks
    path = tmp / "p2_wire.u8"
    nbytes = IB.write_wire_file(path, steps)
    cap = IB.capacity(fs, blk)
    entries = all_entries()
    # the file pump and ring alone, no device: the host's rate for the wire
    t0 = time.perf_counter()
    n_alone = sum(raw.nbytes for raw in IB.pump_steps(path, c, blk))
    pump_mbps = n_alone / (time.perf_counter() - t0) / 1e6
    check(n_alone == nbytes, f"the pump alone gave {n_alone} of {nbytes}")

    def key(msgs):
        return [(m.address, m.function, m.bits, m.payload) for m in msgs]

    res = {}
    for plane, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        # the in-memory feed: its second run timed (the first warms up)
        for _ in range(2):
            set_counts_zero(entries)
            mem = IB.run_steps(steps, IB.pocsag_bank(fs, blk, c, dtype), fs,
                               blk, dtype, dev)
            mem_counts = counts_now(entries)
        set_counts_zero(entries)
        fed = IB.run_steps(IB.pump_steps(path, c, blk),
                           IB.pocsag_bank(fs, blk, c, dtype), fs, blk, dtype,
                           dev)
        counts = counts_now(entries)
        routes = dict(F.fir_fm_exact.routes)
        same = all(torch.equal(a, b) for a, b in zip(fed[0] + fed[1],
                                                     mem[0] + mem[1]))
        worst = max(int(k.max()) for k in fed[1])
        bits = IB.channel_bits(fed[0], fed[1])
        t0 = time.perf_counter()
        nat = [pocsag_decode_bits(b) for b in bits]
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = [POCSAGDecoder().process(b) for b in bits]
        py_s = time.perf_counter() - t0
        same_msgs = all(key(a) == key(b) for a, b in zip(nat, py))
        decoded = sum(any(m.address == POCSAG_ADDRESS for m in ms)
                      for ms in nat)
        ms_fed, ms_mem = fed[2] / nb * 1e3, mem[2] / nb * 1e3
        up_ms = fed[3]["upload"] / nb * 1e3
        take_ms = fed[3]["take"] / nb * 1e3
        mbps = nbytes / fed[2] / 1e6
        res[plane] = dict(ms_fed=ms_fed, ms_mem=ms_mem, up_ms=up_ms,
                          take_ms=take_ms, mbps=mbps, pump_mbps=pump_mbps,
                          nat_s=nat_s, py_s=py_s, decoded=decoded)
        print(f"phase 14 pump-fed P2 {plane} planes ({c} x {blk:,} @ 240 "
              f"kHz, {nb} steps, {nbytes / 1e6:.1f} MB of u8 wire): "
              f"{ms_fed:.2f} ms a step with the ingest (of it: the ring's "
              f"take {take_ms:.2f}, the upload of the raw u8 from pageable "
              f"memory {up_ms:.2f}), {ms_mem:.2f} without (the bytes on "
              f"the card), wire {mbps:.0f} MB/s (the pump and ring "
              f"alone, no device: {pump_mbps:.0f} MB/s); pages {decoded}/{c}; bits "
              f"{'equal' if same else 'DIFFER from'} the in-memory feed's "
              f"(most {worst} a step of capacity {cap}); host decode native "
              f"{nat_s:.3f} s, Python {py_s:.2f} s, "
              f"{'the same' if same_msgs else 'DIFFERENT'} messages; "
              f"launches {counts} (in memory {mem_counts}), K1a routes "
              f"{routes} | {smi}")
        for label, n in (("pump-fed", counts), ("in-memory", mem_counts)):
            check(n["fir_fm_exact"] == nb and n["pll"] == nb and all(
                v == 0 for k, v in n.items()
                if k not in ("fir_fm_exact", "pll")),
                f"pump-fed P2 {plane} {label} launches {n}")
        check(same, f"pump-fed P2 {plane}: bits differ from the in-memory "
                    "feed")
        check(worst <= cap, f"pump-fed P2 {plane}: {worst} bits > {cap}")
        check(same_msgs, f"pump-fed P2 {plane}: native != Python messages")
        check(decoded == c, f"pump-fed P2 {plane}: {decoded} of {c} pages")
        del mem, fed, bits
    path.unlink()
    del steps
    torch.cuda.empty_cache()
    return res


def phase_live_w1(torch, gen, smi, tmp: Path):
    """The live scanner at W1's shape (1024 ch x 2^26-sample blocks at
    24.576 MHz, two blocks) on loopback: W1's band from the phase's own
    generator, scaled below full scale and quantized once to u8 bytes,
    sent by io.live's wire writer to a tcp-listen://127.0.0.1:0 source,
    paced to 24.576 Msamples/s (tx --realtime's pace, a radio's rate), and
    decoded by scan_blocks(stream_live_iq(...)), then with
    stream_live_iq_bf16 and bf16 planes.  No byte dropped; the decode
    equals the file-fed one of the same bytes, dtype for dtype; every page
    decoded sits on its own channel and its address on no other; K4 and
    K2 launched on the path."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.tools import ingest_bank as IB
    from libsdr_tpu_torch.tools import wideband_signals as W

    m, b = W1_M, W1_BLOCK
    dev = torch.device("cuda")
    blocks, pages = W.pager_band(m, 2, b, "cuda", gen=gen)
    x = [Complex(p.re[None], p.im[None]) for p in blocks]
    scale = IB.unclipped_scale(x, 0.9)
    data = b"".join(IB.quantize_u8(p, scale).cpu().numpy().tobytes()
                    for p in x)
    del blocks, x
    torch.cuda.empty_cache()
    path = tmp / "w1_wire.u8"
    path.write_bytes(data)
    entries = all_entries()
    res = {}
    for plane, bf16 in (("f32", False), ("bf16", True)):
        set_counts_zero(entries)
        found, stats, secs = IB.scan_live(data, W1_FS, m, b, bf16, dev,
                                          rate=W1_FS, timeout=60.0)
        counts = counts_now(entries)
        filed = IB.scan_file(path, W1_FS, m, b, bf16, dev)
        same = IB.pages_of(found) == IB.pages_of(filed)
        ok = IB.decoded_pages(found, pages)
        astray = IB.misplaced(found, pages)
        res[plane] = dict(decoded=len(ok), sent=len(pages), secs=secs)
        print(f"phase 14 live W1 {plane} planes ({m} ch x {b:,} @ "
              f"{W1_FS / 1e6:g} MHz, 2 blocks over loopback TCP paced to "
              f"{W1_FS / 1e6:g} Msamples/s): {secs:.2f} s, "
              f"{stats.bytes_in:,} bytes in, {stats.bytes_dropped} "
              f"dropped; pages decoded {len(ok)}/{len(pages)} on their own "
              f"channel (the u8 wire's rounding changes the traffic), "
              f"{'equal to' if same else 'DIFFERENT from'} the file-fed "
              f"decode of the same bytes; astray {astray}; launches "
              f"{counts} | {smi}")
        check(stats.bytes_dropped == 0 and stats.bytes_in == len(data),
              f"live W1 {plane}: {stats.bytes_in} in, "
              f"{stats.bytes_dropped} dropped of {len(data)}")
        check(same, f"live W1 {plane}: live != file-fed decode")
        check(not astray, f"live W1 {plane}: pages off their channel "
                          f"{astray}")
        check(counts["pfb_mxu"] == 2 and counts["pll"] == 2,
              f"live W1 {plane}: launches {counts}")
        check(ok, f"live W1 {plane}: no page decoded")
    path.unlink()
    return res


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(args):
    """A CLI of the port as a process of its own, from the checkout."""
    return subprocess.Popen([sys.executable, "-m"] + args,
                            cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(proc, label, timeout=120):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"{label}: did not finish within {timeout} s")
    check(proc.returncode == 0, f"{label} failed: {out[-2000:]}")
    return out


def phase_live_apps(torch, gen, smi, tmp: Path):
    """The apps on the card through their CLIs: tx pocsag --wire
    tcp-listen://127.0.0.1:P into the live POCSAG receiver (stream_live_iq
    through the POCSAG chain); scanner --live with and without --bf16 from
    a FIFO, decoding as --raw (--bf16) does on the same bytes; and
    aprs_service --live fifo://..., fed by tx afsk --wire, showing the
    frame in GET /spots over HTTP on loopback, with K2 launched."""
    import json as _json
    import os
    import threading
    import urllib.request

    from libsdr_tpu_torch.apps import aprs_service, scanner
    from libsdr_tpu_torch.apps.chains import pocsag_front_end, run_bit_chain
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.decode import pocsag_decode_bits
    from libsdr_tpu_torch.io.live import LiveStats, stream_live_iq
    from libsdr_tpu_torch.tools import ingest_bank as IB
    from libsdr_tpu_torch.tools import wideband_signals as W

    entries = all_entries()
    # tx pocsag --wire tcp-listen -> the live receiver pulls (tcp://)
    port = _free_port()
    proc = _cli(["libsdr_tpu_torch.apps.tx", "pocsag", "--wire",
                 f"tcp-listen://127.0.0.1:{port}", "--address", "77",
                 "--text", "LIVE LOOPBACK"])
    stats, t0 = LiveStats(), time.perf_counter()
    while True:
        try:
            gen_iq = stream_live_iq(f"tcp://127.0.0.1:{port}", 48_000,
                                    stats=stats, timeout=30.0)
            break
        except ConnectionError:
            check(time.perf_counter() - t0 < 60 and proc.poll() is None,
                  "tx --wire tcp-listen never listened")
            time.sleep(0.1)
    iq = np.concatenate(list(gen_iq))
    _finish(proc, "tx pocsag --wire")
    set_counts_zero(entries)
    msgs = pocsag_decode_bits(run_bit_chain(
        pocsag_front_end(240e3, 48_000), iq, "cuda"))
    counts = counts_now(entries)
    print(f"phase 14 tx pocsag --wire tcp-listen -> live receiver on the "
          f"card: {stats.bytes_in} bytes, {stats.bytes_dropped} dropped, "
          f"{[(x.address, x.as_text()) for x in msgs]}, launches {counts}")
    check(stats.bytes_dropped == 0 and msgs and msgs[0].address == 77
          and msgs[0].as_text().startswith("LIVE LOOPBACK"),
          f"tx --wire loopback: {msgs}")
    check(counts["fir_fm_exact"] > 0 and counts["pll"] > 0,
          f"tx --wire loopback launches {counts}")

    # scanner --live (fifo) against --raw on the same bytes
    m, b = 64, 64 * 16_384
    fs = m * 24_000.0
    blocks, pages = W.pager_band(m, 2, b, "cuda", gen=gen,
                                 channels=[5, 20, 37, 50])
    x = [Complex(p.re[None], p.im[None]) for p in blocks]
    scale = IB.unclipped_scale(x, 0.9)
    raw = tmp / "band.u8"
    data = b"".join(IB.quantize_u8(p, scale).cpu().numpy().tobytes()
                    for p in x)
    raw.write_bytes(data)
    del blocks, x
    for extra in ([], ["--bf16"]):
        fifo = tmp / f"band{len(extra)}.fifo"
        os.mkfifo(fifo)
        err = []

        def antenna():
            try:
                with open(fifo, "wb") as f:
                    f.write(data)
            except Exception as e:  # noqa: BLE001 - checked below
                err.append(e)

        feeder = threading.Thread(target=antenna, daemon=True)
        feeder.start()
        set_counts_zero(entries)
        live = scanner.main(["--live", f"fifo://{fifo}", "--rate", str(fs),
                             "--channels", str(m), "--live-timeout", "30",
                             "--device", "cuda"] + extra)
        counts = counts_now(entries)
        feeder.join(60)
        check(not feeder.is_alive() and not err, f"FIFO feeder: {err}")
        filed = scanner.main(["--raw", str(raw), "--rate", str(fs),
                              "--channels", str(m), "--device", "cuda"]
                             + extra)
        label = " ".join(["scanner --live"] + extra)
        ok = IB.decoded_pages(live, pages)
        same = IB.pages_of(live) == IB.pages_of(filed)
        print(f"phase 14 {label}: {'equal to' if same else 'DIFFERENT from'}"
              f" --raw on the same bytes; pages {len(ok)}/{len(pages)}; "
              f"launches {counts}")
        check(same,
              f"{label} != --raw: {IB.pages_of(live)} / "
              f"{IB.pages_of(filed)}")
        check(len(ok) == len(pages) and not IB.misplaced(live, pages),
              f"{label}: pages {ok} of {sorted(pages)}")
        check(counts["pfb_mxu"] > 0 and counts["pll"] > 0,
              f"{label} launches {counts}")

    # aprs_service --live fifo, fed by tx afsk --wire; GET /spots
    fifo = tmp / "afsk.fifo"
    os.mkfifo(fifo)
    port = _free_port()
    out = {}

    def service():
        try:
            out["store"] = aprs_service.main(
                ["--live", f"fifo://{fifo}", "--rate", "24000", "--port",
                 str(port), "--block-size", "12000", "--live-timeout", "60",
                 "--device", "cuda"])
        except Exception as e:  # noqa: BLE001 - checked below
            out["error"] = e

    set_counts_zero(entries)
    th = threading.Thread(target=service, daemon=True)
    th.start()
    t0 = time.perf_counter()
    while True:     # hold a writer, so the wire stays open while we read
        try:
            hold = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
            break
        except OSError:
            check(time.perf_counter() - t0 < 60 and th.is_alive(),
                  f"aprs_service never opened its FIFO: {out}")
            time.sleep(0.05)
    try:
        _finish(_cli(["libsdr_tpu_torch.apps.tx", "afsk", "--wire",
                      f"fifo://{fifo}", "--from-call", "K1GPU"]),
                "tx afsk --wire")
        spots = []
        while not spots:
            check(time.perf_counter() - t0 < 120, "no spot over HTTP")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/spots", timeout=10) as r:
                    spots = _json.loads(r.read())
            except OSError:
                pass
            time.sleep(0.1)
    finally:
        os.close(hold)
    th.join(120)
    counts = counts_now(entries)
    check(not th.is_alive() and "error" not in out,
          f"aprs_service --live: {out.get('error')}")
    print(f"phase 14 aprs_service --live fifo (fed by tx afsk --wire): GET "
          f"/spots {spots}; launches {counts}")
    check(spots == out["store"].spots() and spots[0]["from"] == "K1GPU-0",
          f"aprs_service spots {spots}")
    check(counts["pll"] > 0, f"aprs_service --live launches {counts}")


def phase_slice14(torch, smi, tmp: Path):
    """Slice 14 on traffic from a generator of its own (the earlier phases
    keep their draws): the pump-fed P2 bank, the live W1 scanner and the
    apps' live options."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1414)
    p2 = phase_pump_p2(torch, gen, smi, tmp)
    w1 = phase_live_w1(torch, gen, smi, tmp)
    phase_live_apps(torch, gen, smi, tmp)
    return dict(p2=p2, w1=w1)


# -- slice 15: the sharded multimode bank at n == 1 --------------------------

def _found_summary(found):
    """{channel: (mode, comparable decode)} of a bank's decodes."""
    out = {}
    for ch, (mode, dec) in found.items():
        if mode == "pocsag":
            out[ch] = (mode, [(x.address, x.as_text()) for x in dec])
        elif mode == "ax25":
            out[ch] = (mode, [str(f) for f, _ in dec])
        else:
            out[ch] = (mode, dec.strip())
    return out


def _w2_checked(W, found, active, label):
    """W2's decode check: every active channel its own message, none off
    its channel; returns (decoded by mode, wanted by mode)."""
    modes = ("pocsag", "ax25", "rtty", "psk31")
    marks = {ch: W.mixed_marks(mo, dec) for ch, (mo, dec) in found.items()}
    ok = {mo: sum(1 for ch, v in active.items() if v == mo
                  and found.get(ch, (None,))[0] == mo and marks[ch] == {ch})
          for mo in modes}
    astray = {ch: sorted(v) for ch, v in marks.items()
              if v - {ch} or (v and ch not in active)}
    want = {mo: sum(1 for v in active.values() if v == mo) for mo in modes}
    check(ok == want and not astray,
          f"{label}: decoded {ok} of {want}, off their channel {astray}")
    return ok, want


def phase_slice15(torch, smi, tmp: Path):
    """Slice 15, on W2's traffic from a generator of its own (seed 1515):
    the sharded multimode bank (``parallel/multimode.build_multimode_step``)
    at n == 1 on the card, W2's 256 channels x 12,288 frames at 6.144 MHz
    with the pattern pocsag,ax25,rtty,psk31:

    * ``apps/multimode.scan_multimode_sharded``: every active channel
      decodes its own message and nothing is off its channel; the decodes
      equal ``scan_multimode``'s with the pattern's map; K4 (stream route),
      K1b, K3 and BPSK31 once a block and nothing else, the first three
      held against their plain versions on the path's own call of block 2
      (K3 bit-exact);
    * the step bit for bit ``build_bank``'s over every block;
    * the band on the u8 wire (scaled to a 0.9 peak, nothing clipped)
      through ``multimode --raw --bf16 --pattern``: every active channel,
      K4 launched with bf16 planes on its route and held against its plain
      version on the path's call (2e-5 of max |Y|), timed there;
    * ``multimode --live tcp-listen:// --bf16 --pattern`` fed the same bytes
      over loopback TCP paced to 6.144 Msamples/s: the ``--raw`` decodes;
    * ms a block of the step, f32 and bf16 planes, against build_bank's:
      the host clock and the device's time alone, interleaved
      (``tools/multimode_times.step_times``).

    Two ranks sharing the card are not run: gloo refuses a send or receive
    of CUDA tensors (``batch_isend_irecv``: "writev ...: Bad address"; its
    broadcast, all_gather and all_to_all_single take them), and NCCL
    refuses two ranks on one GPU (PERF.md, ROADMAP.md)."""
    import contextlib
    import io
    import threading

    from libsdr_tpu_torch.apps import multimode
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.io.ingest import u8_wire_to_planes
    from libsdr_tpu_torch.io.live import send_live_bytes
    from libsdr_tpu_torch.ops import bitsync
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops.pfb import pfb_mxu, pfb_plain
    from libsdr_tpu_torch.ops.pll import pll_bank, pll_bank_plain
    from libsdr_tpu_torch.parallel import wideband as pwb
    from libsdr_tpu_torch.parallel.multimode import build_multimode_step
    from libsdr_tpu_torch.tools import ingest_bank as IB
    from libsdr_tpu_torch.tools import wideband_signals as W
    from libsdr_tpu_torch.tools.multimode_times import step_times

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1515)
    m, b = W2_M, W2_M * W2_FRAMES
    pattern = ("pocsag", "ax25", "rtty", "psk31")
    mode_map = {ch: pattern[ch % 4] for ch in range(m)}
    active = {ch: mode_map[ch] for ch in range(0, m - 5, 5)}
    x = W.mixed_band(active, m, "cuda", gen=gen, sigma=0.02)
    n_blocks = -(-x.shape[-1] // b)
    pad = n_blocks * b - x.shape[-1]
    x = x.map(lambda a: torch.nn.functional.pad(a, (0, pad)))
    blocks = [x[i * b:(i + 1) * b] for i in range(n_blocks)]
    entries = all_entries()
    path = ("pfb_mxu", "pll_bank", "fir_exact", "bpsk31_scan")

    def launched_once_a_block(counts, label, n=n_blocks):
        check(all(counts[k] == n for k in path)
              and all(v == 0 for k, v in counts.items() if k not in path),
              f"{label} launches {counts}")

    # scan_multimode_sharded at n == 1, f32 planes
    set_counts_zero(entries)
    t0 = time.perf_counter()
    with Capture(pwb, "pfb_mxu") as k4, Capture(F, "fir_exact") as k1b, \
            Capture(bitsync, "pll_bank") as k3:
        found = multimode.scan_multimode_sharded(
            None, W2_FS, m, pattern, block=b,
            blocks=lambda blk: iter(blocks), device="cuda")
    scan_s = time.perf_counter() - t0
    counts = counts_now(entries)
    routes = dict(pfb_mxu.routes)
    launched_once_a_block(counts, "slice 15 scan_multimode_sharded")
    check(routes == {"generic": 0, "stream": n_blocks},
          f"slice 15: K4 routes {routes}")
    ok, want = _w2_checked(W, found, active, "slice 15 sharded bank")
    by_map = multimode.scan_multimode(None, W2_FS, m, mode_map, block=b,
                                      blocks=lambda blk: iter(blocks),
                                      device="cuda")
    same_found = _found_summary(found) == _found_summary(by_map)
    print(f"phase 15 scan_multimode_sharded n == 1 ({m} ch x "
          f"{W2_FRAMES:,} frames @ {W2_FS / 1e6:g} MHz, {n_blocks} blocks, "
          f"f32 planes): {scan_s:.1f} s; channels decoded (their own "
          f"message) {ok} of {want}, none astray; "
          f"{'equal to' if same_found else 'DIFFERENT from'} "
          f"scan_multimode with the pattern's map; launches {counts}, K4 by "
          f"route {routes} | {smi}")
    check(same_found, "slice 15: sharded decodes != scan_multimode's")
    # its kernels on the path's own calls of block 2
    (a4, kw4), (a1, _), (a3, kw3) = k4.calls[1], k1b.calls[1], k3.calls[1]
    got, ref = pfb_mxu(*a4, **kw4), pfb_plain(*a4, **kw4)
    torch.cuda.synchronize()
    k4_err = pfb_errs(torch, got, ref, False, 1.0)[0]
    k1b_err = mode_errs(torch, F.fir_exact, F.fir_exact_plain, a1,
                        False)[0]["rel"]
    k3_exact = all(torch.equal(u.cpu(), r) for u, r in zip(
        pll_bank(*a3, **kw3), pll_bank_plain(*(v.cpu() for v in a3),
                                             **kw3)))
    print(f"phase 15 kernels on block 2 of the sharded bank: K4 "
          f"{k4_err:.3e} of max |Y| (bound {PFB_REL:g}), K1b {k1b_err:.3e} "
          f"of max |y| (bound {REL_BOUND:g}), K3 "
          f"{'bit-exact' if k3_exact else 'DIFFERS'}")
    check(k4_err < PFB_REL and k1b_err < REL_BOUND and k3_exact,
          f"slice 15 kernels vs plain: K4 {k4_err}, K1b {k1b_err}, K3 "
          f"{k3_exact}")
    del k4, k1b, k3, a4, a1, a3, got, ref

    # the step at n == 1 bit for bit build_bank's
    step, init, place, _ = build_multimode_step(m, b, W2_FS, pattern,
                                                device="cuda")
    bstep, binit, _ = multimode.build_bank(W2_FS, b, m, mode_map)
    c, bc = init(), binit("cuda")
    differ = []
    for i, blk in enumerate(blocks):
        c, o = step(c, place(blk))
        bc, bo = bstep(bc, blk)
        for mo in o:
            if not (torch.equal(o[mo].valid, bo[mo].valid) and torch.equal(
                    o[mo].data * o[mo].valid, bo[mo].data * bo[mo].valid)):
                differ.append((i, mo))
    print(f"phase 15 build_multimode_step n == 1 vs build_bank over "
          f"{n_blocks} blocks: "
          + ("bit for bit" if not differ else f"DIFFERENT at {differ}"))
    check(not differ, f"slice 15: the sharded step != build_bank {differ}")

    # the u8 wire: --raw --bf16 --pattern through the CLI
    xs = [Complex(blk.re[None], blk.im[None]) for blk in blocks]
    scale = IB.unclipped_scale(xs, 0.9)
    data = b"".join(IB.quantize_u8(v, scale).cpu().numpy().tobytes()
                    for v in xs)
    del xs
    wire = tmp / "w2_wire.u8"
    wire.write_bytes(data)
    cli = ["--rate", str(int(W2_FS)), "--channels", str(m), "--bf16",
           "--pattern", ",".join(pattern), "--device", "cuda"]
    set_counts_zero(entries)
    with Capture(pwb, "pfb_mxu") as k4, \
            contextlib.redirect_stdout(io.StringIO()):
        filed = multimode.main(["--raw", str(wire)] + cli)
    counts = counts_now(entries)
    bf16_launches = counts["pfb_mxu"]
    bf16_routes = dict(pfb_mxu.routes)
    # the CLI sizes its own blocks: 12,000 frames, ~0.5 s (the PSK31
    # decimator's multiple), so 8 blocks of 12,288 make 9 of them
    cli_blocks = -(-n_blocks * W2_FRAMES // (int(W2_FS) // 2 // m // 12 * 12))
    launched_once_a_block(counts, "slice 15 --raw --bf16", cli_blocks)
    check(bf16_routes == {"generic": 0, "stream": cli_blocks},
          f"slice 15 --bf16: K4 routes {bf16_routes}")
    check(all(a[0].re.dtype == torch.bfloat16 for a, _ in k4.calls),
          "slice 15 --bf16: K4 did not get bf16 planes")
    ok16, _ = _w2_checked(W, filed, active, "slice 15 --raw --bf16")
    print(f"phase 15 multimode --raw (u8 wire, {len(data):,} bytes, scaled "
          f"{scale:.4f}) --bf16 --pattern: channels decoded {ok16} of "
          f"{want}, none astray; launches {counts}, K4 by route "
          f"{bf16_routes} with bf16 planes | {smi}")
    a4, kw4 = k4.calls[1]
    k4b = k4_at(torch, a4, kw4, f"phase 15 K4 channel bf16 planes ({m} x "
                f"{a4[0].shape[-2]:,} frames, the CLI's block)", smi)
    del k4, a4

    # the same bytes live: --live tcp-listen:// --bf16 --pattern
    port = _free_port()
    err, sent = [], []

    def antenna():
        t_end = time.perf_counter() + 60
        while True:
            try:
                t_send = time.perf_counter()
                send_live_bytes(f"tcp://127.0.0.1:{port}", data, W2_FS, 2,
                                timeout=60.0)
                sent.extend((t_send, time.perf_counter()))
                return
            except ConnectionRefusedError as e:
                if time.perf_counter() > t_end:
                    err.append(e)
                    return
                time.sleep(0.1)
            except Exception as e:  # noqa: BLE001 - checked below
                err.append(e)
                return

    feeder = threading.Thread(target=antenna, daemon=True)
    set_counts_zero(entries)
    feeder.start()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        live = multimode.main(["--live", f"tcp-listen://127.0.0.1:{port}",
                               "--live-timeout", "30"] + cli)
    stats = [ln for ln in printed.getvalue().splitlines()
             if ln.startswith("live:")]
    t_done = time.perf_counter()
    live_s = t_done - t0
    counts = counts_now(entries)
    feeder.join(60)
    check(not feeder.is_alive() and not err and sent,
          f"live feeder: {err}")
    same_live = _found_summary(live) == _found_summary(filed)
    # the run's time: set-up before the first byte, the paced wire, the
    # work left after its last byte (the backlog, the host's decode)
    live_parts = (sent[0] - t0, sent[1] - sent[0], t_done - sent[1])
    print(f"phase 15 multimode --live tcp-listen --bf16 --pattern (loopback "
          f"TCP paced to {W2_FS / 1e6:g} Msamples/s, "
          f"{len(data) / 2 / W2_FS:.3f} s of wire): {live_s:.2f} s = "
          f"{live_parts[0]:.3f} s before the first byte + "
          f"{live_parts[1]:.3f} s sending + {live_parts[2]:.3f} s after "
          f"the last, {stats[0] if stats else 'no live line'}; "
          f"{'equal to' if same_live else 'DIFFERENT from'} --raw on the "
          f"same bytes; launches {counts}")
    check(bool(stats) and stats[0].startswith(
        f"live: {len(data)} bytes in, 0 dropped"),
          f"slice 15 --live: {stats} for {len(data)} bytes sent")
    check(same_live, "slice 15 --live != --raw")
    check(counts["pfb_mxu"] > 0 and counts["pll_bank"] > 0,
          f"slice 15 --live launches {counts}")
    wire.unlink()

    # ms a block: the sharded step (f32, bf16 planes off the wire) against
    # build_bank
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
    b16 = [u8_wire_to_planes(raw[2 * i * b:2 * (i + 1) * b], torch.bfloat16)
           for i in range(n_blocks)]
    step16, init16, _, _ = build_multimode_step(
        m, b, W2_FS, pattern, plane_dtype=torch.bfloat16, device="cuda")
    times = step_times({"build_bank": (bstep, lambda: binit("cuda"), blocks),
                        "sharded f32": (step, init, blocks),
                        "sharded bf16": (step16, init16, b16)}, reps=3)
    print("phase 15 ms a block, medians of 3 interleaved rounds (wall: the "
          "step's host clock; BPSK31: its share in BPSK31.apply, the "
          "kernel's launch; device: "
          "the kernels' time in a torch.profiler trace): "
          + ", ".join(f"{k} wall {v['wall_ms']:.2f} BPSK31 "
                      f"{v['bpsk31_ms']:.2f} device {v['device_ms']:.3f}"
                      for k, v in times.items()) + f" | {smi}")
    del x, blocks, b16, raw, c, bc
    torch.cuda.empty_cache()
    return dict(ok=ok, ok16=ok16, want=want, k4b=k4b,
                k4b_launches=bf16_launches, times=times, scan_s=scan_s,
                live_s=live_s, n_blocks=n_blocks)


# -- slice 16: BPSK31 on the card (csrc/psk31.cu) ------------------------------

def psk31_rx_blocks(torch, n, seed=16):
    """n blocks of 20,000 samples of a 20 kHz capture carrying BPSK31 at
    640 samples a symbol (random symbols, light noise) on the card."""
    from libsdr_tpu_torch.core import cplx

    rng = np.random.default_rng(seed)
    size = n * 20_000
    ph = np.repeat(np.cumsum(np.where(rng.random(size // 640 + 1) < 0.5,
                                      np.pi, 0.0)), 640)[:size]
    sig = (0.8 * np.exp(1j * ph) + 0.05 * (rng.normal(size=size) + 1j
                                           * rng.normal(size=size)))
    return [cplx.as_block(sig[i * 20_000:(i + 1) * 20_000].astype(
        np.complex64), torch.float32, "cuda") for i in range(n)]


def phase_slice16(torch, smi):
    """Slice 16, BPSK31's kernel (csrc/psk31.cu, entry
    ops/psk31.bpsk31_scan) beyond W2 (which phase W2 holds on its path's own
    call, and phase 15 drives through ``scan_multimode_sharded``):

    * at psk31_rx's shape (one channel of 2,000 samples), bit for bit the
      plain version, timed with CUDA events beside its plain version;
    * ``compile_chunked`` at K = 8 of psk31_rx's pipeline (IQBaseBand,
      BPSK31) and of W2's PSK31 group pipeline (``mode_parts``) on the
      group's rows (seed 1616): both capture, bit for bit their eager
      steps."""
    from libsdr_tpu_torch.core.graph import Pipeline
    from libsdr_tpu_torch.core.stream import StreamSpec
    from libsdr_tpu_torch.ops import BPSK31, IQBaseBand
    from libsdr_tpu_torch.tools import psk31_times as PT

    rx = PT.time_call(*PT.rx_inputs(), 20, smi)
    print(f"phase 16 BPSK31 kernel at psk31_rx's shape {rx['shape']}: "
          f"{rx['ms']:.4f} ms a call, {rx['device_ms']:.4f} on the device "
          f"({rx['ns_a_step']:.1f} ns a step), plain "
          f"{rx['plain_ms']:.1f} ms, bound {rx['bound_ms']:.6f} ms, chain "
          f"floor as counted from the source {rx['chain_floor_ms']:.4f} ms, "
          f"bit for bit the plain version: {rx['bit_exact']} | {smi}")
    check(rx["bit_exact"], "slice 16: psk31_rx's kernel call != plain")

    # compile_chunked at K = 8: psk31_rx's pipeline and W2's PSK31 group
    rx_pipe = Pipeline([IQBaseBand(fc=0.0, width=200.0, order=64,
                                   out_rate=2000.0, design="textbook"),
                        BPSK31()], name="psk31_rx")
    rx_pipe.bind(StreamSpec(np.complex64, 20_000, 20_000))
    rows, _, group_pipe = PT.w2_group(1616)
    captured = {}
    for label, pipe, xs in (("psk31_rx", rx_pipe, psk31_rx_blocks(torch, 8)),
                            ("W2 PSK31 group", group_pipe, rows)):
        took, launches = try_capture(torch, None, f"slice 16 {label}", pipe,
                                     xs, 8)
        check(took and launches.get("bpsk31_scan") == 8,
              f"slice 16: {label} compile_chunked: {launches}")
        captured[label] = launches
    print(f"phase 16 compile_chunked K = 8, bit for bit 8 eager steps: "
          f"{captured} (launches per capture)")
    del rows, group_pipe
    torch.cuda.empty_cache()
    return dict(rx=rx, captured=captured)


# -- slice 17: the channelizer outside K4's gate ------------------------------

GATE_CASES = ((16384, 8, 12, False), (64, 40, 48, False), (8192, 8, 12, True))


def phase_slice17(torch, smi):
    """Slice 17, the channelizer outside K4's gate (M > 8192, P > 32):
    ``Channelizer`` over three carried blocks on the card against the CPU
    (within 2e-5 of max |Y|, the channelizer bound), with its launch
    counts set to 0 just before each and read just after: no K4 launch
    outside the gate (``parallel/wideband.channelize_kernel_ok``: the card
    runs ``channelize_segment``, the counterpart of the JAX package's XLA
    body), one a block inside it (M = 8192).  A generator of its own."""
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import Channelizer
    from libsdr_tpu_torch.parallel.wideband import channelize_kernel_ok

    rng = np.random.default_rng(1717)
    out = {}
    for m, p, frames, kernel in GATE_CASES:
        blk = m * frames
        op = Channelizer(m, p)
        op.bind(L.StreamSpec(np.complex64, 1e6, blk))
        cg, cc, err = op.init_carry("cuda"), op.init_carry("cpu"), 0.0
        set_counts_zero(all_entries())
        for _ in range(3):
            x = (rng.normal(size=blk) + 1j * rng.normal(size=blk)).astype(
                np.complex64)
            xg = Complex(torch.tensor(x.real, device="cuda"),
                         torch.tensor(x.imag, device="cuda"))
            check(channelize_kernel_ok(xg, m, p) == kernel,
                  f"channelizer M={m} P={p}: the route predicate")
            cg, yg = op.apply(cg, xg)
            cc, yc = op.apply(cc, Complex(torch.tensor(x.real),
                                          torch.tensor(x.imag)))
            scale = float(max(yc.re.abs().max(), yc.im.abs().max()))
            err = max(err, float((yg.re.cpu() - yc.re).abs().max()) / scale,
                      float((yg.im.cpu() - yc.im).abs().max()) / scale)
        torch.cuda.synchronize()
        launches = {e.__name__: e.launches for e in all_entries()
                    if e.launches}
        want = {"pfb_mxu": 3} if kernel else {}
        print(f"phase 17 Channelizer({m}, {p}) x 3 blocks of {frames} "
              f"frames on the card: {err:.2e} of max |Y| from the CPU "
              f"(bound 2e-5), launches {launches} "
              f"({'inside' if kernel else 'outside'} K4's gate) | {smi}")
        check(err < 2e-5, f"channelizer M={m} P={p}: {err:.2e} from the CPU")
        check(launches == want, f"channelizer M={m} P={p}: launches "
              f"{launches}, want {want}")
        out[(m, p)] = dict(err=err, launches=launches)
    torch.cuda.empty_cache()
    return out


def all_entries():
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops import fir_mxu as M
    from libsdr_tpu_torch.ops.pfb import pfb_mxu
    from libsdr_tpu_torch.ops.pll import pll, pll_bank, window_pack
    from libsdr_tpu_torch.ops.fixedpoint import deemph_int
    from libsdr_tpu_torch.ops.psk31 import bpsk31_scan

    return (F.fir_fm_exact, F.fir_exact, F.fir_am_exact, F.fir_usb_exact,
            F.fir_afsk_exact, pll, pll_bank, pfb_mxu, M.fir_mxu,
            M.fir_fm_mxu, bpsk31_scan, deemph_int, window_pack)


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
    from libsdr_tpu_torch import native
    t0 = time.perf_counter()
    native_path, _ = native.build()
    native.get_lib()
    print(f"phase 2 native host runtime (g++): {time.perf_counter() - t0:.2f}"
          f" s -> {native_path}")
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
    afsk_worst = phase_afsk_parity(torch, L, gen)
    print(f"phase 3 parity K1e: max disc error {afsk_worst:.3e} of max "
          f"|disc| (bound {AFSK_BOUND:g})")
    pll_taken = phase_pll_parity(torch)
    wp = phase_window_pack(torch, smi)
    k4_worst, k4_cases = phase_k4_parity(torch, gen)
    mxu_worst, mxu_cases = phase_mxu_parity(torch, gen)
    tc_worst, tc_cases = phase_tc_parity(torch, L, gen)
    print(f"phase 3 parity tc route (csrc/fir_tc.cu): {tc_cases} cases, "
          f"worst K1a {tc_worst['k1a split']:.3e} rad vs split (bound "
          f"{TC_SPLIT_FM:g}), {tc_worst['k1a plain']:.3e} rad vs plain "
          f"(bound {ERR_BOUND:g}); K6 {tc_worst['k6 split']:.3e} vs split "
          f"(bounds {TC_SPLIT_FM:g} rad fm, {TC_SPLIT_REL:g} am), "
          f"{tc_worst['k6 plain']:.3e} vs plain (bounds {ERR_BOUND:g} rad "
          f"fm, {REL_BOUND:g} am, {AGC_BOUND:g} AGC); K1b/K1c/K1d "
          f"{tc_worst['k1bc split']:.3e} vs split (bound {TC_SPLIT_REL:g}), "
          f"{tc_worst['k1bc plain']:.3e} vs plain (bounds {REL_BOUND:g}, "
          f"{AGC_BOUND:g} AGC); K5 {tc_worst['k5 split']:.3e} vs split, "
          f"{tc_worst['k5 plain']:.3e} vs plain (bound {REL_BOUND:g})")

    # Kernel vs plain at the main path's shapes, timed with CUDA events,
    # and on two channels against the split emulation of the tc route, at
    # 'high' and at 'fast'.
    from libsdr_tpu_torch.ops import fir_tc as TC
    from libsdr_tpu_torch.ops.fir import set_mxu_precision
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
        n0 = fir_fm_exact.routes["tc"]
        (ok_, _), (op_, _) = run_pair(op, x, carry, True)
        check(fir_fm_exact.routes["tc"] == n0 + 1, "main shape off tc")
        err = float((ok_ - op_).abs().max())
        del op_
        check(err < ERR_BOUND, f"main-shape kernel vs plain {label}: {err}")
        args = (x, op._taps(x.device), 4, carry[0], carry[1], op._rot,
                op._gain)
        kw = dict(deemph_ab=op._dab, dstate=carry[2])
        two = (x[:2], args[1], 4, carry[0][:2], carry[1][:2], op._rot,
               op._gain)
        kw2 = dict(deemph_ab=op._dab, dstate=carry[2][:2])
        e_split = {}
        for fast in (False, True):
            passes = TC.passes_for(x.re.dtype, fast)
            try:
                set_mxu_precision("fast" if fast else "high")
                got = fir_fm_exact(*args, **kw)[0][:2]
                emu = TC.fm_exact_split(*two, **kw2, passes=passes)[0]
                torch.cuda.synchronize()
                e_split[passes] = float((got - emu).abs().max())
                if fast:
                    fast_ms = cuda_ms(torch, lambda: fir_fm_exact(*args,
                                                                  **kw), 5)
            finally:
                set_mxu_precision("high")
            del got, emu
            check(e_split[passes] < TC_SPLIT_FM,
                  f"main-shape {label} {passes} passes vs split: "
                  f"{e_split[passes]}")
        ms = cuda_ms(torch, lambda: fir_fm_exact(*args, **kw), 5)
        plain_ms = cuda_ms(torch, lambda: fir_fm_exact_plain(*args, **kw), 2)
        main[label] = (err, ms, plain_ms, e_split, fast_ms)
        print(f"phase 3 main shape {label} ({CHANNELS}x{BLOCK}, T=67, D=4, "
              f"tc route): max_abs_err={err:.3e} rad vs plain (bound "
              f"{ERR_BOUND:g}), vs split on 2 channels "
              + ", ".join(f"{p} passes {e:.3e}" for p, e in e_split.items())
              + f" rad (bound {TC_SPLIT_FM:g}); kernel {ms:.3f} ms "
              f"('fast' {fast_ms:.3f}), plain {plain_ms:.3f} ms | {smi}")
    torch.cuda.synchronize()

    # Phase 4: the main path through the user's entry points, then the
    # banks.
    from libsdr_tpu_torch.ops import fir_fm as F
    _, launches = drive_path(
        torch, L, "main path",
        lambda: [IQBaseBand(fc=FS / 8, width=FS / 4.8, order=64, decim=4,
                            design="textbook"), FMDemod(), FMDeemph()],
        BLOCK, x32, BLOCK // 4,
        [F.fir_fm_exact, F.fir_exact, F.fir_am_exact, F.fir_usb_exact],
        "tc")
    fast_snr, fast_flat = phase_fast_snr(torch, x32, smi)
    del x32, xr, xi
    torch.cuda.empty_cache()
    banks = phase_banks(torch, L, gen, smi)
    # The digital receive paths, each driven with the launch counts set to
    # 0 just before it and read just after.
    p1 = phase_p1(torch, L, gen, smi)
    p2 = phase_p2(torch, L, gen, smi)
    p3 = phase_p3(torch, L, gen, smi)
    # The wideband paths of slice 4, likewise.
    w1 = phase_w1(torch, gen, smi)
    wfm = phase_wfm(torch, gen, smi)
    w2 = phase_w2(torch, gen, smi)
    # Slice 5: F1, the arbitrary-offset FIR bank (K5), and K6 at full width.
    f1, f1_launches = phase_f1(torch, L, gen, smi)
    k6, k6_launches = phase_k6(torch, L, gen, smi)
    # Slice 11: chunked dispatch as one CUDA graph, the in-flight window,
    # checkpoint/resume, the Q14 chain and the resamplers.
    s11 = phase_slice11(torch, L, smi)

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
        phase_digital_apps(Path(tmp))
        phase_wide_apps(Path(tmp))
    # Slice 14: the native host runtime, file and live ingest, the APRS
    # service, each path with its launch counts set to 0 just before it.
    with tempfile.TemporaryDirectory() as tmp:
        s14 = phase_slice14(torch, smi, Path(tmp))
    # Slice 15: the sharded multimode bank at n == 1, --pattern and --bf16.
    with tempfile.TemporaryDirectory() as tmp:
        s15 = phase_slice15(torch, smi, Path(tmp))
    # Slice 16: BPSK31 at psk31_rx's shape and in captured pipelines (on
    # W2's paths: phases W2 and 15).
    s16 = phase_slice16(torch, smi)
    # Slice 17: the channelizer outside K4's gate, card against CPU.
    s17 = phase_slice17(torch, smi)

    # The kernels' record, float32 planes.  Bounds from this run's shapes:
    # bytes (planes read once, outputs written once) and float32 operations
    # (an FMA counts two; the FIR's 8T per output, the discriminator and
    # the epilogues a few tens).
    # K1a on the tc route: its FIR's 8T operations an output in its three
    # bf16 passes on the tensor cores, the discriminator and de-emphasis's
    # ~50 on the CUDA cores; the bytes as before.
    n_main = BLOCK // 4
    err, ms, plain_ms, _, _ = main["f32"]
    b_ms, b_by = bound_tc(CHANNELS * (8 * BLOCK + 4 * n_main),
                          CHANNELS * n_main * 3 * 8 * 67,
                          CHANNELS * n_main * 50)
    plan = TC.tc_plan(67, 4, 4, 3)
    for label, isz, passes in (("f32", 4, 3), ("bf16", 2, 2)):
        nb = CHANNELS * (2 * isz * BLOCK + 4 * n_main)
        run_ops = CHANNELS * n_main * TC.mma_ops(67, 4, plan, passes)
        print(f"bound K1a tc route {label} planes: bytes "
              f"{nb / HBM_BYTES_PER_S * 1e3:.3f} ms; tensor cores "
              f"{CHANNELS * n_main * passes * 8 * 67 / FLOPS_BF16_TC * 1e3:.3f}"
              f" ms dense ({passes} passes of 8T), "
              f"{run_ops / FLOPS_BF16_TC * 1e3:.3f} ms as run (the band's "
              f"m16n8k16 tiles, S={plan.S}); epilogue "
              f"{CHANNELS * n_main * 50 / FLOPS_F32 * 1e3:.3f} ms; kernel "
              f"{main[label][1]:.3f} ms")
    record = [dict(name="fir_fm_exact", route="cuda",
                   source="libsdr_tpu_torch/csrc/fir_tc.cu",
                   replaces="libsdr_tpu/ops/pallas_fir_mxu.py:777",
                   launches=launches, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None)]
    # The banks' kernels, each on the route its shape takes by plane dtype
    # (BANK_ROUTES; K1c and K1d with the AGC passes of agc.cu), each bound
    # computed once
    # (bank_bound) for its bound line and its record: the keys of float32
    # planes, and bf16_* those of bfloat16 planes.
    for label, name in (("K1b DDC bank", "fir_exact"),
                        ("K1c AM bank", "fir_am_exact"),
                        ("K1d USB bank", "fir_usb_exact")):
        res, _, n_launch, d, b, t, routes = banks[name]
        row = dict(name=name, route="cuda",
                   replaces="libsdr_tpu/ops/pallas_fir_mxu.py:777",
                   launches=n_launch,
                   library_ms=banks["library_fir_exact"]
                   if name == "fir_exact" else None)
        for plane, isz in (("f32", 4), ("bf16", 2)):
            err, ms, plain_ms = res[plane]
            r = routes[plane]
            b_ms, b_by, text = bank_bound(TC, name, r, isz, b, d, t)
            print(f"bound {label} {r} route {plane} planes: {text}; kernel "
                  f"{ms:.3f} ms")
            pre = "" if plane == "f32" else "bf16_"
            row.update({
                pre + "source": f"libsdr_tpu_torch/csrc/{ROUTE_SOURCES[r]}",
                pre + "kernel_route": r, pre + "max_abs_err": err,
                pre + "ms": ms, pre + "plain_ms": plain_ms,
                pre + "bound_ms": b_ms, pre + "bound_by": b_by})
        record.append(row)
    # K1e at P1 on the tc route (kernel_route: the routes its launches took)
    err, ms, plain_ms, (b_ms, b_by) = p1["f32"]["k1e"]
    record.append(dict(
        name="fir_afsk_exact", route="cuda",
        source="libsdr_tpu_torch/csrc/fir_tc.cu",
        replaces="libsdr_tpu/ops/pallas_fir_mxu.py:777",
        launches=p1["f32"]["counts"]["fir_afsk_exact"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
        kernel_route="+".join(r for r, n in p1["f32"]["k1e_routes"].items()
                              if n)))
    # K2 and K3: kernel and plain version timed on the same whole block
    # (the floor of the recurrence's chain, a latency and not a bound of
    # bytes or operations, is in the phases' lines)
    ms, plain_ms, _, _, (b_ms, b_by) = p1["f32"]["k2"]
    record.append(dict(
        name="pll", route="cuda", source="libsdr_tpu_torch/csrc/bitsync.cu",
        replaces="libsdr_tpu/ops/pallas_bitsync.py:128",
        launches=p1["f32"]["counts"]["pll"], max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
    ms, plain_ms, (b_ms, b_by) = p3["k3"]
    record.append(dict(
        name="pll_bank", route="cuda",
        source="libsdr_tpu_torch/csrc/bitsync.cu",
        replaces="libsdr_tpu/ops/pallas_bitsync.py:504",
        launches=p3["counts"]["pll_bank"], max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
    # the scanner's compaction at the pager cell's shape, with W1's launches
    record.append(dict(
        name="window_pack", route="cuda",
        source="libsdr_tpu_torch/csrc/window_pack.cu",
        replaces="libsdr_tpu/parallel/wideband.py:361",
        launches=w1["f32"]["counts"]["window_pack"], max_abs_err=0.0,
        ms=wp["ms"], plain_ms=wp["plain_ms"], bound_ms=wp["bound_ms"],
        bound_by="bytes", library_ms=None, device_ms=wp["device_ms"]))
    # K4, each variant on the path that runs it: the demod variant at W1
    # (1024 x 65,536 frames, float32 planes), the channel variant at W2
    # (256 x 12,288 frames), each with that run's launches; ms with CUDA
    # events as every row's, device_ms from a CUDA graph (no host time);
    # kernel_route, the route of csrc/pfb.cu the path's launches took;
    # library: the MAC plus torch.fft (cuFFT), several calls
    for name, res, launches, routes in (
            ("pfb_mxu", w1["f32"]["k4"], w1["f32"]["counts"]["pfb_mxu"],
             w1["f32"]["k4_routes"]),
            ("pfb_mxu:channel", w2["k4c"], w2["counts"]["pfb_mxu"],
             w2["k4_routes"])):
        e, ms, plain_ms, lib_ms, (b_ms, b_by), device_ms = res
        record.append(dict(
            name=name, route="cuda", source="libsdr_tpu_torch/csrc/pfb.cu",
            replaces="libsdr_tpu/ops/pallas_pfb.py:135", launches=launches,
            max_abs_err=e[0], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, device_ms=device_ms,
            kernel_route="+".join(r for r, n in routes.items() if n)))
    # K4's channel variant with bf16 planes off the u8 wire, at W2 through
    # multimode --raw --bf16 --pattern (slice 15)
    e, ms, plain_ms, lib_ms, (b_ms, b_by), device_ms = s15["k4b"]
    record.append(dict(
        name="pfb_mxu:channel:bf16", route="cuda",
        source="libsdr_tpu_torch/csrc/pfb.cu",
        replaces="libsdr_tpu/ops/pallas_pfb.py:135",
        launches=s15["k4b_launches"], max_abs_err=e[0], ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        device_ms=device_ms, kernel_route="stream"))
    # BPSK31 at W2 on the path's call of block 2 (phase W2; the floor of
    # its chain, counted and not measured, is in the phase lines), and at
    # psk31_rx's shape (rx_*)
    k31 = w2["bpsk31"]
    record.append(dict(
        name="bpsk31_scan", route="cuda",
        source="libsdr_tpu_torch/csrc/psk31.cu",
        replaces="libsdr_tpu/ops/psk31.py:183",
        launches=w2["counts"]["bpsk31_scan"], max_abs_err=k31["err"],
        ms=k31["ms"], plain_ms=k31["plain_ms"], bound_ms=k31["bound"][0],
        bound_by=k31["bound"][1], library_ms=None,
        device_ms=k31["device_ms"], rx_ms=s16["rx"]["ms"],
        rx_device_ms=s16["rx"]["device_ms"],
        rx_plain_ms=s16["rx"]["plain_ms"], rx_bound_ms=s16["rx"]["bound_ms"]))
    # FMDeemphInt's kernel on the Q14 chain's call of block 1 (slice 11;
    # its chain, as estimated from the source, is in the phase line)
    q14 = s11["q14_k"]
    record.append(dict(
        name="deemph_int", route="cuda",
        source="libsdr_tpu_torch/csrc/fixedpoint.cu",
        replaces="libsdr_tpu/ops/fixedpoint.py:334",
        launches=q14["launches"], max_abs_err=q14["err"], ms=q14["ms"],
        plain_ms=q14["plain_ms"], bound_ms=q14["bound"][0],
        bound_by=q14["bound"][1], library_ms=None,
        device_ms=q14["device_ms"]))
    # K5 at F1 (offset 0; library: the strided conv1d over concat(tail,
    # x)): float32 planes' numbers under the common keys, bfloat16 planes'
    # under bf16_*, as the banks' rows; K6 at full width in fm with
    # de-emphasis
    row = dict(name="fir_mxu", route="cuda",
               replaces="libsdr_tpu/ops/pallas_fir_mxu.py:204",
               launches=f1_launches)
    for plane in ("f32", "bf16"):
        res = f1[(0, plane)]
        pre = "" if plane == "f32" else "bf16_"
        row.update({
            pre + "source":
                f"libsdr_tpu_torch/csrc/{ROUTE_SOURCES[res['route']]}",
            pre + "kernel_route": res["route"],
            pre + "max_abs_err": res["err"], pre + "ms": res["ms"],
            pre + "plain_ms": res["plain_ms"],
            pre + "bound_ms": res["bound"][0],
            pre + "bound_by": res["bound"][1],
            pre + "library_ms": res["lib_ms"]})
    record.append(row)
    res = k6[("fm", "f32")]
    record.append(dict(
        name="fir_fm_mxu", route="cuda",
        source="libsdr_tpu_torch/csrc/fir_tc.cu",
        replaces="libsdr_tpu/ops/pallas_fir_mxu.py:410",
        launches=k6_launches, max_abs_err=res["err"], ms=res["ms"],
        plain_ms=res["plain_ms"], bound_ms=res["bound"][0],
        bound_by=res["bound"][1], library_ms=None))
    print(f"tc route ({tc_cases} parity cases): K1a at the "
          f"main shape {main['f32'][1]:.3f} / {main['bf16'][1]:.3f} ms (f32 "
          f"/ bf16 planes; 'fast' {main['f32'][4]:.3f} / "
          f"{main['bf16'][4]:.3f}), K6 fm "
          f"{k6[('fm', 'f32')]['ms']:.3f} / {k6[('fm', 'bf16')]['ms']:.3f}"
          f", am + AGC {k6[('am', 'f32')]['ms']:.3f} / "
          f"{k6[('am', 'bf16')]['ms']:.3f} ms; 'fast' vs 'high' "
          f"{fast_snr:.1f} dB (K1b, K1d, K5: "
          + ", ".join(f"{v:.1f}" for v in fast_flat.values()) + " dB)")
    print(f"slice 5: K5/K6 parity {mxu_cases} cases (worst K5 "
          f"{mxu_worst['fir_mxu']:.2e}, K6 fm {mxu_worst['fm']:.2e} rad); F1 "
          + ", ".join(f"offset {o} {p} {r['ms_step']:.3f}"
                      for (o, p), r in f1.items())
          + " ms/step; K6 " + ", ".join(f"{m} {p} {r['ms']:.3f}"
                                        for (m, p), r in k6.items())
          + " ms a call")
    print(f"wideband: K4 parity {sum(k4_cases.values())} cases {k4_cases} "
          f"(worst {k4_worst['y']:.2e}"
          f" of max |Y|); W1 {w1['f32']['ms_block']:.2f} / "
          f"{w1['bf16']['ms_block']:.2f} ms/block (f32 / bf16 planes), "
          f"{w1['f32']['decoded']}/{w1['f32']['sent']} pages; WidebandFM "
          f"{wfm['f32']:.3f} / {wfm['bf16']:.3f} ms/step; W2 "
          f"{w2['ms_block']:.1f} ms/block, decoded {w2['decoded']}")
    print(f"PLL (csrc/bitsync.cu): K2 P1 {p1['f32']['k2'][0]:.3f} ms, P2 "
          f"{p2['k2_ms']:.3f}, W1 {w1['f32']['k2_ms']:.3f}; K3 P3 "
          f"{p3['k3'][0]:.3f}, W2 {w2['k3_ms']:.3f} ms; parity layouts "
          f"{pll_taken} (lanes a warp: calls)")
    print(f"paths: P1 {p1['f32']['ms_step']:.2f} / "
          f"{p1['bf16']['ms_step']:.2f} ms/step (f32 / bf16 planes), P2 "
          f"{p2['ms_step']:.2f} ms/step with {p2['decoded']}/256 pages, P3 "
          f"{p3['ms_step']:.2f} ms/step")
    big, small = 1 << 19, 1 << 16
    print("slice 11: streaming steps alone f32 K=1 / K=8, 2^19 "
          f"{s11[(big, 'f32', 1)]['device_ms']:.3f} / "
          f"{s11[(big, 'f32', 8)]['device_ms']:.3f} ms, 2^16 "
          f"{s11[(small, 'f32', 1)]['device_ms']:.3f} / "
          f"{s11[(small, 'f32', 8)]['device_ms']:.3f} ms a block; "
          f"run_pipeline 2^19 K=1 {s11[(big, 'f32', 1)]['run_ms']:.2f} ms a "
          f"block; captured {s11['captured']}; Q14 chain "
          f"{s11['q14_ms']:.1f} ms a block (FMDeemphInt "
          f"{s11['q14_deemph_ms']:.2f}, its kernel "
          f"{s11['q14_k']['device_ms']:.4f} on the device)")
    print("slice 14: pump-fed P2 " + ", ".join(
        f"{p} {r['ms_fed']:.2f} ms a step (take {r['take_ms']:.2f}, "
        f"upload {r['up_ms']:.2f}; {r['ms_mem']:.2f} in memory, "
        f"{r['mbps']:.0f} MB/s of wire, the pump alone "
        f"{r['pump_mbps']:.0f}), {r['decoded']}/256 pages, host "
        f"decode {r['nat_s']:.3f} s native / {r['py_s']:.2f} s Python"
        for p, r in s14["p2"].items()) + "; live W1 " + ", ".join(
        f"{p} {r['decoded']}/{r['sent']} pages in {r['secs']:.1f} s"
        for p, r in s14["w1"].items()))
    print("slice 15: W2 through scan_multimode_sharded n == 1, decoded "
          f"{s15['ok']} of {s15['want']} (f32), {s15['ok16']} (--raw "
          f"--bf16), bit for bit build_bank, --live --bf16 = --raw; ms a "
          "block (wall/device) " + ", ".join(
              f"{k} {v['wall_ms']:.2f}/{v['device_ms']:.3f}"
              for k, v in s15["times"].items())
          + f"; K4 bf16 channel {s15['k4b'][1]:.4f} ms a call "
          f"({s15['k4b'][5]:.4f} on the device, bound "
          f"{s15['k4b'][4][0]:.4f}); two ranks on one card not run (gloo "
          "refuses send/recv of CUDA tensors)")
    bb = s15["times"]["build_bank"]
    print(f"slice 16: BPSK31 on the card (csrc/psk31.cu): W2 decoded "
          f"{w2['decoded']} (scan_multimode), {s15['ok']} (sharded n == 1); "
          f"kernel {k31['ms']:.4f} ms a W2 block ({k31['device_ms']:.4f} on "
          f"the device; plain {k31['plain_ms']:.1f}, bound "
          f"{k31['bound'][0]:.5f}), bit for bit the plain version on all "
          f"64 channels; {s16['rx']['device_ms']:.4f} on the device at "
          f"psk31_rx's shape, bit for bit; compile_chunked K = 8 captures "
          f"{sorted(s16['captured'])}; W2 build_bank wall "
          f"{bb['wall_ms']:.3f} / device {bb['device_ms']:.3f} ms a block")
    print("slice 17: FMDeemphInt on the card (csrc/fixedpoint.cu), bit for "
          f"bit its plain version, {s11['q14_k']['device_ms']:.4f} ms a Q14 "
          f"block on the device (plain {s11['q14_k']['plain_ms']:.1f}); the "
          "channelizer outside K4's gate "
          + ", ".join(f"M={m} P={p} {v['err']:.1e} launches {v['launches']}"
                      for (m, p), v in s17.items()))
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
