"""K1b (``ops/fir_fm.py::fir_exact``, mode fir), K1c (``fir_am_exact``,
mode am) and K1d (``fir_usb_exact``, mode usb), with or without the AGC,
and K5 (``ops/fir_mxu.py``: ``fir_offset`` and ``fir_mxu``) on the
tensor-core route of ``csrc/fir_tc.cu``, held against their split
emulation (``ops/fir_tc.py``) and their plain versions: one case, as the
card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` run it.

    from libsdr_tpu_torch.tools.k1_parity import k5_case, tc_case
    e_split, e_plain = tc_case(gen, "am", True, torch.bfloat16, 40, 71, 64)
    e_split, e_plain = k5_case(gen, torch.float32, 4, 67, 64)

Needs one CUDA card and nvcc.  The gates: against the split emulation (the
same bf16 products summed in float32 in another order, ~1e-7 of |y|
apart) SPLIT_REL of the largest output; against the float32 plain
version REL_BOUND of the largest output, or AGC_BOUND with the AGC (the
gates of ``chip_smoke.py`` and PERF.md §2).  'fast' (one pass) is held to
the split emulation only.
"""

from __future__ import annotations

import numpy as np
import torch

from libsdr_tpu_torch.core.cplx import Complex

FS = 960_000.0          # the sample rate the AGC's time constant is set at
N_OUT = 3 * 4096 + 333  # outputs a channel a block: K > 1, a ragged tile
USB_HZ = 1500.0         # mode usb's NCO offset from the channel
SPLIT_REL = 2e-6
REL_BOUND = 1e-5
AGC_BOUND = 1e-4


def _noise(gen, shape, dtype, device):
    return Complex(torch.randn(shape, generator=gen, device=device),
                   torch.randn(shape, generator=gen, device=device)
                   ).to(dtype)


def _rel(got: Complex, ref: Complex) -> float:
    scale = float(torch.maximum(ref.re.abs().max(), ref.im.abs().max()))
    return max(float((got.re - ref.re).abs().max()),
               float((got.im - ref.im).abs().max())) / scale


def plain_err(got, ref, agc: bool) -> tuple[float, float]:
    """(error, gate) of a K1b/K1c result against its plain version: y or
    the audio relative to the largest output (REL_BOUND); with the AGC
    the audio absolute and the exported state relative (AGC_BOUND)."""
    if isinstance(got, Complex):
        return _rel(got, ref), REL_BOUND
    (out, sd), (rout, rsd) = got, ref
    if not agc:
        return (float((out - rout).abs().max())
                / float(rout.abs().max()), REL_BOUND)
    return max(float((out - rout).abs().max()),
               float(((sd - rsd) / rsd).abs().max())), AGC_BOUND


def tc_case(gen, mode: str, agc: bool, dtype, d: int, t: int, c: int,
            device="cuda", chunks=None) -> tuple[float, float]:
    """A warm block and three carry-chained blocks of N_OUT outputs a
    channel of noise (or, given ``chunks``, chunks * 4096 + 333 outputs,
    which the launches cut into that many chunks on a few channels), from
    a nonzero tail and AGC state (and in mode usb a unit phasor stepped a
    block at a time), at the current precision (``set_mxu_precision``):
    every launch on the tc route in K > 1 chunks (the AGC's too), or in
    ``chunks``; y, or the audio and the AGC's exported state, against the
    split emulation cut into the launch's chunks within SPLIT_REL, and
    with 2 or 3 passes against the plain version under its gate.  Returns
    (worst vs split, worst vs plain: 0.0 for one pass); raises
    AssertionError naming the case."""
    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops import fir_tc as TC
    from libsdr_tpu_torch.ops.fir import mxu_precision

    lib = _build.library()
    passes = TC.passes_for(dtype, mxu_precision() == "fast")
    n_out = N_OUT if chunks is None else chunks * 4096 + 333
    name = (f"{mode}{'+agc' if agc else ''} {str(dtype)[6:]} D={d} T={t} "
            f"C={c} passes={passes} n={n_out}")
    b = d * n_out
    if agc:
        assert lib.sdr_agc_chunks(c, n_out) > 1, f"{name}: AGC K = 1"
    taps = Complex(torch.randn(t, generator=gen, device=device) / t ** 0.5,
                   torch.randn(t, generator=gen, device=device) / t ** 0.5)
    lam = float(np.exp(-1.0 / (0.1 * FS / d)))
    ab, gain = ((lam, 1 - lam), 0.125) if agc else (None, 1.0)
    sd = torch.full((c,), 0.5, device=device)
    tail = _noise(gen, (c, t - 1), dtype, device)
    th = 2 * np.pi * USB_HZ * d / FS
    ramp = Complex(torch.tensor(np.cos(th * np.arange(n_out)),
                                dtype=torch.float32, device=device),
                   torch.tensor(-np.sin(th * np.arange(n_out)),
                                dtype=torch.float32, device=device))
    a0 = np.exp(0.9j)
    kmode, entry, plain, split = {
        "fir": (F._MODE_FIR, F.fir_exact, F.fir_exact_plain,
                TC.fir_exact_split),
        "am": (F._MODE_AM, F.fir_am_exact, F.fir_am_exact_plain,
               TC.am_exact_split),
        "usb": (F._MODE_USB, F.fir_usb_exact, F.fir_usb_exact_plain,
                TC.usb_exact_split)}[mode]
    e_split = e_plain = 0.0
    for k in range(4):
        x = _noise(gen, (c, b), dtype, device)
        ph = Complex(torch.tensor(a0.real, dtype=torch.float32,
                                  device=device),
                     torch.tensor(a0.imag, dtype=torch.float32,
                                  device=device))
        args = {"fir": (x, taps, d, tail),
                "am": (x, taps, d, tail, gain, ab, sd),
                "usb": (x, taps, d, tail, ph, ramp, gain, ab, sd)}[mode]
        kk, route = F._chunks(name, lib, kmode, c, n_out, t, d, 0, x.re)
        assert route == "tc" and (kk > 1 if chunks is None
                                  else kk == chunks), (
            f"{name}: {route}, K = {kk}")
        n0 = entry.routes["tc"]
        got = entry(*args)
        emu = split(*args, passes=passes, chunks=kk)
        torch.cuda.synchronize()
        assert entry.routes["tc"] == n0 + 1, f"{name}: not on the tc route"
        out = got.re if mode == "fir" else got[0]
        assert tuple(out.shape) == (c, n_out), f"{name}: {out.shape}"
        if mode == "fir":
            assert bool(torch.isfinite(got.re).all()
                        and torch.isfinite(got.im).all()), f"{name}: inf"
            es = _rel(got, emu)
        else:
            assert bool(torch.isfinite(got[0]).all()), f"{name}: inf"
            es = float((got[0] - emu[0]).abs().max()) / float(
                emu[0].abs().max())
            if agc:
                es = max(es, float(((got[1] - emu[1]) / emu[1]).abs().max()))
        assert es < SPLIT_REL, f"{name} block {k} vs split: {es}"
        e_split = max(e_split, es)
        if passes > 1 and k:  # block 0 warms the carries up
            ep, gate = plain_err(got, plain(*args), agc)
            assert ep < gate, f"{name} block {k} vs plain: {ep}"
            e_plain = max(e_plain, ep)
        if agc:
            sd = emu[1]
        tail = x[..., b - (t - 1):].map(torch.clone)
        a0 = a0 * np.exp(-1j * th * n_out)
    return e_split, e_plain


def k5_case(gen, dtype, d: int, t: int, c: int, device="cuda"
            ) -> tuple[float, float]:
    """K5 on the tc route at every window form its callers give it, on c
    channels of noise at the current precision: ``fir_offset`` (windows
    from the (C, T-1) tail: starts 1 - T, 2 - T and D - T, offsets 0, 1
    and D - 1, and start 0, offset T - 1; wrap 0) over a block of N_OUT *
    D + 2 samples (odd output counts at offsets 0 and 1, K > 1 chunks,
    ragged tiles) and ``fir_mxu`` (starts 0, D and 2D + 1, wrap 128*D: the
    last frame's windows read the frame before it) over 80 frames of 128
    outputs.  Each launch on the tc route; y against the split emulation
    (``fir_mxu_split``, cut into the launch's chunks) within SPLIT_REL of
    the largest, and with 2 or 3 passes against the plain version within
    REL_BOUND.  Returns (worst vs split, worst vs plain: 0.0 for one
    pass); raises AssertionError naming the case."""
    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops import fir_mxu as M
    from libsdr_tpu_torch.ops import fir_tc as TC
    from libsdr_tpu_torch.ops.fir import mxu_precision

    lib = _build.library()
    passes = TC.passes_for(dtype, mxu_precision() == "fast")
    taps = Complex(torch.randn(t, generator=gen, device=device) / t ** 0.5,
                   torch.randn(t, generator=gen, device=device) / t ** 0.5)
    x = _noise(gen, (c, N_OUT * d + 2), dtype, device)
    tail = _noise(gen, (c, t - 1), dtype, device)
    xm = _noise(gen, (c, 80 * 128 * d), dtype, device)
    forms = [("fir_offset", off, off - (t - 1), 0)
             for off in sorted({0, 1, d - 1, t - 1})]
    forms += [("fir_mxu", s0, s0, 128 * d) for s0 in (0, d, 2 * d + 1)]
    e_split = e_plain = 0.0
    for entry, off, s0, wrap in forms:
        name = (f"K5 {entry} {str(dtype)[6:]} D={d} T={t} C={c} s0={s0} "
                f"wrap={wrap} passes={passes}")
        if entry == "fir_offset":
            xin, b = x, x.re.shape[-1]
            n_out = (b - off - 1) // d + 1
            args = (x, taps, d, off, tail)
        else:
            xin, b = xm, xm.re.shape[-1]
            n_out = b // d
            args = (xm, taps, d, off)
        kk, route = F._chunks(name, lib, F._MODE_FIR, c, n_out, t, d, 0,
                              xin.re)
        assert route == "tc", f"{name}: {route}"
        n0 = M.fir_mxu.routes["tc"]
        got = getattr(M, entry)(*args)
        got = got[0] if entry == "fir_mxu" else got
        emu = TC.fir_mxu_split(xin, taps, d, s0, n_out, wrap,
                               tail if wrap == 0 else None, passes, kk)
        torch.cuda.synchronize()
        assert M.fir_mxu.routes["tc"] == n0 + 1, f"{name}: off the tc route"
        assert tuple(got.re.shape) == (c, n_out), f"{name}: {got.re.shape}"
        assert bool(torch.isfinite(got.re).all()
                    and torch.isfinite(got.im).all()), f"{name}: inf"
        es = _rel(got, emu)
        assert es < SPLIT_REL, f"{name} vs split: {es}"
        e_split = max(e_split, es)
        if passes > 1:
            ref = getattr(M, entry + "_plain")(*args)
            ref = ref[0] if entry == "fir_mxu" else ref
            ep = _rel(got, ref)
            assert ep < REL_BOUND, f"{name} vs plain: {ep}"
            e_plain = max(e_plain, ep)
    return e_split, e_plain
