"""K1b (``ops/fir_fm.py::fir_exact``, mode fir) and K1c
(``fir_am_exact``, mode am, with or without the AGC) on the tensor-core
route of ``csrc/fir_tc.cu``, held against their split emulation
(``ops/fir_tc.py``) and their plain versions: one case, as the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` run it.

    from libsdr_tpu_torch.tools.k1_parity import tc_case
    e_split, e_plain = tc_case(gen, "am", True, torch.bfloat16, 40, 71, 64)

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
            device="cuda") -> tuple[float, float]:
    """A warm block and three carry-chained blocks of N_OUT outputs a
    channel of noise, from a nonzero tail and AGC state, at the current
    precision (``set_mxu_precision``): every launch on the tc route in
    K > 1 chunks (the AGC's too); y, or the audio and the AGC's exported
    state, against the split emulation cut into the launch's chunks
    within SPLIT_REL, and with 2 or 3 passes against the plain version
    under its gate.  Returns (worst vs split, worst vs plain: 0.0 for one
    pass); raises AssertionError naming the case."""
    from libsdr_tpu_torch import _build
    from libsdr_tpu_torch.ops import fir_fm as F
    from libsdr_tpu_torch.ops import fir_tc as TC
    from libsdr_tpu_torch.ops.fir import mxu_precision

    lib = _build.library()
    passes = TC.passes_for(dtype, mxu_precision() == "fast")
    name = (f"{mode}{'+agc' if agc else ''} {str(dtype)[6:]} D={d} T={t} "
            f"C={c} passes={passes}")
    b = d * N_OUT
    if agc:
        assert lib.sdr_agc_chunks(c, N_OUT) > 1, f"{name}: AGC K = 1"
    taps = Complex(torch.randn(t, generator=gen, device=device) / t ** 0.5,
                   torch.randn(t, generator=gen, device=device) / t ** 0.5)
    lam = float(np.exp(-1.0 / (0.1 * FS / d)))
    ab, gain = ((lam, 1 - lam), 0.125) if agc else (None, 1.0)
    sd = torch.full((c,), 0.5, device=device)
    tail = _noise(gen, (c, t - 1), dtype, device)
    kmode = F._MODE_FIR if mode == "fir" else F._MODE_AM
    entry = F.fir_exact if mode == "fir" else F.fir_am_exact
    plain = F.fir_exact_plain if mode == "fir" else F.fir_am_exact_plain
    split = TC.fir_exact_split if mode == "fir" else TC.am_exact_split
    e_split = e_plain = 0.0
    for k in range(4):
        x = _noise(gen, (c, b), dtype, device)
        args = ((x, taps, d, tail) if mode == "fir"
                else (x, taps, d, tail, gain, ab, sd))
        kk, route = F._chunks(name, lib, kmode, c, N_OUT, t, d, 0, x.re,
                              cut_mode=kmode)
        assert route == "tc" and kk > 1, f"{name}: {route}, K = {kk}"
        n0 = entry.routes["tc"]
        got = entry(*args)
        emu = split(*args, passes=passes, chunks=kk)
        torch.cuda.synchronize()
        assert entry.routes["tc"] == n0 + 1, f"{name}: not on the tc route"
        out = got.re if mode == "fir" else got[0]
        assert tuple(out.shape) == (c, N_OUT), f"{name}: {out.shape}"
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
    return e_split, e_plain
