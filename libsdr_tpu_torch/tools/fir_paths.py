"""The staged, the warp and the tensor-core kernel of ``ops/fir_fm.py``,
stride by stride.

    python -m libsdr_tpu_torch.tools.fir_paths [--strides 5,8,16,24,40,80]
        [--modes fm,fir,am,usb,afsk] [--channels 64] [--block 16777216]
        [--out fir_paths.json]

Needs one CUDA card and nvcc.  Builds the kernel library three times, in
parallel: with every stride on the staged kernel (``SDR_STAGED_MAX_D``
large, ``SDR_TC_MAX_D=0``), with every stride on the warp kernel
(``SDR_STAGED_MAX_D=0``, ``SDR_TC_MAX_D=0``) and, for the modes of K1
with a tensor-core route (every mode: TC_MODES), with every stride whose
plan fits on the tensor-core kernel (``SDR_TC_MAX_D`` large).  Then, for
every mode (fm with de-emphasis, fir, am and usb with the AGC, afsk with
a 40-sample correlator), stride D and plane dtype, on C channels of about
``--block`` samples with T = order + D - 1 taps (the rx chains'
orders: 32 for fm and am, 64 for fir and usb; the AX.25 bank's 48 for
afsk), it holds the staged and the warp kernel against the plain
version twice: from the op's initial carry ("cold": block 0, zero
history) and from a warm carry (block 1, after the plain version ran
block 0).  It times each kernel on block 1 with CUDA events, in the order
staged, warp, tc, tc, warp, staged (tc in the modes of TC_MODES).  Each result
names the route its launches took.  One line per case, and all of them as
JSON in ``--out``.

Errors are those of chip_smoke.py: fm absolute (rad times the gain), fir
and AGC-free modes relative to the largest output, AGC absolute on the
audio and relative on the exported envelope, afsk relative to each
channel's largest |disc|.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import time
from unittest import mock

import numpy as np
import torch

from libsdr_tpu_torch import _build
from libsdr_tpu_torch.core.cplx import Complex

FS = 960_000.0
DEV = "cuda"
ORDER = {"fm": 32, "fir": 64, "am": 32, "usb": 64, "afsk": 48}
AFSK_L = 40   # the correlator window of mode afsk (the AX.25 bank's)
VARIANTS = {"staged": ("SDR_STAGED_MAX_D=1000000", "SDR_TC_MAX_D=0"),
            "warp": ("SDR_STAGED_MAX_D=0", "SDR_TC_MAX_D=0"),
            "tc": ("SDR_TC_MAX_D=1000000",)}
TC_MODES = ("fm", "fir", "am", "usb", "afsk")   # K1's modes on the tc route


def fm_planes(gen, c, b, d, t0):
    """(c, b) planar FM tones near FS/8 plus noise, on the card."""
    n = torch.arange(t0, t0 + b, dtype=torch.float64, device=DEV)
    xr = torch.empty((c, b), dtype=torch.float32, device=DEV)
    xi = torch.empty_like(xr)
    dev_hz = 0.15 * FS / d
    for ch in range(c):
        fc = FS / 8 + (ch % 7 - 3) * 0.01 * FS / d
        fm = 1000.0 + 100.0 * (ch % 5)
        ph = torch.remainder((2 * np.pi * fc / FS) * n - (dev_hz / fm)
                             * torch.cos((2 * np.pi * fm / FS) * n),
                             2 * np.pi)
        xr[ch] = torch.cos(ph).float()
        xi[ch] = torch.sin(ph).float()
    xr += 0.05 * torch.randn(xr.shape, generator=gen, device=DEV)
    xi += 0.05 * torch.randn(xi.shape, generator=gen, device=DEV)
    return Complex(xr, xi)


def noise_planes(gen, c, b):
    return Complex(torch.randn((c, b), generator=gen, device=DEV),
                   torch.randn((c, b), generator=gen, device=DEV))


class Case:
    """One mode at one stride: its entry, its plain version, the argument
    list for a state, the next state after a block, and the error."""

    def __init__(self, mode, d, c, b, gen):
        from libsdr_tpu_torch.ops import fir_fm as F

        self.mode, self.d, self.c, self.b = mode, d, c, b
        self.t = t = ORDER[mode] + d - 1
        self.gen = gen
        n_out = b // d
        name = {"fm": "fir_fm_exact", "fir": "fir_exact",
                "am": "fir_am_exact", "usb": "fir_usb_exact",
                "afsk": "fir_afsk_exact"}[mode]
        self.entry = getattr(F, name)
        self.plain = getattr(F, name + "_plain")
        tail = Complex(torch.zeros((c, t - 1), device=DEV),
                       torch.zeros((c, t - 1), device=DEV))
        if mode in ("fm", "afsk"):
            self.op = _fm_op(d, t, c, b, afsk=mode == "afsk")
            self.state0 = self.op.init_carry(DEV)
            return
        g = torch.Generator(device=DEV)
        g.manual_seed(1000 * d + t)
        self.taps = Complex(torch.randn(t, generator=g, device=DEV),
                            torch.randn(t, generator=g, device=DEV))
        self.taps = Complex(self.taps.re / t ** 0.5, self.taps.im / t ** 0.5)
        th = 2 * np.pi * 1500.0 * d / FS * np.arange(n_out)
        self.ramp = Complex(
            torch.tensor(np.cos(th), dtype=torch.float32, device=DEV),
            torch.tensor(-np.sin(th), dtype=torch.float32, device=DEV))
        self.ph = Complex(torch.tensor(0.6, device=DEV),
                          torch.tensor(0.8, device=DEV))
        lam = float(np.exp(-1.0 / (0.1 * FS / d)))
        self.ab = (lam, 1.0 - lam)
        self.state0 = (tail, torch.full((c,), 0.5, device=DEV))

    def block(self, k, dtype):
        if self.mode in ("fm", "afsk"):
            x = fm_planes(self.gen, self.c, self.b, self.d, k * self.b)
        else:
            x = noise_planes(self.gen, self.c, self.b)
        return x if dtype == torch.float32 else x.to(dtype)

    def args(self, x, state):
        d = self.d
        if self.mode == "afsk":
            op = self.op
            return ((x, op._taps(DEV), d, state[0], state[1], op._rot,
                     op._gain, op._on("mark", op._tones[0], DEV),
                     op._on("space", op._tones[1], DEV)) + tuple(state[2:]),
                    {})
        if self.mode == "fm":
            op = self.op
            return ((x, op._taps(DEV), d, state[0], state[1], op._rot,
                     op._gain), dict(deemph_ab=op._dab, dstate=state[2]))
        tail = state[0]
        if self.mode == "fir":
            return (x, self.taps, d, tail), {}
        if self.mode == "am":
            return (x, self.taps, d, tail, 0.125, self.ab, state[1]), {}
        return (x, self.taps, d, tail, self.ph, self.ramp, 0.125, self.ab,
                state[1]), {}

    def next_state(self, x, ref, state):
        tail = x[..., x.re.shape[-1] - (self.t - 1):].map(torch.clone)
        if self.mode == "afsk":
            n = x.re.shape[-1] // self.d
            return (tail, ref[1], (state[2] + n) % AFSK_L, ref[2], ref[3])
        if self.mode == "fm":
            out, y_last = ref
            return (tail, y_last, out[..., -1])
        if self.mode == "fir":
            return (tail,)
        return (tail, ref[1])

    def error(self, got, ref):
        if self.mode == "afsk":
            scale = ref[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            return float(((got[0] - ref[0]).abs() / scale).max())
        if self.mode == "fm":
            return float((got[0] - ref[0]).abs().max())
        if self.mode == "fir":
            scale = float(torch.maximum(ref.re.abs().max(),
                                        ref.im.abs().max()))
            return max(float((got.re - ref.re).abs().max()),
                       float((got.im - ref.im).abs().max())) / scale
        return max(float((got[0] - ref[0]).abs().max()),
                   float(((got[1] - ref[1]) / ref[1]).abs().max()))


def _fm_op(d, t, c, b, afsk=False):
    """The fused FM op (with de-emphasis), or the fused AFSK op with its
    tone rate set so that its window is AFSK_L."""
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.ops import (FMDeemph, FMDemod, FSKDetector,
                                      IQBaseBand)

    audio_fs = FS / d
    last = (FSKDetector(audio_fs / (AFSK_L + 0.5), 0.05 * audio_fs,
                        0.09 * audio_fs) if afsk else FMDeemph())
    rx = L.Pipeline([IQBaseBand(fc=FS / 8, width=min(FS / 4.8, 0.8 * FS / d),
                                order=t - d + 1, decim=d, design="textbook"),
                     FMDemod(), last])
    rx.bind(L.StreamSpec(np.complex64, FS, b, channels=(c,)))
    return rx.stages[0]


def cuda_ms(fn, reps=5):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def using(variant):
    """The wrappers of ops/fir_fm.py on one build of the library."""
    lib = _build.library(VARIANTS[variant])
    return mock.patch.object(_build, "library", lambda *a: lib)


def run_case(case, dtype):
    res = {"mode": case.mode, "D": case.d, "T": case.t, "C": case.c,
           "B": case.b, "planes": str(dtype)[6:]}
    x0 = case.block(0, dtype)
    a0, kw0 = case.args(x0, case.state0)
    ref0 = case.plain(*a0, **kw0)
    kernels = ("staged", "warp") + (("tc",) if case.mode in TC_MODES
                                    else ())
    for v in kernels:
        before = dict(case.entry.routes)
        with using(v):
            try:
                got = case.entry(*a0, **kw0)
            except ValueError as e:
                res[v] = {"outside_gate": str(e)}
                continue
        torch.cuda.synchronize()
        res[v] = {"err_cold": case.error(got, ref0),
                  "route": [r for r, n in case.entry.routes.items()
                            if n > before[r]][0]}
        if case.mode == "fm":
            bad = ((got[0] - ref0[0]).abs() > 1e-3).nonzero()
            res[v]["cold_outputs_off"] = int(bad.shape[0])
            res[v]["cold_first_off"] = bad[:4].tolist()
        del got
    state = case.next_state(x0, ref0, case.state0)
    del x0, a0, kw0, ref0
    x1 = case.block(1, dtype)
    a1, kw1 = case.args(x1, state)
    ref1 = case.plain(*a1, **kw1)
    for v in kernels:
        if "outside_gate" in res[v]:
            continue
        with using(v):
            got = case.entry(*a1, **kw1)
        torch.cuda.synchronize()
        res[v]["err_warm"] = case.error(got, ref1)
        del got
    del ref1
    for v in kernels + kernels[::-1]:
        if "outside_gate" in res[v]:
            continue
        with using(v):
            ms = cuda_ms(lambda: case.entry(*a1, **kw1))
        res[v].setdefault("ms", []).append(ms)
    del x1, a1, kw1
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--strides", default="5,8,16,24,40,80")
    p.add_argument("--modes", default="fm,fir,am,usb")
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--block", type=int, default=1 << 24)
    p.add_argument("--out", default="fir_paths.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        list(pool.map(_build.build, VARIANTS.values()))
    print(f"built {len(VARIANTS)} variants in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    rows = []
    for mode in args.modes.split(","):
        for d in map(int, args.strides.split(",")):
            b = d * (args.block // d)
            case = Case(mode, d, args.channels, b, gen)
            for dtype in (torch.float32, torch.bfloat16):
                res = run_case(case, dtype)
                rows.append(res)
                print(json.dumps(res), flush=True)
            del case
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "rows": rows},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
