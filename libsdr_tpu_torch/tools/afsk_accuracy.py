"""K1e (``fir_afsk_exact``) against the float64 evaluation of its plain
version, on the card, stage by stage.

    python -m libsdr_tpu_torch.tools.afsk_accuracy [--cases 1,2,3 2,2,3]
        [--planes f32 bf16] [--out afsk_accuracy.json]

Each case ``D,L,C`` is one of ``test_afsk_kernel_matches_plain``'s
(``tests/test_torch_cuda.py``): the fused AFSK front end at stride D with a
correlator window L on C channels of that test's FM signal, a warm block
and three carry-chained blocks (the carry from the float32 plain version,
as the test chains it); with ``--seeds``, also on ``chip_smoke.py``'s K1e
sweep signal (FM tones plus noise, carried products of noise, template
phase 7) from a generator of each seed.  For blocks 1-3 the same inputs go through

* the kernels: ``fir_exact`` (the FIR alone), ``fir_fm_exact`` (FIR and
  discriminator, no de-emphasis) and ``fir_afsk_exact``;
* their plain versions in float32 on the card, on the card with cuDNN
  off, and on the CPU;
* the function in float64 (:func:`exact_f64`, on float64 copies of the
  same inputs), which the script writes out itself so that it can hold
  another tree's kernels and plain versions too (run it with
  ``PYTHONPATH`` set to that tree's root).

Each line prints, per stage, every version's largest error against the
float64 result relative to that result's largest magnitude per channel (y:
|y|; audio: |audio|; disc: |disc|), and the kernel against the float32
plain version on the card.  A stage that is off shows there first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path

import numpy as np
import torch

FS = 960_000.0


def fm_rows(c: int, b: int, d: int, k: int) -> np.ndarray:
    """Block k of the card tests' FM signal (tests/test_torch_cuda.py::_fm)."""
    from libsdr_tpu_torch.ops import siggen
    dev = 0.15 * FS / d
    return np.stack([siggen.fm_modulate(
        FS, siggen.sine(FS, (k + 1) * b, 900.0 + 50 * ch, amps=1.0), dev,
        carrier=FS / 8 + 300.0 * ch)[k * b:] for ch in range(c)])


def smoke_rows(gen, c: int, b: int, d: int, k: int, device):
    """Block k of ``chip_smoke.py``'s K1e sweep signal (its fm_signal): FM
    tones near FS/8 plus complex noise of 0.05 a plane from ``gen``."""
    n = torch.arange(k * b, (k + 1) * b, dtype=torch.float64, device=device)
    xr = torch.empty((c, b), dtype=torch.float32, device=device)
    xi = torch.empty_like(xr)
    dev_hz = 0.15 * FS / d
    for ch in range(c):
        fc = FS / 8 + (ch % 7 - 3) * 0.01 * FS / d
        fm = 1000.0 + 100.0 * (ch % 5)
        ph = (2 * np.pi * fc / FS) * n - (dev_hz / fm) * torch.cos(
            (2 * np.pi * fm / FS) * n)
        ph = torch.remainder(ph, 2 * np.pi)
        xr[ch] = torch.cos(ph).float()
        xi[ch] = torch.sin(ph).float()
    xr += 0.05 * torch.randn(xr.shape, generator=gen, device=device)
    xi += 0.05 * torch.randn(xi.shape, generator=gen, device=device)
    return xr, xi


def afsk_op(d: int, ell: int, c: int, b: int, plane_dtype):
    """The fused AFSK op of the card tests (tests/test_torch_cuda.py)."""
    import libsdr_tpu_torch as P
    from libsdr_tpu_torch.ops import FMDemod, FSKDetector, IQBaseBand
    from libsdr_tpu_torch.ops.afsk_fused import AFSKFrontendFused

    audio_fs = FS / d
    rx = P.Pipeline([IQBaseBand(fc=FS / 8, width=min(FS / 4.8, 0.8 * FS / d),
                                order=48, decim=d, design="textbook"),
                     FMDemod(), FSKDetector(audio_fs / (ell + 0.5),
                                            0.05 * audio_fs,
                                            0.09 * audio_fs)])
    rx.bind(P.StreamSpec(np.complex64, FS, b, channels=(c,),
                         plane_dtype=plane_dtype))
    op = rx.stages[0]
    assert isinstance(op, AFSKFrontendFused) and op.corr_len == ell
    return op


@contextlib.contextmanager
def cudnn_off():
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def _to(v, device):
    """A tensor, Complex or tuple of them (scalars as they are) on
    ``device``."""
    from libsdr_tpu_torch.core.cplx import Complex
    if isinstance(v, tuple):
        return tuple(_to(a, device) for a in v)
    if isinstance(v, (Complex, torch.Tensor)):
        return v.to(device)
    return v


def _rel(got, ref) -> float:
    """Largest |got - ref| over each channel's largest |ref| (got moved to
    ref's device and dtype)."""
    from libsdr_tpu_torch.core.cplx import Complex
    got = got.to(ref.device, getattr(ref, "real_dtype", ref.dtype))
    if isinstance(ref, Complex):
        diff = torch.hypot(got.re - ref.re, got.im - ref.im)
    else:
        diff = (got - ref).abs()
    scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    return float((diff / scale).max())


def exact_f64(x, taps, d, tail, prev, rot, gain, mark, space, n0, um, us):
    """(y, audio, disc) of K1e's function evaluated in float64 on float64
    copies of the arguments, written out here (so that another tree's
    kernels and plain versions can be held against it): the decimating
    FIR, the discriminator with the kernels' atan2 polynomial, the tone
    products and the window sums."""
    from libsdr_tpu_torch.core.cplx import Complex
    f = torch.float64
    xr = torch.cat([tail.re.to(f), x.re.to(f)], -1)[..., d - 1:]
    xi = torch.cat([tail.im.to(f), x.im.to(f)], -1)[..., d - 1:]
    kr, ki = taps.re.to(f), taps.im.to(f)
    t = kr.shape[0]
    n = (xr.shape[-1] - t) // d + 1
    idx = (torch.arange(n, device=xr.device)[:, None] * d
           + torch.arange(t, device=xr.device)[None])
    wr, wi = xr[..., idx], xi[..., idx]
    yr = (wr * kr).sum(-1) - (wi * ki).sum(-1)
    yi = (wr * ki).sum(-1) + (wi * kr).sum(-1)
    pr = torch.cat([prev.re.to(f)[..., None], yr[..., :-1]], -1)
    pi = torch.cat([prev.im.to(f)[..., None], yi[..., :-1]], -1)
    zr, zi = yr * pr + yi * pi, yi * pr - yr * pi
    rot = complex(rot)
    zr2, zi2 = zr * rot.real - zi * rot.imag, zr * rot.imag + zi * rot.real
    ay, ax = zi2.abs(), zr2.abs()
    tq = torch.minimum(ax, ay) / torch.maximum(ax, ay).clamp_min(1e-300)
    s2 = tq * tq
    poly = torch.full_like(tq, -0.0117212)
    for c in (0.05265332, -0.11643287, 0.19354346, -0.33262347, 0.99997726):
        poly = poly * s2 + c
    r = tq * poly
    r = torch.where(ay > ax, np.pi / 2 - r, r)
    r = torch.where(zr2 < 0, np.pi - r, r)
    audio = float(gain) * torch.where(zi2 < 0, -r, r)
    ell = mark.re.shape[-1]
    ix = (torch.as_tensor(n0, device=xr.device).to(torch.int64)
          + torch.arange(n, device=xr.device)) % ell
    powers = []
    for tone, tu in ((mark, um), (space, us)):
        fr = torch.cat([tu.re.to(f), tone.re.to(f)[ix] * audio], -1)
        fi = torch.cat([tu.im.to(f), tone.im.to(f)[ix] * audio], -1)
        sr = sum(fr[..., k:k + n] for k in range(ell))
        si = sum(fi[..., k:k + n] for k in range(ell))
        powers.append(sr * sr + si * si)
    return Complex(yr, yi), audio, powers[0] - powers[1]


def run_case(d: int, ell: int, c: int, plane_dtype, device="cuda",
             seed=None) -> dict:
    """The case's errors; ``seed``: the smoke run's signal from a generator
    of that seed (with its carried products of noise and template phase
    7), else the card tests' signal."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.ops import fir_fm as F

    cuda = torch.device(device)
    n_out = 3 * 4096 + 333
    b = d * n_out
    op = afsk_op(d, ell, c, b, plane_dtype)
    carry = op.init_carry(cuda)
    if seed is not None:
        gen = torch.Generator(device=cuda)
        gen.manual_seed(seed)
        tail, prev, _, _, _ = carry
        carry = (tail, prev, torch.tensor(7 % ell, dtype=torch.int32,
                                          device=cuda),
                 *(Complex(torch.randn((c, ell - 1), generator=gen,
                                       device=cuda),
                           torch.randn((c, ell - 1), generator=gen,
                                       device=cuda)) for _ in range(2)))
    t = op._t
    worst: dict = {}
    for k in range(4):
        if seed is None:
            xn = fm_rows(c, b, d, k)
            x = Complex(torch.tensor(xn.real, device=cuda),
                        torch.tensor(xn.imag, device=cuda))
        else:
            x = Complex(*smoke_rows(gen, c, b, d, k, cuda))
        x = x.to(plane_dtype)
        tail, prev, n0, um, us = carry
        taps = op._taps(cuda)
        args = (x, taps, d, tail, prev, op._rot, op._gain,
                op._on("mark", op._tones[0], cuda),
                op._on("space", op._tones[1], cuda), n0, um, us)
        ref = F.fir_afsk_exact_plain(*args)
        if k:
            stages = {
                "y": (F.fir_exact, F.fir_exact_plain, args[:4],
                      lambda r: r),
                "audio": (F.fir_fm_exact, F.fir_fm_exact_plain, args[:7],
                          lambda r: r[0]),
                "disc": (F.fir_afsk_exact, F.fir_afsk_exact_plain, args,
                         lambda r: r[0]),
            }
            exact = dict(zip(("y", "audio", "disc"), exact_f64(*args)))
            for name, (kern, plain, a, pick) in stages.items():
                r64 = exact[name]
                got = {
                    "kernel": pick(kern(*a)),
                    "plain": pick(plain(*a)),
                    "plain_cpu": pick(plain(*_to(a, "cpu"))),
                }
                with cudnn_off():
                    got["plain_nocudnn"] = pick(plain(*a))
                errs = {f"{v}_vs_f64": _rel(g, r64) for v, g in got.items()}
                errs["kernel_vs_plain"] = _rel(got["kernel"], got["plain"])
                for key, e in errs.items():
                    worst.setdefault(name, {})
                    worst[name][key] = max(worst[name].get(key, 0.0), e)
        carry = (x[..., b - (t - 1):].map(torch.clone), ref[1],
                 (carry[2] + n_out) % ell, ref[2], ref[3])
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", nargs="+", default=["1,2,3", "1,20,2",
                                                   "2,2,3", "24,40,3"])
    ap.add_argument("--planes", nargs="+", default=["f32"],
                    choices=["f32", "bf16"])
    ap.add_argument("--seeds", nargs="*", type=int, default=[],
                    help="also run each case on chip_smoke.py's signal "
                         "from a generator of each seed")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("afsk_accuracy needs a CUDA card")
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    res = []
    for planes in args.planes:
        dtype = torch.float32 if planes == "f32" else torch.bfloat16
        for case in args.cases:
            d, ell, c = (int(v) for v in case.split(","))
            for seed in [None] + list(args.seeds):
                worst = run_case(d, ell, c, dtype, seed=seed)
                line = dict(planes=planes, D=d, L=ell, C=c,
                            signal="test" if seed is None else
                            f"smoke seed {seed}", errs=worst, card=smi)
                print(json.dumps(line), flush=True)
                res.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
