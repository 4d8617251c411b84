"""FM at stride D = 1 (``IQBaseBand(decim=1) -> FMDemod -> FMDeemph``,
fused into ``FMBasebandFused``) against its function in float64, on a
fading signal, stage by stage, on the card.

    python -m libsdr_tpu_torch.tools.fm_accuracy [--channels 1 64]
        [--out fm_accuracy.json]

The signal (:func:`fading_rows`): an FM tone on each channel whose
envelope is a cosine, so it fades through zero twice a period; at a fade
|y| falls to ~1e-4 of its largest, and the discriminator divides the
FIR's rounding by it (the cause K1e's D = 1 repair addressed).  A warm
block and three carry-chained blocks (the carry from the float32 plain
version, as ``tools/afsk_accuracy.py`` chains it); for blocks 1-3 the
same inputs go through

* the kernels: ``fir_exact`` (the FIR alone), ``fir_fm_exact`` without
  de-emphasis (FIR and discriminator) and with it;
* their plain versions in float32 on the card, on the card with cuDNN off,
  and on the CPU;
* the function in float64 (:func:`exact_f64`, on float64 copies of the
  same inputs, the port's atan2 polynomial), written out here so that it
  can hold another tree's kernels and plain versions too.

Each stage prints every version's largest error against the float64
result, relative to each channel's largest magnitude of that result (y:
|y|; audio and out: |audio|, |out|), and its 99.9th percentile.  The JAX
package's D = 1 path (XLA's: its kernel gate wants a stride above 1) is
measured the same way on the CPU by ``tests/test_torch_fm_accuracy.py``,
which uses :func:`fading_rows`, :func:`fm_op` and :func:`exact_f64` with
``angle="exact"`` (JAX's discriminator is ``angle()``, not the polynomial).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

FS = 960_000.0
N_TAPS = 48
BLOCK = 3 * 4096 + 333


def fading_rows(c: int, b: int, k: int) -> np.ndarray:
    """Block k of c channels (complex64, (c, b)): an FM tone (900 + 50 ch
    Hz, deviation 0.15 FS, carrier FS/8 + 300 ch Hz) times a cosine
    envelope of 37 + 3 ch Hz, which fades through zero every 13.5 ms or
    less."""
    n = np.arange(k * b, (k + 1) * b, dtype=np.float64)
    rows = []
    for ch in range(c):
        fm = 900.0 + 50 * ch
        fc = FS / 8 + 300.0 * ch
        dev = 0.15 * FS
        ph = 2 * np.pi * fc / FS * n - dev / fm * np.cos(2 * np.pi * fm / FS
                                                         * n)
        env = np.cos(2 * np.pi * (37.0 + 3 * ch) / FS * n + 0.3 * ch)
        rows.append(env * np.exp(1j * ph))
    return np.stack(rows).astype(np.complex64)


def fm_op(c: int, b: int = BLOCK):
    """The fused FM op at D = 1 on c channels of b samples (f32 planes)."""
    import libsdr_tpu_torch as P
    from libsdr_tpu_torch.ops import FMDeemph, FMDemod, IQBaseBand
    from libsdr_tpu_torch.ops.fm_fused import FMBasebandFused

    rx = P.Pipeline([IQBaseBand(fc=FS / 8, width=FS / 4.8, order=N_TAPS,
                                decim=1, design="textbook"),
                     FMDemod(), FMDeemph()])
    rx.bind(P.StreamSpec(np.complex64, FS, b, channels=(c,)))
    op = rx.stages[0]
    assert isinstance(op, FMBasebandFused) and op._decim == 1
    return op


def exact_f64(x, taps, tail, prev, rot, gain, deemph_ab, dstate,
              angle: str = "poly"):
    """(y, audio, out) of the FM function at D = 1 in float64, on float64
    copies of the arguments: the FIR over tail + x, the discriminator
    ``gain * atan(y[j] conj(y[j-1]) rot)`` with y[-1] = prev (``angle``:
    "poly", the port's atan2 polynomial; "exact", the angle), then the
    de-emphasis ``out[n] = a out[n-1] + b audio[n]`` from dstate."""
    from libsdr_tpu_torch.core.cplx import Complex
    f = torch.float64
    xr = torch.cat([tail.re.to(f), x.re.to(f)], -1)
    xi = torch.cat([tail.im.to(f), x.im.to(f)], -1)
    kr, ki = taps.re.to(f), taps.im.to(f)
    t = kr.shape[0]
    n = xr.shape[-1] - t + 1
    idx = torch.arange(n, device=xr.device)[:, None] + torch.arange(
        t, device=xr.device)[None]
    wr, wi = xr[..., idx], xi[..., idx]
    yr = (wr * kr).sum(-1) - (wi * ki).sum(-1)
    yi = (wr * ki).sum(-1) + (wi * kr).sum(-1)
    pr = torch.cat([prev.re.to(f)[..., None], yr[..., :-1]], -1)
    pi = torch.cat([prev.im.to(f)[..., None], yi[..., :-1]], -1)
    zr, zi = yr * pr + yi * pi, yi * pr - yr * pi
    rot = complex(rot)
    zr2, zi2 = zr * rot.real - zi * rot.imag, zr * rot.imag + zi * rot.real
    if angle == "exact":
        audio = float(gain) * torch.atan2(zi2, zr2)
    else:
        ay, ax = zi2.abs(), zr2.abs()
        tq = torch.minimum(ax, ay) / torch.maximum(ax, ay).clamp_min(1e-300)
        s2 = tq * tq
        poly = torch.full_like(tq, -0.0117212)
        for c in (0.05265332, -0.11643287, 0.19354346, -0.33262347,
                  0.99997726):
            poly = poly * s2 + c
        r = tq * poly
        r = torch.where(ay > ax, np.pi / 2 - r, r)
        r = torch.where(zr2 < 0, np.pi - r, r)
        audio = float(gain) * torch.where(zi2 < 0, -r, r)
    a, b = deemph_ab
    out = torch.empty_like(audio)
    s = dstate.to(f)
    for j in range(audio.shape[-1]):
        s = a * s + b * audio[..., j]
        out[..., j] = s
    return Complex(yr, yi), audio, out


def rel_errors(got, ref) -> dict:
    """``max`` and ``p999``: the largest and the 99.9th percentile of
    |got - ref| over each channel's largest |ref| (got moved to ref's
    device and dtype)."""
    from libsdr_tpu_torch.core.cplx import Complex
    got = got.to(ref.device, getattr(ref, "real_dtype", ref.dtype))
    if isinstance(ref, Complex):
        diff = torch.hypot(got.re - ref.re, got.im - ref.im)
    else:
        diff = (got - ref).abs()
    scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    r = (diff / scale).flatten().double()
    return dict(max=float(r.max()),
                p999=float(torch.quantile(r.cpu(), 0.999)))


def block_inputs(op, c: int, device, blocks: int = 4):
    """The blocks' arguments of ``fir_fm_exact`` (x, taps, 1, tail, prev,
    rot, gain, deemph_ab, dstate), chained by the float32 plain version's
    carry."""
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.ops import fir_fm as F

    tail, prev, dstate = op.init_carry(device)
    taps = op._taps(device)
    out = []
    for k in range(blocks):
        x = cplx.as_block(fading_rows(c, BLOCK, k), torch.float32, device)
        a = (x, taps, 1, tail, prev, op._rot, op._gain, op._dab, dstate)
        out.append(a)
        aud, y_last = F.fir_fm_exact_plain(*a)
        tail = x[..., BLOCK - (N_TAPS - 1):].map(torch.clone)
        prev, dstate = y_last, aud[..., -1]
    return out


def _stages(a):
    """stage -> (kernel entry, plain version, its arguments, what to
    keep of its result)."""
    from libsdr_tpu_torch.ops import fir_fm as F
    return {
        "y": (F.fir_exact, F.fir_exact_plain, a[:4], lambda r: r),
        "audio": (F.fir_fm_exact, F.fir_fm_exact_plain, a[:7],
                  lambda r: r[0]),
        "out": (F.fir_fm_exact, F.fir_fm_exact_plain, a,
                lambda r: r[0]),
    }


def run_case(c: int, device="cuda") -> dict:
    """Each stage's worst errors over blocks 1-3, by version."""
    from libsdr_tpu_torch.tools.afsk_accuracy import _to, cudnn_off

    dev = torch.device(device)
    op = fm_op(c)
    worst: dict = {}
    for a in block_inputs(op, c, dev)[1:]:
        exact = dict(zip(("y", "audio", "out"),
                         exact_f64(a[0], a[1], *a[3:])))
        for name, (kern, plain, args, pick) in _stages(a).items():
            got = {"plain": pick(plain(*args)),
                   "plain_cpu": pick(plain(*_to(args, "cpu")))}
            if dev.type == "cuda":
                got["kernel"] = pick(kern(*args))
                with cudnn_off():
                    got["plain_nocudnn"] = pick(plain(*args))
            errs = {f"{v}_vs_f64": rel_errors(g, exact[name])
                    for v, g in got.items()}
            if "kernel" in got:
                errs["kernel_vs_plain"] = rel_errors(got["kernel"],
                                                     got["plain"])
            for key, e in errs.items():
                w = worst.setdefault(name, {}).setdefault(
                    key, dict(max=0.0, p999=0.0))
                for m in w:
                    w[m] = max(w[m], e[m])
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--channels", nargs="+", type=int, default=[1, 64])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fm_accuracy needs a CUDA card")
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    res = []
    for c in args.channels:
        line = dict(D=1, C=c, T=N_TAPS, block=BLOCK, errs=run_case(c),
                    card=smi)
        print(json.dumps(line), flush=True)
        res.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
