"""BPSK31 demodulator (counterpart of ``libsdr_tpu.ops.psk31``).

A fractional resampler to 64 samples a symbol driven by a Mueller & Muller
style timing error detector, a second-order carrier PLL (damping
sqrt(2)/2, bandwidth pi/100) and differential decoding of the sign of each
symbol's summed phase constellation (transition -> 0, none -> 1), with an
early symbol cut on zero crossings.

The recurrence is sequential in time and runs no TPU kernel in the JAX
package (a ``lax.scan`` over samples).  Here it is a Python loop over time
in numpy float32 on the host, vectorized over channels: a step of small
PyTorch ops costs several times a numpy step, on a card more still, and
every device gives the same bits for the same input.  Its time is in
PERF.md.  The carry is the JAX op's dict, leaf for leaf, on the block's
device.

Output: a Ragged bit stream at 31.25 baud nominal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.ragged import Ragged
from libsdr_tpu_torch.core.stream import ConfigError, StreamSpec
from libsdr_tpu_torch.ops.interpolate import NSTEPS, interpolation_bank

_SUPER = 64  # phase samples per symbol
_F32 = np.float32


class BPSK31(Processor):
    """Args:
      df: carrier PLL frequency range (rad/sample), default 0.1.
    """

    def __init__(self, df: float = 0.1):
        super().__init__()
        self.df = float(df)
        damping = math.sqrt(2) / 2
        bw = math.pi / 100
        tmp = 1.0 + 2 * damping * bw + bw * bw
        self.alpha = 4 * damping * bw / tmp
        self.beta = 4 * bw * bw / tmp
        self.gain_mu = 0.01
        self.gain_omega = 0.001
        self.omega_rel = 0.001

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_complex("BPSK31")
        fs = in_spec.rate_hz
        if fs < 2000:
            raise ConfigError(
                "Can not configure BPSK31: input sample rate too low, "
                f"need >= 2000 Hz, got {fs}")
        self._omega0 = fs / (_SUPER * 31.25)
        self._omega_min = self._omega0 * (1 - self.omega_rel)
        self._omega_max = self._omega0 * (1 + self.omega_rel)
        return in_spec.with_(dtype=torch.uint8, sample_rate=31.25,
                             ragged=True, plane_dtype=None)

    def _init_carry(self, device):
        ch = self.in_spec.channels
        f32 = torch.float32

        def z():
            return torch.zeros(ch, dtype=f32, device=device)
        return dict(
            P=z(), F=z(),
            mu=torch.full(ch, 0.25, dtype=f32, device=device),
            omega=torch.full(ch, self._omega0, dtype=f32, device=device),
            dl=cplx.zeros(ch + (8,), f32, device),
            dl_idx=torch.zeros((), dtype=torch.int32, device=device),
            p0=cplx.zeros(ch, f32, device), p1=cplx.zeros(ch, f32, device),
            p2=cplx.zeros(ch, f32, device),
            c0=z(), c1=z(), c2=z(),
            hist_sum=z(), hist_prev=z(),
            hist_idx=torch.zeros(ch, dtype=torch.int32, device=device),
            last_const=torch.ones(ch, dtype=torch.int32, device=device),
        )

    def apply(self, carry, x):
        dev = x.re.device
        ch = tuple(x.shape[:-1])
        t = x.shape[-1]
        xr = _host(x.re).reshape(-1, t)
        xi = _host(x.im).reshape(-1, t)
        s = {k: (_host(v.re).reshape(-1, *v.re.shape[len(ch):]).copy(),
                 _host(v.im).reshape(-1, *v.im.shape[len(ch):]).copy())
             if isinstance(v, Complex) else
             (_host(v).copy() if k == "dl_idx" else _host(v).reshape(-1))
             for k, v in carry.items()}
        bits, emits = self._scan(s, xr, xi)

        def back(a, shape):
            return torch.from_numpy(np.ascontiguousarray(a)).reshape(
                shape).to(dev)

        new = {}
        for k, v in carry.items():
            if isinstance(v, Complex):
                new[k] = Complex(back(s[k][0], v.re.shape),
                                 back(s[k][1], v.im.shape))
            else:
                new[k] = back(s[k], v.shape)
        return new, Ragged(back(bits, ch + (t,)), back(emits, ch + (t,)))

    def _scan(self, s, xr, xi):
        """The recurrence over the block's samples, updating the carry dict
        ``s`` of host arrays in place; returns (bits, emits) (C, T)."""
        bank = interpolation_bank()
        alpha, beta = _F32(self.alpha), _F32(self.beta)
        fmin, fmax = _F32(-self.df), _F32(self.df)
        omin, omax = _F32(self._omega_min), _F32(self._omega_max)
        gmu, gom = _F32(self.gain_mu), _F32(self.gain_omega)
        two_pi = _F32(2 * math.pi)
        one, zero = _F32(1.0), _F32(0.0)
        c, t = xr.shape
        bits = np.empty((c, t), np.uint8)
        emits = np.empty((c, t), bool)

        def wrap(p):
            p = np.where(p > two_pi, p - two_pi, p)
            return np.where(p < -two_pi, p + two_pi, p)

        P, F, mu_s, omega_s = s["P"], s["F"], s["mu"], s["omega"]
        dlr, dli = s["dl"]
        dl_idx = int(s["dl_idx"])
        (p0r, p0i), (p1r, p1i), (p2r, p2i) = s["p0"], s["p1"], s["p2"]
        c0s, c1s, c2s = s["c0"], s["c1"], s["c2"]
        hsum_s, hprev, hidx, last_const = (s["hist_sum"], s["hist_prev"],
                                           s["hist_idx"], s["last_const"])
        for n in range(t):
            # consume one input sample
            mu = mu_s - one
            Pn = wrap(P + F)
            fr, fi = np.cos(Pn), np.sin(Pn)
            dlr[:, dl_idx] = fr * xr[:, n] - fi * xi[:, n]
            dli[:, dl_idx] = fr * xi[:, n] + fi * xr[:, n]
            dl_idx = (dl_idx + 1) % 8
            # maybe produce a phase sample: the window oldest -> newest is
            # dl[(dl_idx + j) % 8], i.e. the taps rolled by the ring index
            produce = mu <= one
            row = np.clip(np.round(mu * _F32(NSTEPS)), 0, NSTEPS).astype(
                np.int64)
            taps = np.roll(bank[row], dl_idx, axis=-1)
            yr = dlr[:, 0] * taps[:, 0]
            yi = dli[:, 0] * taps[:, 0]
            for k in range(1, 8):
                yr = yr + dlr[:, k] * taps[:, k]
                yi = yi + dli[:, k] * taps[:, k]
            # timing error: (c0 - c[-2]) p[-1] against (y - p[-2]) c[-1]
            c0 = np.where(yr > 0, _F32(-1.0), one)
            err = np.clip((yr - p1r) * c0s - (c0 - c1s) * p0r, -one, one)
            om = np.clip(omega_s + gom * err, omin, omax)
            mu_new = mu + om + gmu * err
            # carrier PLL
            nrm2 = yr * yr + yi * yi
            zero_n = nrm2 == 0
            phi = np.where(zero_n, zero,
                           -yr * yi / np.where(zero_n, one, nrm2))
            Fn = np.clip(F + beta * phi, fmin, fmax)
            P2 = wrap(Pn + Fn + alpha * phi)
            # phase history / bit decision
            hsum = hsum_s + yr
            trans = ((hprev >= 0) & (yr <= 0)) | ((hprev <= 0) & (yr >= 0))
            early = (hidx > 1) & trans
            drop = early & (hidx < (_SUPER // 2))
            cut = (early & ~drop) | (hidx == (_SUPER - 1))
            cconst = np.where(hsum > 0, 1, -1).astype(np.int32)
            bits[:, n] = last_const == cconst
            emit = cut & produce
            emits[:, n] = emit
            last_const = np.where(emit, cconst, last_const)
            reset = (drop | cut) & produce
            hidx = np.where(produce, np.where(reset, 0, hidx + 1),
                            hidx).astype(np.int32)
            hsum_s = np.where(produce, np.where(reset, zero, hsum), hsum_s)
            hprev = np.where(produce, yr, hprev)
            # where a sample is made: p2 <- p1 <- p0 <- y, c2 <- c1 <- c0
            p2r = np.where(produce, p1r, p2r)
            p2i = np.where(produce, p1i, p2i)
            p1r = np.where(produce, p0r, p1r)
            p1i = np.where(produce, p0i, p1i)
            p0r = np.where(produce, yr, p0r)
            p0i = np.where(produce, yi, p0i)
            c2s = np.where(produce, c1s, c2s)
            c1s = np.where(produce, c0s, c1s)
            c0s = np.where(produce, c0, c0s)
            P = np.where(produce, P2, Pn)
            F = np.where(produce, Fn, F)
            mu_s = np.where(produce, mu_new, mu)
            omega_s = np.where(produce, om, omega_s)
        s.update(P=P, F=F, mu=mu_s, omega=omega_s, dl=(dlr, dli),
                 dl_idx=np.asarray(dl_idx, np.int32), p0=(p0r, p0i),
                 p1=(p1r, p1i), p2=(p2r, p2i), c0=c0s, c1=c1s, c2=c2s,
                 hist_sum=hsum_s, hist_prev=hprev, hist_idx=hidx,
                 last_const=last_const)
        return bits, emits


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32 if t.is_floating_point()
                         else t.dtype).numpy()
