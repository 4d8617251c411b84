"""BPSK31 demodulator (counterpart of ``libsdr_tpu.ops.psk31``).

A fractional resampler to 64 samples a symbol driven by a Mueller & Muller
style timing error detector, a second-order carrier PLL (damping
sqrt(2)/2, bandwidth pi/100) and differential decoding of the sign of each
symbol's summed phase constellation (transition -> 0, none -> 1), with an
early symbol cut on zero crossings.

The recurrence is sequential in time: the JAX package runs it as one
``lax.scan`` over the block's samples.  :func:`bpsk31_scan` dispatches on
the block's device:

* a CUDA block launches the hand-written kernel of ``csrc/psk31.cu`` (one
  thread a channel, the state in registers, one launch a block, counted in
  ``bpsk31_scan.launches``).  Nothing in the step reads the host, so a
  pipeline holding BPSK31 captures into a CUDA graph
  (``Pipeline.compile_chunked``);
* a CPU block takes the plain version :func:`bpsk31_scan_plain`, a Python
  loop over time in numpy float32, vectorized over channels (a step of
  small PyTorch ops costs several times a numpy step).

Neither path reads the other's device: every carry leaf must lie on the
block's.  Both round every operation alike, in the same order, and take
the phasor as the float64 cos and sin rounded to float32 (the float32
cos/sin of numpy and of CUDA differ in the last bit), so the kernel's
bits, valid flags and carried values equal the plain version's.  The
carry is the JAX op's dict, leaf for leaf, on the block's device.

Output: a Ragged bit stream at 31.25 baud nominal.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.ragged import Ragged
from libsdr_tpu_torch.core.stream import ConfigError, StreamSpec
from libsdr_tpu_torch.ops.fir_fm import _check, _plain, _small
from libsdr_tpu_torch.ops.interpolate import NSTEPS, interpolation_bank
from libsdr_tpu_torch.utils.profiling import spanned

_SUPER = 64  # phase samples per symbol
_F32 = np.float32
# The kernel's carry operands in csrc/psk31.cu's order: (key, plane), the
# plane None for a real leaf; the float32 (C,) leaves, the int32 (C,)
# leaves, then the ring's (C, 8) planes.
_F_LEAVES = (("P", None), ("F", None), ("mu", None), ("omega", None),
             ("p0", "re"), ("p0", "im"), ("p1", "re"), ("p1", "im"),
             ("p2", "re"), ("p2", "im"), ("c0", None), ("c1", None),
             ("c2", None), ("hist_sum", None), ("hist_prev", None))
_I_LEAVES = (("hist_idx", None), ("last_const", None))
_RING = (("dl", "re"), ("dl", "im"))


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

    def constants(self) -> dict:
        """The loops' constants, as :func:`bpsk31_scan` takes them."""
        return dict(alpha=self.alpha, beta=self.beta, df=self.df,
                    omega_min=self._omega_min, omega_max=self._omega_max,
                    gain_mu=self.gain_mu, gain_omega=self.gain_omega)

    def apply(self, carry, x):
        ch = tuple(x.shape[:-1])
        t = x.shape[-1]

        def regroup(c, drop, lead):
            # each leaf but dl_idx with its first `drop` dims as `lead`
            def one(a):
                return a.reshape(lead + tuple(a.shape[drop:]))
            return {k: v if k == "dl_idx" else
                    v.map(one) if isinstance(v, Complex) else one(v)
                    for k, v in c.items()}

        new, bits, emits = bpsk31_scan(
            x.map(lambda a: a.reshape(-1, t)), regroup(carry, len(ch), (-1,)),
            **self.constants())
        return regroup(new, 1, ch), Ragged(bits.reshape(ch + (t,)),
                                           emits.reshape(ch + (t,)))


@spanned("wrapper:bpsk31_scan")
def bpsk31_scan(x: Complex, carry: dict, *, alpha, beta, df, omega_min,
                omega_max, gain_mu, gain_omega):
    """BPSK31's recurrence over one block of a bank of C channels.

    Args:
      x: (C, T) planes, float32 or bfloat16 (widened to float32).
      carry: the op's dict: (C,) leaves (p0, p1, p2 Complex), ``dl`` a
        Complex of (C, 8) planes and ``dl_idx`` a 0-d int32, all on x's
        device.
      alpha, beta, df, omega_min, omega_max, gain_mu, gain_omega: the
        loops' constants (:meth:`BPSK31.constants`), taken as float32.

    Returns:
      (carry', bits (C, T) uint8, emits (C, T) bool) on x's device: bit t
      is the symbol decision at step t, valid where emits is set.
    """
    dev = x.re.device
    for k, v in carry.items():
        for a in (v.re, v.im) if isinstance(v, Complex) else (v,):
            if a.device != dev:
                raise ValueError(f"bpsk31_scan: carry leaf {k} on {a.device}"
                                 f", the block on {dev}: move the carry "
                                 "(interop.state_from_numpy)")
    k = dict(alpha=alpha, beta=beta, df=df, omega_min=omega_min,
             omega_max=omega_max, gain_mu=gain_mu, gain_omega=gain_omega)
    if _plain(x, "bpsk31_scan"):
        return bpsk31_scan_plain(x, carry, **k)
    return _launch(x, carry, k)


# Kernel launches, counted where they happen.
bpsk31_scan.launches = 0


def bpsk31_scan_plain(x: Complex, carry: dict, *, alpha, beta, df,
                      omega_min, omega_max, gain_mu, gain_omega):
    """Plain version of :func:`bpsk31_scan` (same arguments and results):
    the recurrence as a loop over time in numpy on the host, its results
    back on x's device."""
    dev = x.re.device
    xr, xi = _host(x.re), _host(x.im)
    s = {k: (_host(v.re).copy(), _host(v.im).copy())
         if isinstance(v, Complex) else _host(v).copy()
         for k, v in carry.items()}
    bits, emits = _scan_np(s, xr, xi, dict(
        alpha=_F32(alpha), beta=_F32(beta), fmin=_F32(-df), fmax=_F32(df),
        omin=_F32(omega_min), omax=_F32(omega_max), gmu=_F32(gain_mu),
        gom=_F32(gain_omega)))

    def back(a, like):
        return torch.from_numpy(np.ascontiguousarray(a)).reshape(
            like.shape).to(dev)

    new = {}
    for k, v in carry.items():
        if isinstance(v, Complex):
            new[k] = Complex(back(s[k][0], v.re), back(s[k][1], v.im))
        else:
            new[k] = back(s[k], v)
    return new, back(bits, x.re), back(emits, x.re)


def _scan_np(s, xr, xi, k):
    """The recurrence over the block's samples, updating the carry dict
    ``s`` of host arrays in place; returns (bits, emits) (C, T)."""
    bank = interpolation_bank()
    alpha, beta, gmu, gom = k["alpha"], k["beta"], k["gmu"], k["gom"]
    fmin, fmax, omin, omax = k["fmin"], k["fmax"], k["omin"], k["omax"]
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
        fr, fi = _phasor(Pn)
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
        for j in range(1, 8):
            yr = yr + dlr[:, j] * taps[:, j]
            yi = yi + dli[:, j] * taps[:, j]
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


def _phasor(p):
    """cos and sin of the float32 phases p: the float64 values rounded to
    float32 (csrc/psk31.cu computes them alike)."""
    pd = p.astype(np.float64)
    return np.cos(pd).astype(_F32), np.sin(pd).astype(_F32)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32 if t.is_floating_point()
                         else t.dtype).numpy()


@functools.cache
def _bank(dev: torch.device) -> torch.Tensor:
    """The interpolation bank on ``dev``, made once (before any graph
    capture, whose warm-up step calls this first)."""
    return torch.as_tensor(interpolation_bank(), device=dev)


def _launch(x, carry, k):
    """One launch of csrc/psk31.cu's sdr_psk31 over the block."""
    from libsdr_tpu_torch import _build

    name = "bpsk31_scan"
    xr, xi = x.re, x.im
    if xr.ndim != 2 or xi.shape != xr.shape or xi.dtype != xr.dtype:
        raise ValueError(f"{name}: planes must be (C, T) of one dtype, got "
                         f"{tuple(xr.shape)} {xr.dtype} / {tuple(xi.shape)} "
                         f"{xi.dtype}")
    if xr.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: planes must be float32 or bfloat16, got "
                         f"{xr.dtype}")
    c, t = xr.shape
    dev = xr.device
    xr = xr.to(torch.float32).contiguous()
    xi = xi.to(torch.float32).contiguous()
    small = _small(name, dev)

    def leaf(key, plane):
        v = carry[key]
        return v if plane is None else getattr(v, plane)

    ins = ([small(leaf(*kp), torch.float32, (c,)) for kp in _F_LEAVES]
           + [small(leaf(*kp), torch.int32, (c,)) for kp in _I_LEAVES]
           + [small(leaf(*kp), torch.float32, (c, 8)) for kp in _RING])
    outs = [torch.empty_like(v) for v in ins]
    idx = small(carry["dl_idx"], torch.int32, ())
    bank = _bank(dev)
    bits = torch.empty((c, t), dtype=torch.uint8, device=dev)
    emits = torch.empty((c, t), dtype=torch.bool, device=dev)
    n = len(ins)
    p_in = (ctypes.c_void_p * n)(*(v.data_ptr() for v in ins))
    p_out = (ctypes.c_void_p * n)(*(v.data_ptr() for v in outs))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdr_psk31(
            xr.data_ptr(), xi.data_ptr(), bank.data_ptr(), idx.data_ptr(),
            p_in, p_out, bits.data_ptr(), emits.data_ptr(), k["alpha"],
            k["beta"], k["df"], k["omega_min"], k["omega_max"], k["gain_mu"],
            k["gain_omega"], 2 * math.pi, c, t, ctypes.c_void_p(stream))
    _check(name, lib, rc)
    bpsk31_scan.launches += 1
    got = dict(zip(_F_LEAVES + _I_LEAVES + _RING, outs))
    new = {}
    for key, v in carry.items():
        if key == "dl_idx":
            new[key] = (idx + t) % 8
        elif isinstance(v, Complex):
            new[key] = Complex(got[(key, "re")], got[(key, "im")])
        else:
            new[key] = got[(key, None)]
    return new, bits, emits
