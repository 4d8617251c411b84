"""FSK/ASK symbol detection (counterpart of ``libsdr_tpu.ops.fsk``).

The FSK detector is a dual tone correlator: with ``u[k] = x[k] * T[k mod
L]`` for each tone template T, the symbol is ``|sum of the last L u_mark|^2
- |sum of the last L u_space|^2 > 0``.  The template phase follows the
absolute sample index mod L (the carried ``n0``), and the correlator's
history is the carried last L-1 products of each tone.
"""

from __future__ import annotations

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.core.stream import StreamSpec
from libsdr_tpu_torch.ops.fir import full_f32

_S = 128          # frame width of the banded-matmul sliding sum
_WMAT: dict = {}  # (L, device) -> the band matrix


def _window_mat(L: int) -> np.ndarray:
    """((npv+1)*S, S) 0/1 band matrix for the length-L sliding sum over
    S-sample frames with npv = ceil((L-1)/S) previous frames of context:
    with ``w`` one row of stacked frames (current frame last), ``w @ M``
    gives the sum of the L samples ending at each offset of the current
    frame (the JAX package's matrix)."""
    npv = -(-(L - 1) // _S)
    m = np.zeros(((npv + 1) * _S, _S), np.float32)
    for o in range(_S):
        end = npv * _S + o
        m[max(0, end - L + 1):end + 1, o] = 1.0
    return m


def window_sum(full: torch.Tensor, L: int) -> torch.Tensor:
    """Sums of L consecutive samples of ``full`` (..., L-1+B), one for each
    of its last B samples, each added in one fixed order (oldest first), so
    a sum does not depend on where the block boundaries fall."""
    b = full.shape[-1] - (L - 1)
    s = full[..., :b].clone()
    for k in range(1, L):
        s += full[..., k:k + b]
    return s


def sliding_sum(tail: Complex, u: Complex, L: int):
    """Length-L sliding sum over ``concat([tail, u])`` ending at each sample
    of ``u``.  Returns (sums (..., B) Complex, new_tail (..., L-1)).

    A block that is a multiple of 128 samples takes the banded matmul of the
    JAX package (one GEMM over 128-sample frames with ceil((L-1)/128) frames
    of context, in full float32); other blocks the direct sums of
    :func:`window_sum`."""
    b = u.shape[-1]
    full = cplx.concatenate([tail, u], axis=-1)
    # a copy: a view would keep the whole concatenation alive in the carry
    new_tail = full[..., full.shape[-1] - (L - 1):].map(torch.clone)
    if b % _S:
        return full.map(lambda v: window_sum(v, L)), new_tail
    npv = -(-(L - 1) // _S)
    f = b // _S
    dev = u.re.device
    key = (L, str(dev))
    if key not in _WMAT:
        _WMAT[key] = torch.from_numpy(_window_mat(L)).to(dev)
    mat = _WMAT[key]

    def sums(tail_p, up):
        lead = torch.zeros(up.shape[:-1] + (npv * _S - (L - 1),),
                           dtype=up.dtype, device=dev)
        g = torch.cat([lead, tail_p, up], dim=-1)
        w = torch.cat([g[..., i * _S:(i + f) * _S].reshape(
            up.shape[:-1] + (f, _S)) for i in range(npv + 1)], dim=-1)
        with full_f32():
            return torch.matmul(w, mat).reshape(up.shape)

    return Complex(sums(tail.re, u.re), sums(tail.im, u.im)), new_tail


def tone_tables(f_mark: float, f_space: float, fs: float, L: int):
    """The (L,) complex mark and space templates exp(2j pi f i / fs) over one
    ring period (positive exponent)."""
    i = np.arange(L)
    return (np.exp(2j * np.pi * f_mark * i / fs),
            np.exp(2j * np.pi * f_space * i / fs))


class FSKDetector(Processor):
    """Mark/space dual correlator -> symbol stream at the input rate.

    Args:
      baud: baud rate (sets the correlator length L = floor(fs/baud)).
      f_mark, f_space: tone frequencies in Hz.

    The carry is ``(n0, tail_m, tail_s)``: n0 an int32 scalar (the template
    phase, the absolute sample index mod L) and the Complex (channels +
    (L-1,)) float32 last products of each tone — the JAX op's carry, leaf
    for leaf.
    """

    def __init__(self, baud: float, f_mark: float, f_space: float):
        super().__init__()
        self.baud = float(baud)
        self.f_mark = float(f_mark)
        self.f_space = float(f_space)
        self._dev = {}

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_real("FSKDetector")
        fs = in_spec.rate_hz
        self.corr_len = int(fs / self.baud)
        self._tables = tone_tables(self.f_mark, self.f_space, fs,
                                   self.corr_len)
        self._dev = {}
        return in_spec.with_(dtype=torch.uint8)

    def _consts(self, device):
        """The templates and the block's sample ramp on ``device``."""
        key = str(device)
        if key not in self._dev:
            mark, space = self._tables
            self._dev[key] = (
                cplx.constant(mark, torch.float32, device),
                cplx.constant(space, torch.float32, device),
                torch.arange(self.in_spec.block_size, device=device))
        return self._dev[key]

    def _init_carry(self, device):
        ch = self.in_spec.channels
        L = self.corr_len
        return (torch.zeros((), dtype=torch.int32, device=device),
                cplx.zeros(ch + (L - 1,), torch.float32, device),
                cplx.zeros(ch + (L - 1,), torch.float32, device))

    def apply(self, carry, x):
        n0, tail_m, tail_s = carry
        L = self.corr_len
        b = x.shape[-1]
        x = x.float()
        mark, space, ramp = self._consts(x.device)
        idx = (n0 + ramp) % L         # the template phase of every sample
        s_m, tail_m = sliding_sum(tail_m, mark[idx] * x, L)
        s_s, tail_s = sliding_sum(tail_s, space[idx] * x, L)
        f = (s_m.re * s_m.re + s_m.im * s_m.im) - (
            s_s.re * s_s.re + s_s.im * s_s.im)
        return ((n0 + b) % L, tail_m, tail_s), (f > 0).to(torch.uint8)


class ASKDetector(Processor):
    """Threshold-at-zero symbol detector (for FM-demodulated FSK, e.g.
    POCSAG): symbol = (x > 0) xor invert."""

    def __init__(self, invert: bool = False):
        super().__init__()
        self.invert = invert

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_real("ASKDetector")
        return in_spec.with_(dtype=torch.uint8)

    def apply(self, carry, x):
        sym = x > 0
        if self.invert:
            sym = ~sym
        return carry, sym.to(torch.uint8)
