"""Bit-clock recovery PLL (counterpart of ``libsdr_tpu.ops.bitsync``).

A per-sample PLL recovers the bit clock: a majority vote over the last L
symbols, a phase accumulator that samples a bit on overflow, and a +-0.5%
bounded frequency nudge on every symbol transition.  It is sequential in
time and parallel across channels; each block is one call of
``ops/pll.pll`` (the kernel of ``csrc/bitsync.cu`` on a card), and
:func:`bitstream_bank_apply` runs several BitStreams with different
parameters as one ``pll_bank`` call.

The output is a :class:`~libsdr_tpu_torch.core.ragged.Ragged` bit stream:
one slot per input symbol, valid where the PLL sampled a bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from libsdr_tpu_torch.core.block import Processor
from libsdr_tpu_torch.core.ragged import Ragged, compact_windows
from libsdr_tpu_torch.core.stream import StreamSpec
from libsdr_tpu_torch.ops.pll import pll, pll_bank
from libsdr_tpu_torch.utils.profiling import span

NORMAL = "normal"          # mark -> 1, space -> 0
TRANSITION = "transition"  # transition -> 0, no transition -> 1 (NRZI)


class BitStream(Processor):
    """Args:
      baud: bit rate of the input symbol stream.
      mode: 'normal' or 'transition'.
      time_major: when True, blocks are (T, channels...) instead of
        (channels..., T); the carry layout is unchanged.

    The carry is a dict, the JAX op's leaf for leaf: ``signs`` (channels +
    (L-1,)) int32, the last L-1 symbol signs; ``sym_sum`` (channels) int32,
    the previous window sum; ``phase`` and ``omega`` float32; ``last_bits``
    int32.
    """

    def __init__(self, baud: float, mode: str = TRANSITION,
                 time_major: bool = False):
        super().__init__()
        if mode not in (NORMAL, TRANSITION):
            raise ValueError(f"BitStream: unknown mode {mode!r}")
        self.baud = float(baud)
        self.mode = mode
        self.time_major = bool(time_major)

    def _bind(self, in_spec: StreamSpec) -> StreamSpec:
        in_spec.require_dtype("BitStream", torch.uint8)
        fs = in_spec.rate_hz
        self.corr_len = int(fs / self.baud)
        self._omega0 = self.baud / fs
        self._omega_min = self._omega0 * (1 - 0.005)
        self._omega_max = self._omega0 * (1 + 0.005)
        self._pll_gain = 0.0005
        return in_spec.with_(dtype=torch.uint8, sample_rate=self.baud,
                             ragged=True)

    def _init_carry(self, device):
        ch = self.in_spec.channels
        return dict(
            signs=torch.zeros(ch + (self.corr_len - 1,), dtype=torch.int32,
                              device=device),
            sym_sum=torch.zeros(ch, dtype=torch.int32, device=device),
            phase=torch.zeros(ch, dtype=torch.float32, device=device),
            omega=torch.full(ch, self._omega0, dtype=torch.float32,
                             device=device),
            last_bits=torch.zeros(ch, dtype=torch.int32, device=device))

    def apply(self, carry, x):
        ch = tuple(x.shape[1:] if self.time_major else x.shape[:-1])
        new_carry, out = self.apply_packed(carry, x)
        return new_carry, _unpack(out, ch, self.time_major)

    def apply_packed(self, carry, x):
        """:meth:`apply` before the unpacking: (new carry, the PLL's (M,
        T) uint8 bytes, bit | valid << 1), lanes first, M the product of
        the channel axes."""
        x_c = x.movedim(0, -1) if self.time_major else x   # (ch..., T)
        ch, t = tuple(x_c.shape[:-1]), x_c.shape[-1]
        m = math.prod(ch)
        out, sg, ss, ph, om, lb = pll(
            x_c.reshape(m, t), carry["signs"].reshape(m, -1),
            carry["sym_sum"].reshape(m), carry["phase"].reshape(m),
            carry["omega"].reshape(m), carry["last_bits"].reshape(m),
            omega_min=self._omega_min, omega_max=self._omega_max,
            gain=self._pll_gain, transition=self.mode == TRANSITION)
        new_carry = dict(signs=sg.reshape(ch + (-1,)), sym_sum=ss.reshape(ch),
                         phase=ph.reshape(ch), omega=om.reshape(ch),
                         last_bits=lb.reshape(ch))
        return new_carry, out


def _unpack(out, ch, time_major=False) -> Ragged:
    """Packed (M, T) bit | valid << 1 bytes as a Ragged (ch..., T)."""
    out = out.reshape(ch + (out.shape[-1],))
    bits, valid = out & 1, (out & 2) != 0
    if time_major:
        bits, valid = bits.movedim(-1, 0), valid.movedim(-1, 0)
    return Ragged(bits, valid)


def bitstream_bank_supported(entries) -> bool:
    """True when one banked call can run this set of ``(bitstream, carry,
    x)``: two or more entries, channel-major blocks, all of one length."""
    return (len(entries) >= 2
            and not any(bs.time_major for bs, _, _ in entries)
            and len({x.shape[-1] for _, _, x in entries}) == 1)


def bitstream_bank_apply(entries):
    """Run several bound BitStreams as ONE ``pll_bank`` call.

    ``entries``: list of ``(bitstream, carry, x)`` with ``x`` shaped
    ``(channels..., T)`` uint8, all of one T.  Returns a list of
    ``(new_carry, Ragged)`` in order, lane by lane equal to calling each
    ``bitstream.apply`` on its own (the same recurrence with per-lane
    parameters).  The PLL is sequential in time, so N separate calls pay N
    serial passes over T; stacked lanes pay one.  A set that
    :func:`bitstream_bank_supported` refuses runs entry by entry."""
    if not bitstream_bank_supported(entries):
        return [bs.apply(c, x) for bs, c, x in entries]
    t = entries[0][2].shape[-1]
    ms = [math.prod(x.shape[:-1]) for _, _, x in entries]
    nring = max(bs.corr_len for bs, _, _ in entries) - 1
    dev = entries[0][2].device
    params = [np.concatenate([np.full(mi, v, dt) for mi, v in zip(ms, vals)])
              for vals, dt in (
                  ([bs._omega_min for bs, _, _ in entries], np.float32),
                  ([bs._omega_max for bs, _, _ in entries], np.float32),
                  ([bs._pll_gain for bs, _, _ in entries], np.float32),
                  ([int(bs.mode == TRANSITION) for bs, _, _ in entries],
                   np.int32),
                  ([bs.corr_len for bs, _, _ in entries], np.int32))]
    sym = torch.cat([x.reshape(mi, t) for (_, _, x), mi in zip(entries, ms)])
    # Each lane's carried signs in the last L-1 of nring columns.
    signs = torch.cat([torch.nn.functional.pad(
        c["signs"].reshape(mi, -1).to(dev, torch.int32),
        (nring - (bs.corr_len - 1), 0)) for (bs, c, _), mi in zip(entries,
                                                                  ms)])

    def lanes(key):
        return torch.cat([c[key].reshape(mi).to(dev)
                          for (_, c, _), mi in zip(entries, ms)])

    out, sg, ss, ph, om, lb = pll_bank(
        sym, signs, lanes("sym_sum"), lanes("phase"), lanes("omega"),
        lanes("last_bits"), omega_min=params[0], omega_max=params[1],
        gain=params[2], transition=params[3], ell=params[4])
    results, off = [], 0
    for (bs, _, x), mi in zip(entries, ms):
        sl = slice(off, off + mi)
        ch = tuple(x.shape[:-1])
        new_c = dict(signs=sg[sl, nring - (bs.corr_len - 1):].reshape(
                         ch + (-1,)),
                     sym_sum=ss[sl].reshape(ch), phase=ph[sl].reshape(ch),
                     omega=om[sl].reshape(ch), last_bits=lb[sl].reshape(ch))
        results.append((new_c, _unpack(out[sl], ch)))
        off += mi
    return results


def apply_mode_chains(sub, carries, y, groups, windows):
    """Run every mode pipeline on its channel group of the complex bank
    ``y``, merging all final BitStream PLLs into one banked call
    (:func:`bitstream_bank_apply`).

    ``sub``: {mode: bound Pipeline}; ``carries``: {mode: carry};
    ``groups``: {mode: channel indices into y's leading axis}; ``windows``:
    {mode: compaction window (0 for none, see core/ragged.compact_windows)}.
    Returns (outs, new_carries), both keyed by mode.

    Spans (``utils/profiling.span``): ``multimode.chains`` around each
    banked group's stages before its PLL, ``multimode.<mode>`` around each
    group without a BitStream (PSK31's baseband and BPSK31),
    ``multimode.pll`` around the banked PLL and ``multimode.compact``
    around the groups' windowed compaction; on a card the last three time
    the card's work too."""
    card = y.re.device.type == "cuda"

    def take_rows(bank, idxs):
        # A round-robin mode pattern makes a group an arithmetic
        # progression: a strided slice instead of a row gather.
        idxs = np.asarray(idxs)
        if len(idxs) > 1:
            d = np.diff(idxs)
            if np.all(d == d[0]) and d[0] > 0:
                s, st = int(idxs[0]), int(d[0])
                return bank[s:s + st * len(idxs):st]
        return bank[torch.as_tensor(idxs, device=bank.device)]

    def compacted(bits, mode):
        return compact_windows(bits, windows[mode]) if windows[mode] else bits

    outs, new = {}, {}
    banked = []   # (mode, bitstream, carry, symbols, new front carries)
    for mode, p in sub.items():
        pc = carries[mode]
        xm = take_rows(y, groups[mode])
        if isinstance(p.stages[-1], BitStream):
            new_pre = []
            with span("multimode.chains"):
                for stage, c in zip(p.stages[:-1], pc[:-1]):
                    c, xm = stage.apply(c, xm)
                    new_pre.append(c)
            banked.append((mode, p.stages[-1], pc[-1], xm, tuple(new_pre)))
        else:
            with span("multimode." + mode, card):
                new[mode], bits = p.apply(pc, xm)
                outs[mode] = compacted(bits, mode)
    if banked:
        with span("multimode.pll", card):
            results = bitstream_bank_apply(
                [(bs, c, xm) for _, bs, c, xm, _ in banked])
        with span("multimode.compact", card):
            for (mode, _, _, _, new_pre), (nc, bits) in zip(banked,
                                                            results):
                new[mode] = new_pre + (nc,)
                outs[mode] = compacted(bits, mode)
    return outs, new
