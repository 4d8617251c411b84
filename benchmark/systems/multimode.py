"""The multi-mode decoder bank on the card: the program's
``parallel/multimode.build_multimode_step`` on one device (the channelizer,
K4's channel variant, then each mode's chain on its channels:
``ops/bitsync.apply_mode_chains``, the three bit clocks as one banked PLL
launch, PSK31's select and BPSK31), as ``apps/multimode._run_bank`` drives
it: each block placed and stepped, its bits packed into one uint8 tensor
(``apps/multimode.pack_bank_outputs``) and read back (here into a ring of
pinned buffers, without a host sync), the carry running on.  The capture's
blocks are held on the card and replayed in turn; the host decodes after
the window.

After the window, the bits of the last whole period of the capture, and
what the program's decoders find in them, are judged against
``reference/multimode.py`` over the same period:

* ``chan_err``: the channelizer's last frame, every channel, max gap / max;
* ``stage_err``: each group's last continuous stage before its symbols
  (the FM audio of POCSAG and AX.25; RTTY's USB audio; PSK31's baseband),
  max gap / max, over the last block; the FM audio's gap, an angle's,
  weighed by the magnitude of the product it is the angle of
  (``reference/multimode.fm_gap``);
* ``bits_diff``: the packed windows (PSK31's symbol slots) unlike the
  reference's, over the checked channels (every message channel and
  ``noise_channels`` more drawn from the seed);
* ``msgs_missed``: the largest share, over the modes, of the mode's
  planned messages that the program's decoders do not find (against the
  plan, not the reference: where a burst starts from silence, whether a
  loop acquires it in time turns on its state to the last bit, and a
  float32 rounding of the input moves that, the reference's own as much
  as the program's, ``python3 -m benchmark.acquisition_witness``).

The first two are read from the step's own filter, twiddles and first
stages (``step.parts``) run again over the last block from the carry the
window handed it (the step returns only bits).  The reference takes from
the program only the bit clocks' phase, rate and last bit and BPSK31's
state at the period's first block; it works out the rest (the symbol
history, each FSK detector's template phase from the samples fed before)
itself.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import multimode as reference
from benchmark.signals import mode_band

PLANES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CLOCK = ("phase", "omega", "last_bits")     # the bit clock's own state


def _clone(tree):
    """A copy of a carry's leaves (dicts, tuples, tensors, Complex)."""
    from libsdr_tpu_torch.core.cplx import Complex
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    if isinstance(tree, Complex):
        return tree.map(torch.clone)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _host(v) -> np.ndarray:
    """A carry leaf on the host: complex64 for a Complex."""
    from libsdr_tpu_torch.core.cplx import Complex
    if isinstance(v, Complex):
        return (v.re.float().cpu().numpy()
                + 1j * v.im.float().cpu().numpy()).astype(np.complex64)
    return v.cpu().numpy()


def _payload_bits(msg) -> tuple:
    return tuple((msg.payload[i // 8] >> (7 - i % 8)) & 1
                 for i in range(msg.bits))


def program_decode(mode: str, bits: np.ndarray):
    """The program's decoders on one channel's bits, in the reference's
    form (``reference/multimode.decoded``)."""
    from libsdr_tpu_torch.decode import (AX25Decoder, BaudotDecoder,
                                         VaricodeDecoder, pocsag_decode_bits)
    if mode == "pocsag":
        return [(p.address, p.function, _payload_bits(p))
                for p in pocsag_decode_bits(bits)]
    if mode == "ax25":
        dec = AX25Decoder()
        dec.process(bits)
        return dec.frames
    if mode == "rtty":
        return BaudotDecoder(stop_bits="1.5").process(bits)
    return VaricodeDecoder().process(bits)


class System:
    """The program's bank step over ``made``, the traffic's (blocks,
    message plan)."""

    def __init__(self, config: dict, traffic: dict, made, seed: int, device,
                 planes: str = None):
        from libsdr_tpu_torch.core.cplx import Complex
        from libsdr_tpu_torch.parallel.multimode import build_multimode_step

        self.config = config
        self.blocks, self.plan = made
        self.seed = seed
        self.device = torch.device(device)
        dtype = PLANES[planes or config["planes"]]
        self.inputs = [Complex(re.to(dtype), im.to(dtype))
                       for re, im in self.blocks]
        m = int(config["channels"])
        b = int(self.blocks[0][0].shape[-1])   # the generator's rounded block
        self.frames = b // m
        self.step, init, self.place, self.groups = build_multimode_step(
            m, b, float(config["sample_rate"]),
            mode_band.pattern(config),
            taps_per_branch=int(config["taps_per_branch"]),
            plane_dtype=None if dtype == torch.float32 else dtype,
            mesh=None, device=self.device)
        # which channel carries which mode, as the configuration states it
        # (the program's own ``groups`` say where its rows come from)
        self.modes = {}
        for ch in range(m):
            self.modes.setdefault(mode_band.mode_of(config, ch), []).append(ch)
        self.carry = self.prev = init()
        self.ring, self.layout = None, None
        self.fed = []
        self.starts = {}        # dispatch -> the chains' state handed to it
        self.warmed = 0
        self.blocks_per_dispatch = 1
        self.samples_per_block = b
        # the last 2n - 1 read-backs hold a whole period from block 0
        self.min_dispatches = 2 * len(self.inputs) - 1

    def dispatch(self, i: int) -> None:
        from libsdr_tpu_torch.apps.multimode import pack_bank_outputs
        idx = i % len(self.inputs)
        if idx == 0:
            self.starts[i] = {mode: _clone(c[-1])
                              for mode, c in self.carry[1].items()}
            self.starts.pop(i - 2 * self.min_dispatches, None)
        self.prev = self.carry
        self.carry, outs = self.step(self.carry, self.place(self.inputs[idx]))
        flat = pack_bank_outputs(outs)
        if self.ring is None:
            from libsdr_tpu_torch.apps.multimode import bank_output_layout
            self.layout = bank_output_layout(outs)
            pin = self.device.type == "cuda"
            self.ring = [torch.empty(flat.shape, dtype=torch.uint8,
                                     pin_memory=pin)
                         for _ in range(self.min_dispatches)]
        self.ring[i % len(self.ring)].copy_(flat, non_blocking=True)
        self.fed.append(idx)

    def warm(self) -> None:
        """One period of the capture; the window then starts it again."""
        for i in range(len(self.inputs)):
            self.dispatch(i)
        self.warmed = len(self.fed)
        self.fed.clear()
        self.starts.clear()

    def launches(self) -> int:
        from libsdr_tpu_torch.core.graph import kernel_entries
        return sum(e.launches for e in kernel_entries())

    def checked(self) -> np.ndarray:
        """The channels whose windows are compared: every message channel
        and ``noise_channels`` others drawn from the seed."""
        m = int(self.config["channels"])
        busy = sorted({msg.ch for msg in self.plan})
        rest = np.setdiff1d(np.arange(m), busy)
        k = min(int(self.config["noise_channels"]), len(rest))
        drawn = np.random.default_rng(self.seed).choice(rest, k,
                                                        replace=False)
        return np.sort(np.concatenate([busy, drawn]).astype(np.int64))

    def _rows(self, mode: str, like: torch.Tensor, groups=None
              ) -> torch.Tensor:
        return torch.as_tensor((groups or self.modes)[mode],
                               dtype=torch.int64, device=like.device)

    def _stages_again(self):
        """The channelizer's output and each group's first stage over the
        last block, run again from the carry the window handed that block
        by the step's own filter, twiddles and stages (``step.parts``):
        ((M,) complex128 last frame, {mode: output})."""
        from libsdr_tpu_torch.parallel.wideband import channelize_local

        m = int(self.config["channels"])
        p = int(self.config["taps_per_branch"])
        parts = self.step.parts
        hist, carries = self.prev
        x = self.place(self.inputs[self.fed[-1]])
        y = channelize_local(x, hist, parts["taps3"], m, p,
                             twiddles=parts["twiddles"])
        last = torch.complex(y.re[:, -1].double(), y.im[:, -1].double())
        out = {}
        for mode in self.groups:
            xm = y[self._rows(mode, y.re, self.groups)]
            _, a = parts["chains"][mode].stages[0].apply(carries[mode][0], xm)
            out[mode] = (torch.complex(a.re.double(), a.im.double())
                         if hasattr(a, "re") else a.double())
        return last, out

    def judge(self) -> dict:
        from libsdr_tpu_torch.apps.multimode import unpack_bank_outputs

        cfg, n, r = self.config, len(self.inputs), len(self.ring)
        m = int(cfg["channels"])
        fs_c = float(cfg["sample_rate"]) / m
        chains = cfg["chains"]
        start = next(s for s in range(len(self.fed) - n, len(self.fed) - r - 1,
                     -1) if self.fed[s] == 0)
        parts = [unpack_bank_outputs(self.ring[j % r].numpy(), self.layout)
                 for j in range(start, start + n)]
        prog = {mode: (np.concatenate([p[mode][0] for p in parts], -1),
                       np.concatenate([p[mode][1] for p in parts], -1))
                for mode in self.groups}
        state = {mode: {k: _host(v) for k, v in c.items()}
                 for mode, c in self.starts[start].items()}
        fed_frames = (self.warmed + start) * self.frames
        y_last, stages = self._stages_again()
        last = self.fed[-1]
        del self.step, self.carry, self.prev, self.place, self.inputs
        del self.ring, self.starts
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

        # the reference over the period
        p = int(cfg["taps_per_branch"])

        def cx(i, s=slice(None)):
            re, im = self.blocks[i]
            return torch.complex(re[s].double(), im[s].double())
        x = torch.cat([cx(i) for i in range(n)])
        y_ref = reference.channelize(x, cx(n - 1, slice(-p * m, None)), m, p)
        del x
        frames = self.frames
        sl = slice(last * frames, (last + 1) * frames)
        chan_err = reference.rel_gap(y_last.to(y_ref.device),
                                     y_ref[(last + 1) * frames - 1])
        checked = set(self.checked().tolist())
        stage_err, bits_diff = 0.0, 0
        got = {}

        def tally(mode, ours, theirs, our_bits):
            """Windows unlike the reference's, and the program's decode, of
            the mode's checked channels (``our_bits``: each row's sampled
            bits)."""
            nonlocal bits_diff
            for row, ch in enumerate(self.modes[mode]):
                if ch in checked:
                    bits_diff += int((ours[row] != theirs[row]).sum())
                    got[ch] = program_decode(mode, our_bits[row])

        # the bit clocks' groups in one pass over time
        clocked = [mo for mo in self.modes if mo != "psk31"]
        ells = {mo: int(fs_c / chains[mo]["baud"]) for mo in clocked}
        big = max(ells.values())
        syms, lane_ell, lane_om0, lane_trans = [], [], [], []
        for mo in clocked:
            yc = y_ref[:, self._rows(mo, y_ref)].T.contiguous()
            stage = stages[mo].to(yc.device)
            if mo == "rtty":
                a = reference.usb(yc)
                gap = reference.rel_gap(stage, a[:, sl])
            else:
                a = reference.fm(yc)
                # the block's frames and the one before (the period wraps)
                ext = torch.cat([yc[:, sl.start - 1:sl.start] if sl.start
                                 else yc[:, -1:], yc[:, sl]], dim=-1)
                gap = reference.fm_gap(stage, ext)
            stage_err = max(stage_err, gap)
            if "f_mark" in chains[mo]:
                n0 = fed_frames % ells[mo]
                sym = reference.fsk_symbols(a, fs_c, chains[mo], n0, big)
            else:
                s = (a <= 0).cpu().numpy()
                sym = np.concatenate([s[:, -big:], s], -1)
            del a, yc
            syms.append(sym)
            c = sym.shape[0]
            lane_ell += [ells[mo]] * c
            lane_om0 += [chains[mo]["baud"] / fs_c] * c
            lane_trans += [chains[mo]["transition"]] * c
        sym = np.ascontiguousarray(np.concatenate(syms).T)
        start_state = [np.concatenate([state[mo][k] for mo in clocked])
                       for k in CLOCK]
        bits, emit = reference.bit_clock(sym, lane_ell, lane_om0, lane_trans,
                                         start_state)
        del sym
        off = 0
        for mo in clocked:
            c = len(self.modes[mo])
            bm, em = bits[:, off:off + c], emit[:, off:off + c]
            w = reference.window(chains[mo]["baud"], fs_c, frames)
            data, valid = prog[mo]
            tally(mo, data | valid.astype(np.uint8) << 1,
                  reference.packed_windows(bm, em, w),
                  [data[r][valid[r]] for r in range(c)])
            off += c
        del bits, emit

        if "psk31" in self.modes:
            mo = "psk31"
            yc = y_ref[:, self._rows(mo, y_ref)].T.contiguous()
            bb = reference.psk31_baseband(yc, fs_c, chains[mo])
            d = frames // (bb.shape[-1] // n)
            stage_err = max(stage_err, reference.rel_gap(
                stages[mo].to(bb.device),
                bb[:, last * frames // d:(last + 1) * frames // d]))
            rb, re_ = reference.bpsk31(
                bb.cpu().numpy().astype(np.complex64), state[mo],
                reference.bpsk31_constants(fs_c / d, chains[mo]))
            del yc, bb
            data, valid = prog[mo]
            v8 = valid.astype(np.uint8)
            c = len(self.modes[mo])
            tally(mo, (data & v8) | v8 << 1, (rb & re_) | re_.astype(
                np.uint8) << 1, [data[r][valid[r]] for r in range(c)])
        del y_ref
        lim = cfg["limits"]
        return {
            "chan_err": (chan_err, lim["chan_err"]),
            "stage_err": (stage_err, lim["stage_err"]),
            "bits_diff": (bits_diff, lim["bits_diff"]),
            "msgs_missed": (reference.missed(self.plan, got),
                            lim["msgs_missed"]),
        }
