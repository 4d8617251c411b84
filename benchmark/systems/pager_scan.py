"""The whole-band pager scanner on the card: the program's
``parallel/wideband.build_scanner_step`` (channelizer and FM discriminator
in one kernel, then the ASK detector, the bit-sync PLL and the windowed
on-device compaction, bits packed with their valid flags), in the loop of
``apps/scanner.scan_blocks``: each block placed and stepped, its packed
bits read back to the host (here into a ring of pinned buffers, without a
host sync), the carry running on.  The capture's blocks are held on the
card and replayed in turn.

After the window, the packed bits of the last whole period of the
capture, and the pages the program's ``decode.pocsag_decode_bits`` finds
in them, are judged against ``reference/pager_scan.py`` over the same
period, with the channelizer's last output in the carry:

* ``chan_err``: the channelizer's last frame, every channel;
* ``bits_diff``: the packed windows, unlike the reference's, of the
  checked channels (every page channel and ``noise_channels`` more drawn
  from the seed);
* ``pages_diff``: the planned pages decoded by one side only.

The reference works out the clock's symbol history itself (the period's
last symbols) and takes from the program only the clock's phase and rate
at the period's first block (copied on the card as the window hands the
carry on).  The clock has only a frequency nudge: two clocks from
different phases never meet on a noise channel, and whether one locks on
a page's preamble in time depends on where the noise before left it
(``clock_witness.py`` counts how often).  The carry across a block's
edge, inside the period, is the reference's own throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import pager_scan as reference

PLANES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CLOCK = ("phase", "omega")      # the bit clock's free-running state


def _payload_bits(msg) -> tuple:
    return tuple((msg.payload[i // 8] >> (7 - i % 8)) & 1
                 for i in range(msg.bits))


class System:
    """The program's scanner step over ``made``, the traffic's (blocks,
    page plan)."""

    def __init__(self, config: dict, traffic: dict, made, seed: int, device,
                 planes: str = None):
        from libsdr_tpu_torch.core.cplx import Complex
        from libsdr_tpu_torch.core.ragged import min_valid_gap, pick_window
        from libsdr_tpu_torch.parallel.wideband import build_scanner_step

        self.config = config
        self.blocks, self.plan = made
        self.seed = seed
        dtype = PLANES[planes or config["planes"]]
        self.inputs = [Complex(re.to(dtype), im.to(dtype))
                       for re, im in self.blocks]
        m, b = int(config["channels"]), int(traffic["block_samples"])
        fs, baud = float(config["sample_rate"]), float(config["baud"])
        frames = b // m
        # the scanner app's window: a lossless decimation of the bit stream
        w = pick_window(min_valid_gap((baud / (fs / m)) * 1.005), frames)
        self.step, init, self.place = build_scanner_step(
            m, b, fs, taps_per_branch=int(config["taps_per_branch"]),
            baud=baud, compact_window=w,
            plane_dtype=None if dtype == torch.float32 else dtype,
            packed=True, device=device)
        self.carry = init()
        n = len(self.inputs)
        # the last 2n - 1 read-backs hold a whole period from block 0
        pin = torch.device(device).type == "cuda"
        self.ring = [torch.empty((m, frames // max(w, 1)), dtype=torch.uint8,
                                 pin_memory=pin) for _ in range(2 * n - 1)]
        self.fed = []
        self.starts = {}        # dispatch -> the clock state handed to it
        self.blocks_per_dispatch = 1
        self.samples_per_block = b
        self.min_dispatches = len(self.ring)

    def dispatch(self, i: int) -> None:
        idx = i % len(self.inputs)
        if idx == 0:
            self.starts[i] = [self.carry[1][k].clone() for k in CLOCK]
            self.starts.pop(i - 2 * len(self.ring), None)
        self.carry, y = self.step(self.carry, self.place(self.inputs[idx]))
        self.ring[i % len(self.ring)].copy_(y, non_blocking=True)
        self.fed.append(idx)

    def warm(self) -> None:
        """One period of the capture; the window then starts it again."""
        for i in range(len(self.inputs)):
            self.dispatch(i)
        self.fed.clear()
        self.starts.clear()

    def launches(self) -> int:
        from libsdr_tpu_torch.core.graph import kernel_entries
        return sum(e.launches for e in kernel_entries())

    def checked(self) -> np.ndarray:
        """The channels whose windows are compared: every page channel and
        ``noise_channels`` others drawn from the seed."""
        m = int(self.config["channels"])
        pages = [ch for ch, _, _ in self.plan]
        rest = np.setdiff1d(np.arange(m), pages)
        k = min(int(self.config["noise_channels"]), len(rest))
        drawn = np.random.default_rng(self.seed).choice(rest, k,
                                                        replace=False)
        return np.sort(np.concatenate([pages, drawn]))

    def judge(self) -> dict:
        from libsdr_tpu_torch.decode import pocsag_decode_bits
        from libsdr_tpu_torch.ops.pfb import lane_of_channel

        cfg, n, r = self.config, len(self.inputs), len(self.ring)
        m = int(cfg["channels"])
        pages = [ch for ch, _, _ in self.plan]
        start = next(s for s in range(len(self.fed) - n, len(self.fed) - r - 1,
                     -1) if self.fed[s] == 0)
        packed = torch.cat([self.ring[j % r] for j in range(start, start + n)],
                           dim=-1).numpy()
        data, valid = packed & 1, packed >= 2
        got = {(ch, p.address, p.function, _payload_bits(p))
               for ch in pages
               for p in pocsag_decode_bits(data[ch][valid[ch]])}
        # the program runs lane-major: its carry's leaves by lane
        lanes = torch.as_tensor(lane_of_channel(m))
        clock = tuple(v.cpu()[lanes].numpy() for v in self.starts[start])
        y = self.carry[0][1]
        y_last = torch.complex(y.re.double(), y.im.double())[0, lanes.to(
            y.re.device)]
        last = self.fed[-1]
        del self.step, self.carry, self.place, self.inputs, self.ring
        del self.starts
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        y_ref, sym = reference.symbols(cfg, self.blocks)
        frames = y_ref.shape[0] // n
        chan_err = reference.rel_gap(y_last, y_ref[(last + 1) * frames - 1])
        del y_ref
        checked = self.checked()
        ref_packed, ref_bits = reference.scan(
            cfg, sym[:, checked], n, [v[checked] for v in clock])
        ref_pages = reference.pages({ch: ref_bits[int(np.searchsorted(
            checked, ch))] for ch in pages})
        lim = cfg["limits"]
        return {
            "chan_err": (chan_err, lim["chan_err"]),
            "bits_diff": (int((packed[checked] != ref_packed).sum()),
                          lim["bits_diff"]),
            "pages_diff": (reference.pages_gap(got, ref_pages, self.plan),
                           lim["pages_diff"]),
        }
