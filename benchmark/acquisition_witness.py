"""How often a PSK31 burst from silence is decoded, and how much that turns
on a float32 rounding of the input, by the plain reference alone.

    python3 -m benchmark.acquisition_witness --seeds 21 22 23 ...
        [--channels 16] [--eps 1e-7] [--device cpu]

For each seed: ``mode_band``'s capture at ``--channels`` channels of the
cell's channel rate, every channel PSK31 (one burst each, at the cell's
preamble, postamble, offset, gains and noise), the reference's float64
channelizer and select, then its float32 BPSK31 from the loop's starting
state (``ops/psk31.BPSK31``'s) over the period twice; the second period's
texts are decoded.  Then the same with the select's output scaled by
1 + ``--eps`` before its rounding to complex64: a change at the size of
float32's rounding, as the program's float32 select is from the
reference's float64 one.  One JSON line a seed: the bursts planned, those
decoded from each input, and those decoded from one only.  Where a burst
that one input decodes the other does not, whether the loop acquires in
time turns on its state to the last bit, and no side of a comparison of
single messages is right: the bank's ``msgs_missed`` counts against the
plan.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json

import numpy as np
import torch

from benchmark import manifest, signals
from benchmark.reference import multimode as reference


def start_state(c: int, fs: float) -> dict:
    """BPSK31's state before its first sample, (C,) lanes (the program's
    ``BPSK31`` starts so)."""
    f32 = np.float32

    def z():
        return np.zeros(c, f32)
    return dict(P=z(), F=z(), mu=np.full(c, 0.25, f32),
                omega=np.full(c, f32(fs / (reference.SUPER
                                           * reference.PSK31_BAUD)), f32),
                dl=np.zeros((c, 8), np.complex64), dl_idx=0,
                p0=np.zeros(c, np.complex64), p1=np.zeros(c, np.complex64),
                c0=z(), c1=z(), hist_sum=z(), hist_prev=z(),
                hist_idx=np.zeros(c, np.int32),
                last_const=np.ones(c, np.int32))


def witness(seed: int, channels: int, eps: float, device) -> dict:
    cell = manifest.cell("multimode.capture")
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    fs_c = cfg["sample_rate"] / cfg["channels"]
    cfg.update(channels=channels, sample_rate=channels * fs_c,
               pattern="psk31")
    tr["block_samples"] = channels * (tr["block_samples"]
                                      // cell.config["channels"])
    blocks, plan = signals.make(cfg, tr, seed, device, root=manifest.ROOT)
    x = torch.cat([torch.complex(re.double(), im.double())
                   for re, im in blocks])
    p = int(cfg["taps_per_branch"])
    y = reference.channelize(x, x[-p * channels:], channels, p)
    chain = cfg["chains"]["psk31"]
    bb = reference.psk31_baseband(y.T.contiguous(), fs_c, chain)
    bb = bb.cpu().numpy()
    d = int(fs_c / chain["out_rate"])
    k = reference.bpsk31_constants(fs_c / d, chain)
    t = bb.shape[-1]
    found = []
    for scale in (1.0, 1.0 + eps):
        twice = (np.concatenate([bb, bb], -1) * scale).astype(np.complex64)
        bits, emit = reference.bpsk31(twice, start_state(channels, fs_c / d),
                                      k)
        texts = [reference.decoded("psk31", bits[r, t:][emit[r, t:]])
                 for r in range(channels)]
        found.append([m.content in texts[m.ch] for m in plan])
    return {"seed": seed, "planned": len(plan), "decoded": sum(found[0]),
            "decoded_scaled": sum(found[1]),
            "one_only": sum(a != b for a, b in zip(*found))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--eps", type=float, default=1e-7)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args(argv)
    for seed in a.seeds:
        print(json.dumps(witness(seed, a.channels, a.eps, a.device)),
              flush=True)


if __name__ == "__main__":
    main()
