"""Where the pager's bit clock starts, and what that decides, seed by seed.

    python3 -m benchmark.clock_witness --workload pager.capture
        --seeds 1 2 3 ... [--seconds 10] [--states 32] [--out <file.jsonl>]

For each seed: one run of the cell on the card at its own size and load,
keeping the program's clock phase and rate at the start of every period
of the capture that the window ran (``--states`` of them, evenly spaced,
and always the last whole one).  Then, over the reference's symbols of the
page channels, the planned pages that each decodes from each of those
starts:

* the reference's bit clock (``reference/pager_scan.py``);
* the program's own PLL on the card (its kernel) and on the CPU (its
  plain version);

and the pages the program itself decoded in its last whole period (the
comparison's ``pages_diff``), and those the reference's clock decodes on
its own: from phase 0 and the nominal rate, run over the period before
(the capture repeats).  One JSON line a seed: how many starts slip pages,
which, and whether the three clocks and the program agree on every start.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json

import numpy as np
import torch

from benchmark import harness, manifest, signals
from benchmark.reference import pager_scan as reference


class _Keep(dict):
    """The system's record of period starts, with nothing dropped."""

    def pop(self, *args):
        return None


def _pll_bits(pll, sym, start, baud, fs_ch, device) -> list:
    """Each column's bits from the program's PLL ``pll`` over ``sym``
    (T, C) from ``start`` (reference.bit_clock's order)."""
    signs, sums, ph, om = start
    om0 = np.float32(baud / fs_ch)

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    out, *_ = pll(t(sym.T.astype(np.uint8), torch.uint8),
                  t(signs, torch.int32), t(sums, torch.int32),
                  t(ph, torch.float32), t(om, torch.float32),
                  torch.zeros(len(ph), dtype=torch.int32, device=device),
                  omega_min=float(om0) * (1 - 0.005),
                  omega_max=float(om0) * (1 + 0.005), gain=0.0005,
                  transition=False)
    out = out.cpu().numpy()
    return [(o & 1)[(o & 2) != 0] for o in out]


def witness(cell, seed: int, seconds: float, device="cuda",
            states: int = 32) -> dict:
    from libsdr_tpu_torch.decode import pocsag_decode_bits
    from libsdr_tpu_torch.ops.pfb import lane_of_channel
    from libsdr_tpu_torch.ops.pll import pll, pll_plain

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    made = signals.make(cfg, tr, seed, dev, root=cell.root)
    system = cell.module("systems", cfg["system"]).System(cfg, tr, made, seed,
                                                          dev)
    system.warm()
    system.starts = _Keep()
    harness.drive(system, seconds, int(tr["in_flight"]), dev)
    plan, planned = system.plan, reference.planned_pages(system.plan)
    chans = [ch for ch, _, _ in plan]
    n, r, fed = len(system.inputs), len(system.ring), system.fed
    last = next(s for s in range(len(fed) - n, len(fed) - r - 1, -1)
                if fed[s] == 0)
    packed = torch.cat([system.ring[j % r] for j in range(last, last + n)],
                       dim=-1).numpy()
    data, valid = packed & 1, packed >= 2
    got = {(ch, p.address, p.function,
            tuple((p.payload[i // 8] >> (7 - i % 8)) & 1
                  for i in range(p.bits)))
           for ch in chans
           for p in pocsag_decode_bits(data[ch][valid[ch]])} & planned
    keys = sorted(k for k in system.starts if k <= last)
    pick = sorted({keys[int(i)] for i in np.linspace(0, len(keys) - 1,
                                                     min(states, len(keys)))}
                  | {last})
    lanes = torch.as_tensor(lane_of_channel(int(cfg["channels"])))
    clocks = [tuple(v.cpu()[lanes].numpy()[chans] for v in system.starts[k])
              for k in pick]
    blocks = system.blocks
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    baud = float(cfg["baud"])
    fs_ch = float(cfg["sample_rate"]) / int(cfg["channels"])
    _, sym = reference.symbols(cfg, blocks)
    sym = np.ascontiguousarray(sym[:, chans])
    c = len(chans)
    own = reference.own_clock(cfg, sym)
    # every start side by side: c columns a start, the clock's own last
    wide = np.tile(sym, (1, len(pick) + 1))
    clock = [np.concatenate([cl[i] for cl in clocks] + [own[i]])
             for i in range(2)]
    start = reference.history(wide, int(fs_ch / baud)) + tuple(clock)
    by = {"ref": reference.scan(cfg, wide, n, clock)[1],
          "card_pll": _pll_bits(pll, wide, start, baud, fs_ch, dev),
          "cpu_pll": _pll_bits(pll_plain, wide, start, baud, fs_ch, "cpu")}
    pages = {k: [reference.pages(dict(zip(chans, bits[i * c:(i + 1) * c])))
                 & planned for i in range(len(pick) + 1)]
             for k, bits in by.items()}
    ref = pages["ref"]
    slipped = {pick[i]: sorted(ch for ch, *_ in planned - ref[i])
               for i in range(len(pick)) if ref[i] != planned}
    return {
        "seed": seed, "planned": len(planned), "periods": len(keys),
        "starts": len(pick), "starts_slipping": len(slipped),
        "slipped": {str(k): v for k, v in slipped.items()},
        "own_clock_pages": len(ref[-1]),
        "program_pages": len(got),
        "program_is_ref_from_its_start": got == ref[pick.index(last)],
        "card_and_cpu_pll_are_ref": all(
            pages[k][i] == ref[i] for k in ("card_pll", "cpu_pll")
            for i in range(len(ref))),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="pager.capture")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--states", type=int, default=32)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("benchmark.clock_witness: no CUDA device")
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        line = json.dumps(witness(cell, seed, args.seconds,
                                  states=args.states))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
