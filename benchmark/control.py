"""The readings that the limits of ``correct`` are set from, in one process.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 ...
        [--seconds 2] [--planes float32 bfloat16] [--out <file.jsonl>]

For each plane precision and seed: one run of the cell on the card at its
own size and load, for a short window, and the numbers its comparison
read.  ``float32`` is the program as the configuration states it; its
largest reading over a dozen seeds is a limit's lower reading.
``bfloat16`` is the control: the program's own path with bfloat16 planes,
the nearest precision below float32, whose smallest reading is the upper
one.  One JSON line a run on standard output (and appended to ``--out``).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--planes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, manifest

    if not torch.cuda.is_available():
        raise SystemExit("benchmark.control: no CUDA device")
    cell = manifest.cell(args.workload)
    for planes in args.planes:
        for seed in args.seeds:
            t = time.perf_counter()
            r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t,
                                 planes=planes)
            line = json.dumps({"workload": args.workload, "planes": planes,
                               "seed": seed, "correct": r["correct"],
                               "compared": r["compared"],
                               "metrics": r["metrics"],
                               "reference_s": r["reference_s"],
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            del r
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
