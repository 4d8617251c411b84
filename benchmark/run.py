"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds the program (``libsdr_tpu_torch``).
The run needs the card (CUDA) and as many as the cell asks for; without
them it exits 2 and prints no result.  It builds nothing outside the
checkout: the program's kernels go to ``build/`` there.  The last line of
standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number the comparison with the plain reference read,
beside its limit, which also end standard error).  The run fails, and
prints no result, when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "libsdr_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole: ``libsdr_tpu_torch`` is not
    ``libsdr_tpu``."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    stamps = [("torch", time.perf_counter())]

    from benchmark import harness, manifest

    cell = manifest.cell(args.workload)
    available = torch.cuda.is_available()
    stamps.append(("driver", time.perf_counter()))
    if not available:
        print("benchmark: no CUDA device: the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START,
                              stamps=stamps)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}: the program and "
              "the benchmark must not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
