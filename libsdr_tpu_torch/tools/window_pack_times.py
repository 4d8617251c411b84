"""The scanner's windowed compaction kernel (``csrc/window_pack.cu``, entry
``ops/pll.window_pack``) on the card: bit for bit its plain version, and
its time beside its bound.

    PYTHONPATH=<tree root> python libsdr_tpu_torch/tools/window_pack_times.py \\
        [--reps 50] [--out window_pack_times.json]

Parity (:func:`parity`): at every shape of :data:`PARITY`, on PLL bytes
drawn from a seed (bit 0 the bit, bit 1 the valid flag, half the steps
valid, so many windows hold 2-3 valid items), the kernel's windows equal
``window_pack_plain``'s, each call one launch on the route its shape
takes.  Times (:func:`time_shape`), at the paths' shapes of :data:`TIMED`:
``ms`` with CUDA events over ``--reps`` calls (the wrapper's host time
included where it is longer than the kernel's), ``device_ms`` the same
calls replayed in a CUDA graph (``tools/pfb_times.kernel_ms``: no host
time), each cycling through input sets of >= 200 MB so that a call reads
its bytes from HBM and not from the 50 MB L2; ``plain_ms`` the plain
version on the card (eager PyTorch, the arithmetic the scanner ran before
this kernel); ``bound_ms`` the bytes read and written at 3.35 TB/s.  The
card's name and power limit are on every line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak

# (label, M, T, w, rows): rows "lanes" is the one-rank scanner's lane map,
# "none" the sharded scanner's identity, "rows" a reversed map of M - 2
# rows, "offset" an input 1 byte off 16-byte alignment (identity rows)
TIMED = (("cell", 1024, 65_536, 16, "lanes"),     # pager.capture
         ("app", 1024, 12_500, 4, "lanes"),       # apps/scanner 0.5 s
         ("w2", 256, 14_000, 16, "lanes"))
PARITY = TIMED + (
    ("w2 identity", 256, 14_000, 16, "none"),
    ("w1", 64, 4_096, 1, "lanes"), ("w2'", 64, 4_096, 2, "none"),
    ("w4", 64, 4_096, 4, "rows"), ("w8", 64, 4_096, 8, "lanes"),
    ("w32", 64, 4_096, 32, "lanes"), ("w64", 64, 4_096, 64, "none"),
    ("T % 16", 33, 1_000, 8, "none"), ("w3", 7, 96, 3, "rows"),
    ("wrap", 5, 1_024, 512, "rows"), ("offset", 64, 4_096, 16, "offset"))


def bound_ms(m: int, t: int, w: int, c: int = None) -> float:
    """The least time of a call: (M, T) bytes read, (C, T/w) written."""
    c = m if c is None else c
    return (m * t + c * (t // w)) / HBM_BYTES_PER_S * 1e3


def route_of(t: int, w: int, aligned: bool = True) -> str:
    """The route csrc/window_pack.cu takes (its gate, for fresh tensors)."""
    vec = t % 16 == 0 and w <= 64 and w & (w - 1) == 0 and aligned
    return "vector" if vec else "bytes"


def operands(m: int, t: int, rows: str, seed: int, device="cuda"):
    """(bytes on the card, the host copy, the row map or None) for a
    shape of :data:`PARITY`."""
    from libsdr_tpu_torch.ops.pfb import lane_of_channel

    g = torch.Generator().manual_seed(seed)
    raw = torch.randint(0, 4, (m, t), generator=g, dtype=torch.uint8)
    raw[0] = 3              # a row of valid 1 bits: the largest sums
    r = {"lanes": torch.as_tensor(lane_of_channel(m)),
         "rows": torch.arange(m - 1, -1, -1)[: max(1, m - 2)]}.get(rows)
    if rows == "offset":
        x = torch.empty(m * t + 1, dtype=torch.uint8, device=device)[1:]
        x = x.view(m, t).copy_(raw)
    else:
        x = raw.to(device)
    return x, raw, r


def parity() -> list:
    """Every shape of :data:`PARITY` against the plain version; returns
    [(label, equal, route taken, route expected)]."""
    from libsdr_tpu_torch.ops.pll import window_pack, window_pack_plain

    out = []
    for i, (label, m, t, w, rows) in enumerate(PARITY):
        x, raw, r = operands(m, t, rows, 1000 + i)
        before = dict(window_pack.routes)
        got = window_pack(x, w, rows=None if r is None else r.cuda())
        torch.cuda.synchronize()
        taken = [k for k, n in window_pack.routes.items() if n > before[k]]
        equal = torch.equal(got.cpu(), window_pack_plain(raw, w, r))
        out.append((label, equal, "+".join(taken),
                    route_of(t, w, rows != "offset")))
    return out


def time_shape(label, m, t, w, rows, reps: int, smi: str) -> dict:
    """One shape of :data:`TIMED`: kernel, device and plain ms, bound."""
    from libsdr_tpu_torch.ops.pll import window_pack, window_pack_plain
    from libsdr_tpu_torch.tools.pfb_times import _ms, kernel_ms, n_sets

    sets = [operands(m, t, rows, 2000 + k)
            for k in range(n_sets(m * t))]
    r = None if sets[0][2] is None else sets[0][2].cuda()
    fns = [lambda x=x: window_pack(x, w, rows=r) for x, _, _ in sets]
    k = [0]

    def cycle():
        fns[k[0] % len(fns)]()
        k[0] += 1
    ms = _ms(cycle, reps)
    device_ms = kernel_ms(fns, reps)
    x0 = sets[0][0]
    plain_ms = _ms(lambda: window_pack_plain(x0, w, r), 3)
    b = bound_ms(m, t, w)
    res = dict(shape=[m, t, w], rows=rows, route=route_of(t, w), ms=ms,
               device_ms=device_ms, plain_ms=plain_ms, bound_ms=b,
               bound_share=b / device_ms, card=smi)
    print(f"window_pack {label} ({m} x {t:,}, w = {w}, rows {rows}, "
          f"route {res['route']}): {ms:.4f} ms a call, device "
          f"{device_ms:.4f} ms ({100 * b / device_ms:.1f}% of the bound "
          f"{b:.4f} ms), plain on the card {plain_ms:.3f} ms | {smi}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: the kernel has no CPU mode")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    checks = parity()
    bad = [c for c in checks if not c[1] or c[2] != c[3]]
    for label, equal, taken, want in checks:
        print(f"parity window_pack {label}: "
              f"{'bit-exact' if equal else 'DIFFERS'}, route {taken} "
              f"(expected {want})")
    res = {"parity": checks,
           "times": {label: time_shape(label, m, t, w, rows, args.reps, smi)
                     for label, m, t, w, rows in TIMED}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
