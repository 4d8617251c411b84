"""BPSK31's kernel (``csrc/psk31.cu``, entry ``ops/psk31.bpsk31_scan``)
on the card at its paths' shapes: time, bound and chain floor.

    PYTHONPATH=<tree root> python libsdr_tpu_torch/tools/psk31_times.py \\
        [--reps 20] [--out psk31_times.json]

The calls, each on its path's own inputs made on the card from a seed:

* W2: the PSK31 group of the 256-channel multimode bank (12,288 frames a
  block at 6.144 MHz, the pattern pocsag,ax25,rtty,psk31, traffic on every
  fifth channel of ``tools/wideband_signals.mixed_band``): 64 channels x
  1,024 samples a block, the Channelizer's (K4) rows through the group's
  IQBaseBand (K1b), :func:`w2_inputs`;
* psk31_rx: one channel of 2,000 samples, the app's chain on a 20 kHz
  capture in blocks of 20,000 (:func:`rx_inputs`).

Each kernel call is timed on the carry after the path's first block:
``ms`` with CUDA events over ``--reps`` calls (the wrapper's host time
included where it is longer than the kernel's), ``device_ms`` the same
calls replayed in a CUDA graph (``tools/pfb_times.kernel_ms``: the kernel
and the ring index's two small ops, no host time), beside the plain
version's time (host clock, one call), the bound of its bytes
(:func:`bound_ms`) and the floor of its chain as counted from the source
(:func:`chain_floor_ms`, an estimate, not a measurement); the card's name
and power limit on every line.

The script imports ``libsdr_tpu_torch`` from the path, so one call can time
two trees in turns by running it with ``PYTHONPATH`` set to each tree's
root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

M, FRAMES = 256, 12_288
FS = M * 24_000.0
PATTERN = ("pocsag", "ax25", "rtty", "psk31")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
CLOCK_HZ = 1.98e9          # H100 SXM boost clock
# The step's dependent chain from P to the next P, counted from the source
# (csrc/psk31.cu, produce taken): ~36 float32 operations (P + F and its
# wrap, the phasor's products, the newest sample's ~4.5 adds of the 8-tap
# sum on average, |y|^2, the IEEE division, F', P' and its wrap, the
# selects) at ~4 cycles, ~17 float64 operations of sincos (range reduction
# and the polynomials) at ~8 cycles, and two float conversions at ~10.
CHAIN_CYCLES = 36 * 4 + 17 * 8 + 2 * 10


def chain_floor_ms(t: int) -> float:
    """ms that BPSK31's loop-carried chain takes over t steps however many
    channels run, as counted from the source (CHAIN_CYCLES a step at the
    boost clock): an estimate at assumed latencies, not a measurement."""
    return t * CHAIN_CYCLES / CLOCK_HZ * 1e3


def bound_ms(c: int, t: int) -> tuple:
    """(ms, "bytes"): the least time for a C x T call, its bytes at the HBM
    rate: the float32 planes read once (8 B a sample), the bits and valid
    flags written once (2 B), the carry (33 float32 values a channel: 17
    leaves and the ring's 16) read and written.  Its operations (~80
    float32 and ~40 float64 a step) take less at the card's rates."""
    nbytes = c * t * 10 + c * 33 * 4 * 2
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def w2_group(seed: int = 1515, device="cuda"):
    """W2's PSK31 group before its pipeline: (rows, active, pipe): the
    Channelizer's (K4) rows of the group, (64, 12,288) Complex planes a
    block; which of the 64 channels carry a message; the group's bound
    pipeline (IQBaseBand, BPSK31; ``apps/multimode.mode_parts``)."""
    from libsdr_tpu_torch.apps import multimode
    from libsdr_tpu_torch.tools.wideband_signals import mixed_band

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    b = M * FRAMES
    mode_map = {ch: PATTERN[ch % 4] for ch in range(M)}
    active = {ch: mode_map[ch] for ch in range(0, M - 5, 5)}
    x = mixed_band(active, M, device, gen=gen, sigma=0.02)
    n = -(-x.shape[-1] // b)
    x = x.map(lambda a: torch.nn.functional.pad(a, (0, n * b - a.shape[-1])))
    chan, sub, groups, _ = multimode._build_parts(FS, b, M, mode_map)
    idx = torch.as_tensor(groups["psk31"], device=device)
    cc, rows = chan.init_carry(device), []
    for i in range(n):
        cc, y = chan.apply(cc, x[i * b:(i + 1) * b])
        rows.append(y.map(lambda a: a[idx]))
    return rows, np.isin(groups["psk31"], list(active)), sub["psk31"]


def w2_inputs(seed: int = 1515, device="cuda"):
    """W2's PSK31 group inputs: (blocks, active, rate): the (64, 1,024)
    Complex planes of each block (:func:`w2_group` through the group's
    IQBaseBand, K1b), which of the 64 channels carry a message, and their
    sample rate (Hz)."""
    rows, active, pipe = w2_group(seed, device)
    base = pipe.stages[0]
    c, blocks = base.init_carry(device), []
    for r in rows:
        c, z = base.apply(c, r)
        blocks.append(z)
    return blocks, active, base.out_spec.rate_hz


def rx_inputs(device="cuda", text="cq de tpu"):
    """psk31_rx's BPSK31 inputs: (blocks, rate): the app's IQBaseBand over
    a 20 kHz capture of ``text`` in blocks of 20,000, (1, 2,000) Complex
    planes a block, and their sample rate (Hz)."""
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.core.graph import Pipeline
    from libsdr_tpu_torch.core.stream import StreamSpec
    from libsdr_tpu_torch.decode import varicode_encode_bits
    from libsdr_tpu_torch.ops import IQBaseBand

    bits = np.concatenate([np.ones(16, np.uint8), varicode_encode_bits(text),
                           np.ones(16, np.uint8)])
    sig = 0.8 * np.exp(1j * np.repeat(np.cumsum(np.where(
        bits == 0, np.pi, 0.0)), 640)).astype(np.complex64)
    sig = np.concatenate([sig, np.zeros((-len(sig)) % 20_000, np.complex64)])
    p = Pipeline([IQBaseBand(fc=0.0, width=200.0, order=64, out_rate=2000.0,
                             design="textbook")])
    p.bind(StreamSpec(np.complex64, 20_000, 20_000, channels=(1,)))
    c = p.init_carry(device)
    blocks = []
    for i in range(len(sig) // 20_000):
        c, z = p.apply(c, cplx.as_block(sig[None, i * 20_000:(i + 1)
                                            * 20_000], torch.float32, device))
        blocks.append(z)
    return blocks, p.out_spec.rate_hz


def bound_op(rate: float, channels: int, t: int):
    """A BPSK31 bound to ``rate`` over ``channels`` channels of t."""
    from libsdr_tpu_torch.core.stream import StreamSpec
    from libsdr_tpu_torch.ops import BPSK31

    op = BPSK31()
    op.bind(StreamSpec(np.complex64, rate, t, channels=(channels,)))
    return op


def time_call(blocks, rate: float, reps: int, smi: str) -> dict:
    """The kernel on the second block (the carry after the first) against
    the plain version: ms, device ms, plain ms, bound, chain floor, and
    whether the two agree bit for bit (bits, valid flags and every carried
    value)."""
    from libsdr_tpu_torch.core.graph import _leaves
    from libsdr_tpu_torch.ops.psk31 import bpsk31_scan, bpsk31_scan_plain
    from libsdr_tpu_torch.tools.pfb_times import kernel_ms

    c, t = blocks[0].re.shape
    op = bound_op(rate, c, t)
    k = op.constants()
    carry, _, _ = bpsk31_scan(blocks[0], op.init_carry("cuda"), **k)
    x = blocks[1]
    got = bpsk31_scan(x, carry, **k)
    host = {key: v.to("cpu") for key, v in carry.items()}
    t0 = time.perf_counter()
    ref = bpsk31_scan_plain(x.to("cpu"), host, **k)
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(a.cpu(), b) for a, b in zip(
        _leaves(got)[0], _leaves(ref)[0]))
    bpsk31_scan(x, carry, **k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        bpsk31_scan(x, carry, **k)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    device = kernel_ms([lambda: bpsk31_scan(x, carry, **k)], reps)
    b_ms, b_by = bound_ms(c, t)
    return dict(shape=[c, t], ms=ms, device_ms=device, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                chain_floor_ms=chain_floor_ms(t),
                ns_a_step=device * 1e6 / t, bit_exact=same, device=smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    w2, _, rate = w2_inputs()
    res = {"W2": time_call(w2, rate, args.reps, smi),
           "psk31_rx": time_call(*rx_inputs(), args.reps, smi)}
    for name, r in res.items():
        print(json.dumps({name: r}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
