"""W1's margin with bfloat16 planes: one channel's page decoded several
ways from one capture of the whole-band pager scanner's traffic.

    python -m libsdr_tpu_torch.tools.w1_margin --offset 275948
        [--channel 384] [--out w1_margin]

The capture is ``chip_smoke.py``'s W1 bf16 capture drawn at another point
of its generator: ``tools/wideband_signals.pager_band`` (1024 channels,
two 2^26-sample blocks at 24.576 MHz) from a generator seeded 1234 (the
smoke run's) at Philox offset ``--offset``: the f32 phase's band is drawn
first, then the bf16 phase's, as the smoke run draws them.  The smoke run
prints the offset at W1's start ("phase W1 traffic from the run's
generator at Philox offset N"); adding the offset its K1e sweep's D = 24
cases take when they draw from the run's generator ("the D = 24 cases drew
N") gives the traffic of a run where they did.

``--sweep`` draws the traffic of a run whose K1e sweep took its strides
in another order or from other generators (:func:`k1e_sweep_offset`).

For each device (the card, then the CPU's plain versions) and plane dtype
(the capture in float32 planes and rounded to bfloat16) it runs
``apps/scanner.scan_blocks`` and reports whether the channel's page
decodes there (and only there), the channel's audio from the fused
channelizer + FM stage (``parallel/wideband._wideband_body``), and the bit
errors of the channel's bit stream (ASKDetector and BitStream on that
audio, the scanner's chain) against the page's transmitted bits: the
margin.  The audio goes to ``<out>/ch<channel>_<device>_<planes>.npy``,
where another machine can run another package's decoder chain on it.  One
JSON line a (device, planes), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

M, BLOCK = 1024, 1 << 26
FS = M * 24_000.0


def page_bits(ch: int) -> np.ndarray:
    from libsdr_tpu_torch.decode import pocsag_encode_batch
    from libsdr_tpu_torch.tools.wideband_signals import (page_address,
                                                         page_text)
    return np.asarray(pocsag_encode_batch(address=page_address(ch),
                                          function=1, text=page_text(ch)),
                      np.uint8)


def bit_errors(rx: np.ndarray, tx: np.ndarray) -> dict:
    """The received bits' best alignment with the transmitted ones (or
    their inverse): bit errors over the page, and the most in one 32-bit
    codeword after the preamble (BCH(31,21) corrects 2)."""
    best = None
    n = len(tx)
    s_tx = 2.0 * tx - 1.0
    for inv in (False, True):
        r = (1 - rx) if inv else rx
        s_rx = 2.0 * r.astype(np.float64) - 1.0
        if len(s_rx) < n:
            continue
        corr = np.correlate(s_rx, s_tx, mode="valid")
        k = int(np.argmax(corr))
        errs = int(np.sum(r[k:k + n] != tx))
        if best is None or errs < best[0]:
            best = (errs, k, inv, r)
    if best is None:
        return dict(errors=None)
    errs, k, inv, r = best
    diff = (r[k:k + n] != tx).astype(int)
    body = diff[600:n - 64]   # the batches: no preamble, no trailing fill
    per_word = [int(body[i:i + 32].sum()) for i in range(0, len(body), 32)]
    return dict(errors=errs, aligned_at=k, inverted=inv,
                worst_codeword=max(per_word) if per_word else 0,
                codewords_over_2=sum(1 for e in per_word if e > 2))


def channel_audio(blocks, ch: int, dtype, device) -> np.ndarray:
    """Channel ``ch``'s audio through the scanner's fused channelizer + FM
    stage over the blocks."""
    from libsdr_tpu_torch.ops.pfb import lane_of_channel, pfb_twiddles
    from libsdr_tpu_torch.parallel import wideband as WB

    p = 8
    taps3 = torch.from_numpy(WB._taps(M, p)).to(device)
    tw = pfb_twiddles(M, device)
    init, place = WB._wideband_carry_and_place(M, p, device, dtype)
    carry = init()
    lane = int(lane_of_channel(M)[ch])
    out = []
    for x in blocks:
        carry, a = WB._wideband_body(carry, place(x), taps3, M, p,
                                     reorder=False, twiddles=tw)
        out.append(a[:, lane].float().cpu().numpy())
    return np.concatenate(out)


def channel_bits(audio: np.ndarray, device) -> np.ndarray:
    """The scanner's ASKDetector and BitStream on one channel's audio."""
    import libsdr_tpu_torch as L
    from libsdr_tpu_torch.ops import ASKDetector, BitStream

    t = BLOCK // M
    p = L.Pipeline([ASKDetector(invert=True),
                    BitStream(1200.0, mode="normal")], optimize=False)
    p.bind(L.StreamSpec(np.float32, FS / M, t))
    carry = p.init_carry(device)
    bits = []
    for i in range(len(audio) // t):
        x = torch.from_numpy(audio[i * t:(i + 1) * t]).to(device)
        carry, r = p.apply(carry, x)
        bits.append(r.data[r.valid].cpu().numpy())
    return np.concatenate(bits).astype(np.uint8)


def k1e_sweep_offset(order, from_gen) -> int:
    """The Philox offset that ``chip_smoke.py``'s K1e parity sweep takes
    from the run's generator when its strides come in ``order`` and those
    in ``from_gen`` draw from it (the others from generators of their
    own): the same draws (two complex (c, L-1) noise carries, then four
    blocks of two (c, b) planes a case; windows 2, 20, 40, 128; c = (1, 3, 64)[(i +
    j) % 3]; both plane dtypes), replayed without their kernels."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n_out = 3 * 4096 + 333
    for _ in range(2):
        for i, d in enumerate(order):
            if d not in from_gen:
                continue
            for j, ell in enumerate((2, 20, 40, 128)):
                c = (1, 3, 64)[(i + j) % 3]
                for _ in range(4):
                    torch.randn((c, ell - 1), generator=gen, device="cuda")
                for _ in range(8):
                    torch.randn((c, d * n_out), generator=gen,
                                device="cuda")
    return gen.get_offset()


def _strides(text: str):
    order, _, gen = text.partition("/")
    order = [int(v) for v in order.split(",")]
    return order, set(int(v) for v in gen.split(",")) if gen else set(order)


def main(argv=None) -> int:
    from libsdr_tpu_torch.apps.scanner import scan_blocks
    from libsdr_tpu_torch.tools import wideband_signals as W

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--offset", type=int, required=True)
    ap.add_argument("--channel", type=int, default=384)
    ap.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--out", default="w1_margin")
    ap.add_argument("--sweep", default=None,
                    help="ORDER/FROM_GEN strides of the K1e sweep whose W1 "
                         "traffic to draw, e.g. 2,4,5,10,24,40,100/2,4,5,"
                         "10,24,40,100; --offset is then the W1 offset of a "
                         "run with --base-sweep's")
    ap.add_argument("--base-sweep", default="2,4,5,10,40,100,24/2,4,5,10,"
                    "40,100")
    ap.add_argument("--scan-only", action="store_true",
                    help="only the card's bf16 scan: the pages lost")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("w1_margin draws its capture on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    offset = args.offset
    if args.sweep:
        offset += (k1e_sweep_offset(*_strides(args.sweep))
                   - k1e_sweep_offset(*_strides(args.base_sweep)))
        # the replay's check: chip_smoke.py prints what D = 24 drew
        print(json.dumps(dict(d24_drew=k1e_sweep_offset(
            *_strides("2,4,5,10,40,100,24/24")))), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    gen.set_offset(offset)
    W.pager_band(M, 2, BLOCK, "cuda", gen=gen)          # the f32 phase's
    blocks, pages = W.pager_band(M, 2, BLOCK, "cuda", gen=gen)
    ch = args.channel
    addr, text = pages[ch]
    tx = page_bits(ch)
    if args.scan_only:
        found = scan_blocks([x.to(torch.bfloat16) for x in blocks], FS, M,
                            BLOCK, plane_dtype=torch.bfloat16, device="cuda")
        lost = sorted(c for c, (a, tt) in pages.items()
                      if not any(m.address == a and m.as_text().startswith(tt)
                                 for m in found.get(c, [])))
        print(json.dumps(dict(sweep=args.sweep, offset=offset,
                              bf16_pages_lost=lost)), flush=True)
        return 0
    for dev in args.devices:
        for planes, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            xs = [x.to(dtype) if dtype is not None else x for x in blocks]
            xs = [x.to(dev) for x in xs]
            t0 = time.perf_counter()
            found = scan_blocks(xs, FS, M, BLOCK, plane_dtype=dtype,
                                device=dev)
            scan_s = time.perf_counter() - t0
            where = sorted(c for c, msgs in found.items()
                           if any(m.address == addr for m in msgs))
            ok = any(m.address == addr and m.as_text().startswith(text)
                     for m in found.get(ch, []))
            lost = sorted(c for c, (a, tt) in pages.items()
                          if not any(m.address == a
                                     and m.as_text().startswith(tt)
                                     for m in found.get(c, [])))
            audio = channel_audio(xs, ch, dtype, dev)
            np.save(out / f"ch{ch}_{dev}_{planes}.npy", audio)
            bits = channel_bits(audio, dev)
            line = dict(device=dev, planes=planes, channel=ch,
                        page_decoded=ok, address_found_on=where,
                        pages_lost=lost, offset=offset,
                        scan_s=round(scan_s, 1),
                        n_bits=int(len(bits)), **bit_errors(bits, tx),
                        card=smi)
            print(json.dumps(line), flush=True)
            del xs, found
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
