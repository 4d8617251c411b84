"""Multi-mode receiver CLI: WFM/NFM/AM/USB/LSB with live mode switching
(counterpart of ``libsdr_tpu.apps.rx``)."""

from __future__ import annotations

import numpy as np

from libsdr_tpu_torch.apps.chains import rx_chain, rx_stages
from libsdr_tpu_torch.core import cplx, run_pipeline, stream_blocks
from libsdr_tpu_torch.io import write_wav
from libsdr_tpu_torch.utils import logging as sdrlog
from libsdr_tpu_torch.utils.options import (add_source_args, common_parser,
                                            device_of, load_source)


def main(argv=None):
    p = common_parser("Multi-mode receiver")
    add_source_args(p)
    p.add_argument("-m", "--mode", default="WFM",
                   help="WFM | NFM | AM | USB | LSB")
    p.add_argument("-F", "--frequency", type=float, default=0.0,
                   help="channel offset from capture center [Hz]")
    p.add_argument("-o", "--output", required=True, help="output WAV")
    p.add_argument("--switch", action="append", default=[],
                   metavar="SECONDS:MODE",
                   help="switch demodulator live at stream time SECONDS "
                        "(repeatable; the front-end filter state is "
                        "preserved across the switch — the new mode's "
                        "audio rate must match the current one; switches "
                        "apply at the next block boundary, i.e. quantized "
                        "up to block-size/rate seconds)")
    args = p.parse_args(argv)
    sdrlog.set_level(args.log_level)
    dev = device_of(args)

    switches = []
    for s in args.switch:
        secs, sep, mode = s.partition(":")
        try:
            t_at = float(secs)
        except ValueError:
            sep = ""
        if not sep or not mode:
            raise SystemExit(f"--switch {s!r}: expected SECONDS:MODE")
        switches.append((t_at, mode))
    switches.sort()

    iq, fs = load_source(args)
    rx = rx_chain(args.mode, fs, args.block_size, fc=args.frequency)
    print(rx.describe())
    if not switches:
        _, audio = run_pipeline(rx, stream_blocks(iq, args.block_size),
                                device=dev)
    else:
        out_rate = rx.out_spec.rate_hz
        carry = rx.init_carry(dev)
        step = rx.compile()
        pieces = []
        t = 0.0
        for i, blk in enumerate(stream_blocks(iq, args.block_size)):
            while switches and t >= switches[0][0]:
                _, mode = switches.pop(0)
                carry = rx.switch_stages(
                    rx_stages(mode, fs, args.frequency), carry)
                if rx.out_spec.rate_hz != out_rate:
                    raise SystemExit(
                        f"--switch {mode}: audio rate "
                        f"{rx.out_spec.rate_hz:g} != {out_rate:g}")
                step = rx.compile()
                print(f"[{t:.2f}s] switched to {mode}")
                print(rx.describe())
            carry, y = step(carry, cplx.as_block(blk, rx.in_spec.real_dtype,
                                                 dev))
            pieces.append(cplx.to_numpy(y))
            # advance by the real (unpadded) sample count: the final block
            # is zero-padded, and nominal accounting would skew or skip a
            # switch requested near the end of the stream.
            t += min(args.block_size,
                     len(iq) - i * args.block_size) / fs
        audio = np.concatenate(pieces)
    write_wav(args.output, np.clip(audio, -1, 1), int(rx.out_spec.rate_hz))
    print(f"wrote {len(audio)} samples @ {rx.out_spec.rate_hz:g} Hz")


if __name__ == "__main__":
    main()
