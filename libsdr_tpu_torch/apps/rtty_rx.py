"""RTTY (Baudot) receiver CLI (counterpart of ``libsdr_tpu.apps.rtty_rx``).

Audio (FSK tones) -> FSKDetector at twice the baud (half-bits) -> bit-sync
PLL (on ``--device``, the card by default) -> Baudot/ITA2 decode (host) ->
text.
"""

from __future__ import annotations

import numpy as np

from libsdr_tpu_torch.apps.chains import rtty_front_end, run_bit_chain
from libsdr_tpu_torch.decode import BaudotDecoder
from libsdr_tpu_torch.utils import logging as sdrlog
from libsdr_tpu_torch.utils.options import (add_source_args, common_parser,
                                            device_of, load_source)


def main(argv=None):
    p = common_parser("RTTY receiver")
    add_source_args(p)
    p.add_argument("--baud", type=float, default=45.45)
    p.add_argument("--mark", type=float, default=930.0)
    p.add_argument("--space", type=float, default=1100.0)
    p.add_argument("--stop-bits", default="1.5", choices=["1", "1.5", "2"])
    args = p.parse_args(argv)
    sdrlog.set_level(args.log_level)
    dev = device_of(args)

    audio, fs = load_source(args)
    if np.iscomplexobj(audio):
        raise SystemExit("rtty_rx expects demodulated audio input")
    fe = rtty_front_end(fs, args.block_size, baud=args.baud,
                        f_mark=args.mark, f_space=args.space)
    half_bits = run_bit_chain(fe, audio.astype(np.float32), dev)
    text = BaudotDecoder(stop_bits=args.stop_bits).process(half_bits)
    print(text)
    return text


if __name__ == "__main__":
    main()
