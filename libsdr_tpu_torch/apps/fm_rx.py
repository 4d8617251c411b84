"""FM broadcast receiver CLI (counterpart of ``libsdr_tpu.apps.fm_rx``).

IQ capture -> IQBaseBand(decimate) -> FM demod -> de-emphasis -> WAV audio.
"""

from __future__ import annotations

import numpy as np

from libsdr_tpu_torch.apps.chains import fm_chain
from libsdr_tpu_torch.core import run_pipeline, stream_blocks
from libsdr_tpu_torch.io import write_wav
from libsdr_tpu_torch.utils import logging as sdrlog
from libsdr_tpu_torch.utils.options import (add_source_args, common_parser,
                                            device_of, load_source)


def main(argv=None):
    p = common_parser("FM broadcast receiver")
    add_source_args(p)
    p.add_argument("-F", "--frequency", type=float, default=0.0,
                   help="channel offset from capture center [Hz]")
    p.add_argument("--width", type=float, default=200e3)
    p.add_argument("--audio-rate", type=float, default=48e3)
    p.add_argument("--deviation", type=float, default=75e3)
    p.add_argument("--no-deemph", action="store_true")
    p.add_argument("-o", "--output", required=True, help="output WAV")
    args = p.parse_args(argv)
    sdrlog.set_level(args.log_level)
    dev = device_of(args)

    iq, fs = load_source(args)
    block = args.block_size
    rx = fm_chain(fs, block, fc=args.frequency, width=args.width,
                  audio_rate=args.audio_rate, deviation=args.deviation,
                  deemph=not args.no_deemph)
    print(rx.describe())
    _, audio = run_pipeline(rx, stream_blocks(iq, block), device=dev)
    write_wav(args.output, np.clip(audio, -1, 1), int(rx.out_spec.rate_hz))
    print(f"wrote {len(audio)} samples @ {rx.out_spec.rate_hz:g} Hz "
          f"to {args.output}")


if __name__ == "__main__":
    main()
