"""AX.25 / APRS receiver CLI (counterpart of ``libsdr_tpu.apps.ax25_rx``).

The input is demodulated audio (AFSK1200 tones, ``--audio``) or an IQ
capture, which an NFM front end demodulates first; the FSK detector and the
bit-sync PLL run on ``--device`` (the card by default), the HDLC deframing
and the APRS parsing on the host.
"""

from __future__ import annotations

import numpy as np

from libsdr_tpu_torch.apps.chains import (afsk_front_end, fm_chain,
                                          run_bit_chain)
from libsdr_tpu_torch.core import run_pipeline, stream_blocks
from libsdr_tpu_torch.decode.aprs import APRSDecoder
from libsdr_tpu_torch.utils import logging as sdrlog
from libsdr_tpu_torch.utils.options import (add_source_args, common_parser,
                                            device_of, load_source)


def main(argv=None):
    p = common_parser("APRS/AX.25 receiver")
    add_source_args(p)
    p.add_argument("-F", "--frequency", type=float, default=0.0)
    p.add_argument("--audio", action="store_true",
                   help="input is demodulated AFSK audio, not IQ")
    args = p.parse_args(argv)
    sdrlog.set_level(args.log_level)
    dev = device_of(args)

    samples, fs = load_source(args)
    if not args.audio and np.iscomplexobj(samples):
        fm = fm_chain(fs, args.block_size, fc=args.frequency, width=12.5e3,
                      order=32, audio_rate=24e3, deviation=4.5e3,
                      deemph=False)
        _, samples = run_pipeline(fm, stream_blocks(samples, args.block_size),
                                  device=dev)
        fs = fm.out_spec.rate_hz
    fe = afsk_front_end(fs, min(args.block_size, len(samples)))
    bits = run_bit_chain(fe, samples.astype(np.float32), dev)
    dec = APRSDecoder()
    dec.process(bits)
    for m in dec.messages:
        print(f"AX25: {m}")
    for a in dec.aprs_messages:
        print(a)
    if not dec.messages:
        print("no AX.25 frames decoded")
    return dec


if __name__ == "__main__":
    main()
