"""PSK31 receiver CLI (counterpart of ``libsdr_tpu.apps.psk31_rx``): IQ
(or audio-band complex baseband) -> band selection and decimation to ~2 kHz
-> BPSK31 -> Varicode -> text.
"""

from __future__ import annotations

import numpy as np

from libsdr_tpu_torch.apps.chains import run_bit_chain
from libsdr_tpu_torch.core.graph import Pipeline
from libsdr_tpu_torch.core.stream import StreamSpec
from libsdr_tpu_torch.decode import VaricodeDecoder
from libsdr_tpu_torch.ops import BPSK31, IQBaseBand
from libsdr_tpu_torch.utils import logging as sdrlog
from libsdr_tpu_torch.utils.options import (add_source_args, common_parser,
                                            device_of, load_source)


def main(argv=None):
    p = common_parser("PSK31 receiver")
    add_source_args(p)
    p.add_argument("-F", "--frequency", type=float, default=0.0,
                   help="PSK31 carrier offset from capture center [Hz]")
    args = p.parse_args(argv)
    sdrlog.set_level(args.log_level)
    dev = device_of(args)

    iq, fs = load_source(args)
    if not np.iscomplexobj(iq):
        raise SystemExit("psk31_rx expects complex IQ input")
    stages = []
    if fs > 4000:
        # Select a narrow band around the carrier and decimate near 2 kHz
        # (BPSK31 needs at least 2 kHz).
        stages.append(IQBaseBand(fc=args.frequency, width=200.0, order=64,
                                 out_rate=2000.0, design="textbook"))
    stages.append(BPSK31())
    fe = Pipeline(stages, name="psk31_rx")
    fe.bind(StreamSpec(np.complex64, fs, args.block_size))
    print(fe.describe())
    bits = run_bit_chain(fe, iq, dev)
    text = VaricodeDecoder().process(bits)
    print(text)
    return text


if __name__ == "__main__":
    main()
