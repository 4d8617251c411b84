"""Protocol decoders: numpy-only copies of ``libsdr_tpu.decode`` (reference
layer L6, SURVEY.md section 2.5).

Bit-level framing/decoding state machines run on the host: downstream of the
bit-sync PLL the data rate is ~1e3 bits/s/channel (SURVEY.md section 7 step
4), so FSMs in numpy/python cost nothing while the card handles the Msps
front-end.  Each decoder consumes a dense bit vector (use
:func:`libsdr_tpu_torch.core.ragged.compact` on the PLL output).
"""

from libsdr_tpu_torch.decode.bch import (bch_encode, bch_repair,
                                         bch_syndrome)
from libsdr_tpu_torch.decode.pocsag import (POCSAGDecoder, POCSAGMessage,
                                            pocsag_decode_bits,
                                            pocsag_encode_batch)
from libsdr_tpu_torch.decode.ax25 import (AX25Decoder, AX25Message,
                                          ax25_decode_bits, ax25_frame_bits)
from libsdr_tpu_torch.decode.aprs import APRSMessage, parse_aprs
from libsdr_tpu_torch.decode.baudot import (BaudotDecoder,
                                            baudot_encode_bits)
from libsdr_tpu_torch.decode.varicode import (VaricodeDecoder,
                                              varicode_encode_bits)

__all__ = [
    "bch_encode", "bch_repair", "bch_syndrome",
    "POCSAGDecoder", "POCSAGMessage", "pocsag_decode_bits",
    "pocsag_encode_batch",
    "AX25Decoder", "AX25Message", "ax25_decode_bits", "ax25_frame_bits",
    "APRSMessage", "parse_aprs",
    "BaudotDecoder", "baudot_encode_bits",
    "VaricodeDecoder", "varicode_encode_bits",
]
