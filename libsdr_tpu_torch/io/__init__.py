"""I/O: WAV files and raw captures (numpy on the host), file ingest through
the native pump (``io.ingest``) and live wires (``io.live``)."""

from libsdr_tpu_torch.io.live import (LiveStats, RTLTCPSource, stream_live_iq,
                                      stream_live_iq_bf16)
from libsdr_tpu_torch.io.wav import (WavWriter, read_raw_iq, read_wav,
                                     read_wav_iq, write_raw, write_wav,
                                     write_wav_iq)

__all__ = ["WavWriter", "read_raw_iq", "read_wav", "read_wav_iq",
           "write_raw", "write_wav", "write_wav_iq",
           "LiveStats", "RTLTCPSource", "stream_live_iq",
           "stream_live_iq_bf16"]
