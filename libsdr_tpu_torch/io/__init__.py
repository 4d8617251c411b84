"""I/O: WAV files and raw captures (numpy on the host)."""

from libsdr_tpu_torch.io.wav import (WavWriter, read_raw_iq, read_wav,
                                     read_wav_iq, write_raw, write_wav,
                                     write_wav_iq)

__all__ = ["WavWriter", "read_raw_iq", "read_wav", "read_wav_iq",
           "write_raw", "write_wav", "write_wav_iq"]
