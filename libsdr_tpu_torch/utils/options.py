"""CLI options shared by the app CLIs (copied from
``libsdr_tpu.utils.options``, with the PyTorch device added).

``--device`` names where the blocks are processed.  It defaults to
``cuda``, which needs a card: without one the app stops with a message
rather than running on the CPU.  ``--device cpu`` runs every op's plain
PyTorch version.
"""

from __future__ import annotations

import argparse


def common_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--block-size", type=int, default=1 << 16,
                   help="samples per processing block")
    p.add_argument("--log-level", default="WARNING",
                   help="DEBUG/INFO/WARNING/ERROR")
    p.add_argument("--device", default="cuda",
                   help="torch device of the blocks: cuda (default, needs "
                        "a card), cuda:N or cpu")
    return p


def device_of(args):
    """The torch device of ``--device``; raises SystemExit for a CUDA
    device when the card is not there."""
    from libsdr_tpu_torch.core.graph import resolve_device
    from libsdr_tpu_torch.core.stream import RuntimeSDRError

    try:
        return resolve_device(args.device)
    except RuntimeSDRError:
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (use --device cpu for the plain "
                         "PyTorch versions)") from None


def add_source_args(p: argparse.ArgumentParser) -> None:
    """Input source flags: a WAV capture or a raw interleaved IQ file."""
    g = p.add_argument_group("source")
    g.add_argument("--file", help="input WAV file (stereo = I/Q)")
    g.add_argument("--raw", help="raw interleaved IQ capture file")
    g.add_argument("--raw-dtype", default="uint8",
                   help="raw sample dtype (uint8 = rtl_sdr wire format)")
    g.add_argument("--rate", type=float, default=None,
                   help="sample rate of --raw input")


def load_source(args):
    """Return (iq_or_audio, sample_rate) from parsed source args."""
    import numpy as np

    from libsdr_tpu_torch.io import read_wav, read_wav_iq
    from libsdr_tpu_torch.io.wav import read_raw_iq

    if args.file:
        try:
            return read_wav_iq(args.file)
        except Exception:
            return read_wav(args.file)
    if args.raw:
        if not args.rate:
            raise SystemExit("--raw requires --rate")
        return read_raw_iq(args.raw, np.dtype(args.raw_dtype)), args.rate
    raise SystemExit("need --file or --raw input")
