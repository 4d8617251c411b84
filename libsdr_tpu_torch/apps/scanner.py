"""Wideband pager scanner (counterpart of ``libsdr_tpu.apps.scanner``).

One wideband IQ capture -> polyphase channelizer (M uniform channels) ->
per-channel FM discriminator (the two in one launch of the K4 kernel on a
card) -> ASK + bit-sync PLL, all channels batched -> POCSAG decoding per
channel on the host: the whole band decodes at once.

Usage:
  python -m libsdr_tpu_torch.apps.scanner --file wide.wav --channels 64
  python -m libsdr_tpu_torch.apps.scanner --raw rtl.bin --rate 1.6e6 \
      --channels 64 --device cpu
  python -m libsdr_tpu_torch.apps.scanner --raw rtl.bin --rate 1.6e6 --bf16
  python -m libsdr_tpu_torch.apps.scanner --live tcp-listen://:1234 \
      --rate 24.576e6 --channels 1024 --live-timeout 2
"""

from __future__ import annotations

import numpy as np

from libsdr_tpu_torch.core.graph import Pipeline
from libsdr_tpu_torch.core.runtime import stream_blocks
from libsdr_tpu_torch.core.stream import StreamSpec
from libsdr_tpu_torch.decode import pocsag_decode_bits
from libsdr_tpu_torch.ops import ASKDetector, BitStream, FMDemod
from libsdr_tpu_torch.ops.channelizer import Channelizer
from libsdr_tpu_torch.utils import logging as sdrlog
from libsdr_tpu_torch.utils.options import (add_source_args, common_parser,
                                            device_of, load_source)


def scanner_pipeline(fs: float, block: int, n_channels: int,
                     baud: float = 1200.0) -> Pipeline:
    """Channelizer -> FM -> ASK -> BitStream over all M channels at once
    (the fusion pass makes the first two one WidebandFM op)."""
    p = Pipeline([
        Channelizer(n_channels, taps_per_branch=8),
        FMDemod(),
        ASKDetector(invert=True),   # POCSAG mark (1) = negative deviation
        BitStream(baud, mode="normal"),
    ], name="wideband_pocsag_scanner")
    p.bind(StreamSpec(np.complex64, fs, block))
    return p


def pick_block(fs: float, n_channels: int, block: int = None,
               quantum: int = 16) -> int:
    """~0.5 s of capture rounded down so that the per-channel step count is
    a multiple of ``quantum`` (16 suits the bit chain's windows; the
    multimode bank passes lcm(16, its PSK31 decimator))."""
    block = int(fs // 2) if block is None else int(block)
    block -= block % (n_channels * quantum)
    if block <= 0:
        raise SystemExit("block too small for the channel count")
    return block


def scan_blocks(blocks, fs: float, n_channels: int, block: int,
                baud: float = 1200.0, plane_dtype=None, device=None):
    """The scanner loop over an iterable of (block,)-sized IQ blocks (numpy
    complex, or planar Complex), on ``device`` (default: the card).
    Returns {channel_index: [POCSAGMessage, ...]}."""
    from libsdr_tpu_torch.core.ragged import min_valid_gap, pick_window
    from libsdr_tpu_torch.parallel.wideband import build_scanner_step

    m = n_channels
    t_full = block // m
    # Windowed on-device bit compaction: the PLL emits bits at least
    # min_valid_gap samples apart, so a window up to that gap is a lossless
    # T/w decimation of the bit stream (omega_max = baud/fs_ch * 1.005,
    # the BitStream's +0.5% clip).
    gap = min_valid_gap((baud / (fs / m)) * 1.005)
    w = pick_window(gap, t_full)
    step, init, place = build_scanner_step(m, block, fs, baud=baud,
                                           compact_window=w,
                                           plane_dtype=plane_dtype,
                                           packed=True, device=device)
    carry = init()
    # Packed bits (bit 0 = data, bit 1 = valid) halve the readback; a
    # 2-deep pending window keeps the device busy while the host drains.
    packs, pending = [], []
    for blk in blocks:
        carry, y = step(carry, place(blk))
        pending.append(y)
        if len(pending) > 2:
            packs.append(pending.pop(0).cpu().numpy())
    packs.extend(y.cpu().numpy() for y in pending)
    if not packs:            # an empty or short capture: nothing to decode
        return {}
    arr = np.concatenate(packs, axis=-1)
    data, valid = arr & 1, arr >= 2
    found = {}
    for ch in range(m):
        msgs = pocsag_decode_bits(data[ch][valid[ch]])
        if msgs:
            found[ch] = msgs
    return found


def scan(iq: np.ndarray, fs: float, n_channels: int, block: int = None,
         baud: float = 1200.0, device=None):
    """Decode every channel of a wideband capture on ``device`` (default:
    the card); returns {channel_index: [POCSAGMessage, ...]} for channels
    with traffic."""
    block = pick_block(fs, n_channels, block)
    return scan_blocks(stream_blocks(iq, block), fs, n_channels, block,
                       baud=baud, device=device)


def main(argv=None):
    ap = common_parser("Wideband POCSAG scanner (channelizer + decoder bank)")
    add_source_args(ap)
    ap.add_argument("--channels", type=int, default=64,
                    help="uniform channels across the capture bandwidth")
    ap.add_argument("--baud", type=float, default=1200.0)
    ap.add_argument("--bf16", action="store_true",
                    help="stream the u8 wire as bfloat16 planes into the "
                         "channelizer: lossless for 8-bit sources, half the "
                         "bytes (--raw uint8 or --live sources)")
    ap.add_argument("--live",
                    help="live u8 IQ wire instead of a file: tcp://host:port "
                         "(rtl_tcp pull), tcp-listen://:port (push), "
                         "udp://:port, fifo:///path; needs --rate")
    ap.add_argument("--live-timeout", type=float, default=None,
                    help="stop after this many seconds with no wire data")
    args = ap.parse_args(argv)
    sdrlog.set_level(args.log_level)
    dev = device_of(args)

    if args.live:
        if not args.rate:
            raise SystemExit("--live requires --rate")
        import torch

        from libsdr_tpu_torch.io.live import (LiveStats, stream_live_iq,
                                              stream_live_iq_bf16)
        fs = args.rate
        block = pick_block(fs, args.channels)
        stats = LiveStats()
        if args.bf16:   # the u8 wire as bf16 planes into the channelizer
            src = stream_live_iq_bf16(args.live, block, stats=stats,
                                      timeout=args.live_timeout)
            plane_dtype = torch.bfloat16
        else:
            src = stream_live_iq(args.live, block, stats=stats,
                                 timeout=args.live_timeout)
            plane_dtype = None
        found = scan_blocks(src, fs, args.channels, block, baud=args.baud,
                            plane_dtype=plane_dtype, device=dev)
        print(f"live: {stats.bytes_in} bytes in, "
              f"{stats.bytes_dropped} dropped "
              f"({100 * stats.drop_fraction:.2f}%), "
              f"{stats.sustained_msps():.2f} Msps sustained")
    elif args.bf16:
        if not args.raw or np.dtype(args.raw_dtype) != np.uint8:
            raise SystemExit("--bf16 needs a --raw uint8 (rtl_sdr wire) "
                             "source")
        if not args.rate:
            raise SystemExit("--raw requires --rate")
        import torch

        from libsdr_tpu_torch.io.ingest import stream_raw_iq_bf16
        fs = args.rate
        block = pick_block(fs, args.channels)
        found = scan_blocks(stream_raw_iq_bf16(args.raw, block), fs,
                            args.channels, block, baud=args.baud,
                            plane_dtype=torch.bfloat16, device=dev)
    else:
        iq, fs = load_source(args)
        if not np.iscomplexobj(iq):
            raise SystemExit("scanner expects an IQ capture")
        found = scan(iq, fs, args.channels, baud=args.baud, device=dev)
    m = args.channels
    for ch in sorted(found):
        f_center = ch * fs / m
        if ch > m // 2:
            f_center -= fs
        for msg in found[ch]:
            print(f"ch {ch:4d} ({f_center / 1e3:+9.1f} kHz): POCSAG "
                  f"@{msg.address} F={msg.function} '{msg.best_decode()}'")
    if not found:
        print("no POCSAG traffic found")
    return found


if __name__ == "__main__":
    main()
