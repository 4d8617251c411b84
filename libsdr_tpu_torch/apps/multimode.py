"""Multi-mode digital decoder bank sharing one wideband front end
(counterpart of ``libsdr_tpu.apps.multimode``).

One polyphase channelizer pass over the wideband capture (the K4 kernel on
a card, channel variant) produces all M complex channel streams at once; a
per-channel mode map routes channel groups into batched per-mode chains,
each one pipeline with a leading channel axis:

  pocsag  FMDemod -> ASK -> BitStream(NORMAL) -> POCSAG
  ax25    FMDemod -> FSKDetector(1200/2200) -> BitStream(TRANSITION)
          -> HDLC/APRS
  rtty    USBDemod -> FSKDetector(930/1100 @ 2x45.45) -> BitStream(NORMAL)
          -> Baudot
  psk31   IQBaseBand(200 Hz select, ~2 kHz) -> BPSK31 -> Varicode

The final BitStreams of the groups run as one banked PLL launch (K3,
``ops/bitsync.apply_mode_chains``); the PSK31 group's IQBaseBand runs the
FIR kernel (K1b).  Only the bit streams reach the host decoders.

Usage:
  python -m libsdr_tpu_torch.apps.multimode --file wide.wav --channels 16 \
      --map "2:pocsag,5:ax25,9:rtty,12:psk31"
  python -m libsdr_tpu_torch.apps.multimode --live tcp-listen://:1234 \
      --rate 384e3 --channels 16 --map "2:pocsag,9:rtty" --live-timeout 2
  python -m libsdr_tpu_torch.apps.multimode --raw wire.u8 --rate 6144000 \
      --channels 256 --bf16 --pattern pocsag,ax25,rtty,psk31
  torchrun --nproc-per-node=4 -m libsdr_tpu_torch.apps.multimode \
      --file wide.wav --channels 256 --pattern pocsag,ax25,rtty,psk31
  torchrun --nproc-per-node=4 -m libsdr_tpu_torch.apps.multimode \
      --live tcp-listen://:1234 --rate 6144000 --channels 256 --bf16 \
      --pattern pocsag,ax25,rtty,psk31 --live-timeout 2

``--pattern`` gives every channel a mode by a repeating pattern and runs
the sharded bank (``parallel/multimode.py``): on one device, or under
``torchrun`` over every rank of the group (one card a rank; rank 0
prints).  ``--bf16`` streams the u8 wire as bfloat16 planes into K4.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.graph import Pipeline, resolve_device
from libsdr_tpu_torch.core.ragged import (Ragged, compact, min_valid_gap,
                                          pick_window)
from libsdr_tpu_torch.core.runtime import stream_blocks
from libsdr_tpu_torch.core.stream import StreamSpec
from libsdr_tpu_torch.decode import (AX25Decoder, BaudotDecoder,
                                     VaricodeDecoder, parse_aprs,
                                     pocsag_decode_bits)
from libsdr_tpu_torch.ops import (ASKDetector, BitStream, FMDemod,
                                  FSKDetector, IQBaseBand, USBDemod)
from libsdr_tpu_torch.ops.bitsync import apply_mode_chains
from libsdr_tpu_torch.ops.channelizer import Channelizer
from libsdr_tpu_torch.ops.psk31 import BPSK31
from libsdr_tpu_torch.utils import logging as sdrlog
from libsdr_tpu_torch.utils.options import (add_source_args, common_parser,
                                            device_of, load_source)
from libsdr_tpu_torch.utils.profiling import span

MODES = ("pocsag", "ax25", "rtty", "psk31")


def _mode_stages(mode: str):
    if mode == "pocsag":
        return [FMDemod(), ASKDetector(invert=True),
                BitStream(1200.0, mode="normal")]
    if mode == "ax25":
        return [FMDemod(), FSKDetector(1200.0, 1200.0, 2200.0),
                BitStream(1200.0, mode="transition")]
    if mode == "rtty":
        return [USBDemod(), FSKDetector(2 * 45.45, 930.0, 1100.0),
                BitStream(2 * 45.45, mode="normal")]
    if mode == "psk31":
        # select the 200 Hz PSK31 slot and decimate near 2 kHz
        return [IQBaseBand(fc=0.0, width=200.0, order=64,
                           out_rate=2000.0, design="textbook"),
                BPSK31()]
    raise SystemExit(f"unknown mode {mode!r} (use {'/'.join(MODES)})")


def _build_parts(fs: float, block: int, n_channels: int,
                 mode_map: Dict[int, str]):
    """The bank's pieces: (chan, sub, groups, windows)."""
    m = n_channels
    if block % m:
        raise SystemExit("block must divide by the channel count")
    for ch in mode_map:
        if not 0 <= ch < m:
            raise SystemExit(f"channel {ch} outside 0..{m - 1}")
    chan = Channelizer(m, taps_per_branch=8)
    chan.bind(StreamSpec(np.complex64, fs, block))
    return (chan,) + mode_parts(fs / m, block // m, mode_map)


def mode_parts(ch_rate: float, t_full: int, mode_map: Dict[int, str]):
    """The mode chains of a bank: (sub, groups, windows).  ``groups[mode]``
    lists the mode's channels (indices into the bank's rows) in ascending
    order, the modes in the order of their first channel;
    ``sub[mode]`` is the group's bound pipeline and ``windows[mode]`` its
    bit compaction window."""
    groups: Dict[str, list] = {}
    for ch, mode in sorted(mode_map.items()):
        groups.setdefault(mode, []).append(ch)
    groups = {mode: np.asarray(idxs, np.int32)
              for mode, idxs in groups.items()}

    sub, windows = {}, {}
    for mode, idxs in groups.items():
        p = Pipeline(_mode_stages(mode), name=f"bank_{mode}")
        p.bind(StreamSpec(np.complex64, ch_rate, t_full,
                          channels=(len(idxs),)))
        sub[mode] = p
        # Lossless windowed bit compaction: the PLL's guaranteed bit gap
        # bounds a window that decimates the ragged stream on the device.
        # BPSK31's emission is symbol-clocked, not this PLL: unwindowed.
        bs = p.stages[-1]
        windows[mode] = (pick_window(min_valid_gap(bs), t_full, cap=256)
                         if isinstance(bs, BitStream) else 0)
    return sub, groups, windows


def pack_bank_outputs(outs) -> torch.Tensor:
    """Every mode's Ragged planes as ONE flat uint8 tensor, so a consumer
    pays one device->host copy per block.  Order: sorted(mode) x (data,
    valid); invert with :func:`unpack_bank_outputs` and
    :func:`bank_output_layout`.  In the span ``multimode.pack`` (on a card
    with the card's time)."""
    with span("multimode.pack", next(iter(outs.values())).data.is_cuda):
        parts = []
        for mo in sorted(outs):
            r = outs[mo]
            parts.append(r.data.to(torch.uint8).reshape(-1))
            parts.append(r.valid.to(torch.uint8).reshape(-1))
        return torch.cat(parts)


def bank_output_layout(outs):
    """The (mode, shape) layout of :func:`pack_bank_outputs`."""
    return [(mo, tuple(int(s) for s in outs[mo].data.shape))
            for mo in sorted(outs)]


def unpack_bank_outputs(flat: np.ndarray, layout):
    """Host-side inverse of :func:`pack_bank_outputs`: {mode: (data uint8,
    valid bool)} numpy views."""
    out = {}
    off = 0
    for mo, shape in layout:
        n = int(np.prod(shape))
        data = flat[off:off + n].reshape(shape)
        off += n
        valid = flat[off:off + n].reshape(shape).astype(bool)
        off += n
        out[mo] = (data, valid)
    return out


def build_bank(fs: float, block: int, n_channels: int,
               mode_map: Dict[int, str]):
    """Build the shared-front-end bank.

    Returns (step, init_carry, groups): ``step(carry, x)`` consumes one
    (block,) complex wideband block and returns ``{mode: Ragged bits}``
    with rows ordered like ``groups[mode]`` (that mode's channel indices);
    ``init_carry(device)`` makes the carry on ``device`` (default: the
    card).  One Channelizer feeds every group; each group is one batched
    pipeline."""
    chan, sub, groups, windows = _build_parts(fs, block, n_channels,
                                              mode_map)

    def step(carry, x):
        cc, carries = carry
        cc, y = chan.apply(cc, x)                      # (M, T) complex bank
        outs, new = apply_mode_chains(sub, carries, y, groups, windows)
        return (cc, new), outs

    def init_carry(device=None):
        device = resolve_device(device)
        return (chan.init_carry(device),
                {mode: p.init_carry(device) for mode, p in sub.items()})

    return step, init_carry, groups


def decode_mode_bits(mode: str, bits: np.ndarray):
    """Host decode of one channel's compacted bit stream, per mode: POCSAG
    message list / AX.25 (+APRS) list / RTTY text / PSK31 text."""
    if mode == "pocsag":
        return pocsag_decode_bits(bits)
    if mode == "ax25":
        dec = AX25Decoder()
        dec.process(bits)
        return [(f, parse_aprs(f)) for f in dec.messages]
    if mode == "rtty":
        return BaudotDecoder(stop_bits="1.5").process(bits)
    if mode == "psk31":
        return VaricodeDecoder().process(bits)
    raise SystemExit(f"unknown mode {mode!r} (use {'/'.join(MODES)})")


def _run_bank(blocks, step, carry, place, groups
              ) -> Dict[int, Tuple[str, object]]:
    """Stream ``blocks`` through a bank ``step``, draining each block's bits
    as one packed uint8 copy (:func:`pack_bank_outputs`) collected 3 blocks
    later, so the device's work and the host's drain overlap; then compact
    and decode each channel's bit row."""
    acc = {mode: [] for mode in groups}
    pending = []
    layout = None

    def drain(flat):
        for mode, dv in unpack_bank_outputs(flat.cpu().numpy(),
                                            layout).items():
            acc[mode].append(dv)

    for blk in blocks:
        carry, outs = step(carry, place(blk))
        if layout is None:
            layout = bank_output_layout(outs)
        pending.append(pack_bank_outputs(outs))
        if len(pending) > 3:
            drain(pending.pop(0))
    for flat in pending:
        drain(flat)

    found: Dict[int, Tuple[str, object]] = {}
    for mode, idxs in groups.items():
        if not acc[mode]:    # an empty or short capture: nothing to decode
            continue
        data = np.concatenate([d for d, _ in acc[mode]], axis=-1)
        valid = np.concatenate([v for _, v in acc[mode]], axis=-1)
        for row, ch in enumerate(idxs):
            bits = compact(Ragged(data[row], valid[row]))
            out = decode_mode_bits(mode, bits)
            if (out if not isinstance(out, str) else out.strip()):
                found[int(ch)] = (mode, out)
    return found


def _t_quantum(fs: float, n_channels: int, modes) -> int:
    """Per-block time-step quantum of the mode set: the PSK31 branch
    decimates by D = floor(ch_rate/2000), so the per-channel step count
    must be a D-multiple; every other mode chain keeps the rate."""
    if "psk31" not in set(modes):
        return 1
    return max(1, int((fs / n_channels) / 2000.0))


def scan_multimode(iq: np.ndarray, fs: float, n_channels: int,
                   mode_map: Dict[int, str], block: int = None,
                   blocks=None, device=None
                   ) -> Dict[int, Tuple[str, object]]:
    """Run the bank over a capture on ``device`` (default: the card);
    returns {channel: (mode, decoded)}.  ``blocks``: optional callable
    ``block_size -> iterator`` of blocks replacing the ``iq`` capture."""
    from libsdr_tpu_torch.apps.scanner import pick_block

    device = resolve_device(device)
    m = n_channels
    # scanner sizing (t_full a 16-multiple), and a multiple of the PSK31
    # decimator when that mode is mapped
    block = pick_block(fs, m, block,
                       quantum=math.lcm(16, _t_quantum(fs, m,
                                                       mode_map.values())))
    step, init_carry, groups = build_bank(fs, block, m, mode_map)
    src = blocks(block) if blocks is not None else stream_blocks(iq, block)
    return _run_bank(src, step, init_carry(device),
                     lambda b: cplx.as_block(b, torch.float32, device)
                     .to(device), groups)


def scan_multimode_sharded(iq: np.ndarray, fs: float, n_channels: int,
                           mode_pattern, block: int = None, mesh=None,
                           device=None, plane_dtype=None, blocks=None
                           ) -> Dict[int, Tuple[str, object]]:
    """Run the bank sharded over the 1-D ``mesh`` (axis 'd'; None: one
    device, ``device``, the card by default).  Channels get modes by the
    repeating ``mode_pattern`` (channel ch -> ``mode_pattern[ch %
    len(pattern)]``); see parallel/multimode.build_multimode_step for the
    stages.  Each rank decodes its own channels, and every rank returns
    the whole {channel: (mode, decoded)}, like :func:`scan_multimode`.

    ``blocks``: optional callable ``block_size -> iterator`` of blocks
    replacing the ``iq`` capture (e.g. ``lambda b:
    io.ingest.stream_raw_iq_bf16(path, b)`` with
    ``plane_dtype=torch.bfloat16``: the u8 wire as bf16 planes into K4)."""
    import torch.distributed as dist

    from libsdr_tpu_torch.parallel.halo import mesh_axis
    from libsdr_tpu_torch.parallel.multimode import build_multimode_step

    ax = mesh_axis(mesh, "d")
    m, n, p = n_channels, ax.size, 8
    pat = list(mode_pattern)
    # t_full must divide by n (time shards), hold >= n*(P+1) frames, and
    # suit the PSK31 decimator when that mode is in the pattern.
    req = math.lcm(n, _t_quantum(fs, m, pat))
    if block is None:
        t_full = (int(fs // 2) // m) // req * req
    else:
        t_full = (int(block) // m) // req * req
    t_full = max(t_full, math.ceil(n * (p + 1) / req) * req)
    block = m * t_full

    step, init_carry, place, groups = build_multimode_step(
        m, block, fs, pat, taps_per_branch=p, plane_dtype=plane_dtype,
        mesh=mesh, device=device)
    # this rank's rows of each mode: the groups list the ranks' in turn
    mine = {mode: idxs[ax.index * (len(idxs) // n):
                       (ax.index + 1) * (len(idxs) // n)]
            for mode, idxs in groups.items()}
    src = blocks(block) if blocks is not None else stream_blocks(iq, block)
    found = _run_bank(src, step, init_carry(), place, mine)
    if n == 1:
        return found
    parts = [None] * n
    dist.all_gather_object(parts, found, group=ax.group)
    return {ch: v for part in parts for ch, v in sorted(part.items())}


def _parse_map(s: str) -> Dict[int, str]:
    out = {}
    for item in s.split(","):
        if not item.strip():
            continue
        ch, _, mode = item.partition(":")
        out[int(ch)] = mode.strip().lower()
    if not out:
        raise SystemExit("empty --map (want e.g. '2:pocsag,5:ax25')")
    return out


def _group(args, dev):
    """(mesh, rank, whether this call joined the group) for a run: under
    ``torchrun`` (a ``WORLD_SIZE`` above 1) or in a process that already
    joined a group, ``--pattern`` runs over every rank of the group as a
    1-D mesh; otherwise on one device (mesh None, rank 0)."""
    import os

    import torch.distributed as dist

    from libsdr_tpu_torch.parallel.distributed import (global_mesh,
                                                       init_multihost)

    joined = dist.is_initialized()
    if not joined and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None, 0, False
    if not args.pattern:
        raise SystemExit("--map runs on one device: use --pattern over "
                         "the ranks of a group")
    if not joined:
        dev = init_multihost(device=dev)
    return (global_mesh(("d",), device_type=dev.type), dist.get_rank(),
            not joined)


def _group_live_blocks(args, mesh, stats):
    """The ``blocks`` of :func:`scan_multimode_sharded` for a live wire over
    the ranks of a group: rank 0 alone opens the wire (``stats`` are its
    counts) and reads it as raw u8 chunks (``io/live.py::stream_live_u8``);
    each chunk reaches every rank by one broadcast
    (``parallel/halo.py::broadcast_chunks``), the end of the wire and
    ``--live-timeout`` with it, and every rank converts it alike
    (``u8_wire_block``), so each steps through the one-device run's blocks
    and all end on the same one."""
    from libsdr_tpu_torch.io.live import stream_live_u8, u8_wire_block
    from libsdr_tpu_torch.parallel.distributed import rank_device
    from libsdr_tpu_torch.parallel.halo import broadcast_chunks, mesh_axis

    ax = mesh_axis(mesh, "d")

    def blocks(b):
        def wire():   # opened inside the broadcast: a failure travels
            yield from stream_live_u8(args.live, b, stats=stats,
                                      timeout=args.live_timeout)
        chunks = broadcast_chunks(wire() if ax.index == 0 else None, 2 * b,
                                  ax, rank_device(mesh))
        for raw in chunks:
            yield u8_wire_block(raw, b, bf16=args.bf16)
    return blocks


def main(argv=None):
    ap = common_parser(
        "Multi-mode decoder bank: one channelizer front end, per-channel "
        "POCSAG/AX.25/RTTY/PSK31 decode")
    add_source_args(ap)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--map",
                    help="per-channel modes, e.g. '2:pocsag,5:ax25,9:rtty'")
    ap.add_argument("--pattern",
                    help="repeating channel->mode pattern (e.g. "
                         "'pocsag,ax25,rtty,psk31'): every channel gets a "
                         "mode and the bank runs sharded over the ranks of "
                         "the group under torchrun (parallel/multimode.py)")
    ap.add_argument("--bf16", action="store_true",
                    help="stream the u8 wire format as bfloat16 planes "
                         "straight into the channelizer: lossless for "
                         "8-bit sources, half the bytes (--raw uint8 / "
                         "--live sources)")
    ap.add_argument("--live",
                    help="live u8 IQ wire instead of a file: tcp://host:port "
                         "(rtl_tcp pull), tcp-listen://:port, udp://:port, "
                         "fifo:///path; needs --rate")
    ap.add_argument("--live-timeout", type=float, default=None,
                    help="stop after this many seconds with no wire data")
    args = ap.parse_args(argv)
    sdrlog.set_level(args.log_level)
    if bool(args.map) == bool(args.pattern):
        raise SystemExit("give exactly one of --map / --pattern")
    if args.pattern:
        pat = [p.strip().lower() for p in args.pattern.split(",") if p.strip()]
        bad = [p for p in pat if p not in MODES]
        if bad or not pat:
            raise SystemExit(f"--pattern modes must be in {'/'.join(MODES)}")
    dev = device_of(args)
    mesh, rank, own_group = _group(args, dev)
    if mesh is not None:
        dev = None               # each rank's device comes from the mesh

    def sharded(iq, fs, **kw):
        return scan_multimode_sharded(iq, fs, args.channels, pat,
                                      mesh=mesh, device=dev, **kw)

    if args.live:
        if not args.rate:
            raise SystemExit("--live requires --rate")
        from libsdr_tpu_torch.io.live import (LiveStats, stream_live_iq,
                                              stream_live_iq_bf16)
        fs = args.rate
        stats = LiveStats()
        if args.bf16 and not args.pattern:
            raise SystemExit("--bf16 --live runs the sharded bank: "
                             "use --pattern")
        plane_dtype = torch.bfloat16 if args.bf16 else None
        if mesh is not None:
            found = sharded(None, fs, plane_dtype=plane_dtype,
                            blocks=_group_live_blocks(args, mesh, stats))
        elif args.bf16:
            found = sharded(None, fs, plane_dtype=plane_dtype,
                            blocks=lambda b: stream_live_iq_bf16(
                                args.live, b, stats=stats,
                                timeout=args.live_timeout))
        else:
            blocks = lambda b: stream_live_iq(  # noqa: E731
                args.live, b, stats=stats, timeout=args.live_timeout)
            found = (sharded(None, fs, blocks=blocks) if args.pattern else
                     scan_multimode(None, fs, args.channels,
                                    _parse_map(args.map), blocks=blocks,
                                    device=dev))
        if rank == 0:
            print(f"live: {stats.bytes_in} bytes in, "
                  f"{stats.bytes_dropped} dropped "
                  f"({100 * stats.drop_fraction:.2f}%), "
                  f"{stats.sustained_msps():.2f} Msps sustained")
    elif args.bf16:
        if not args.pattern:
            raise SystemExit("--bf16 runs the sharded bank: use --pattern")
        if not args.raw or np.dtype(args.raw_dtype) != np.uint8:
            raise SystemExit("--bf16 needs a --raw uint8 (rtl_sdr wire) "
                             "source")
        if not args.rate:
            raise SystemExit("--raw requires --rate")
        from libsdr_tpu_torch.io.ingest import stream_raw_iq_bf16
        fs = args.rate
        found = sharded(None, fs, plane_dtype=torch.bfloat16,
                        blocks=lambda b: stream_raw_iq_bf16(args.raw, b))
    else:
        iq, fs = load_source(args)
        if not np.iscomplexobj(iq):
            raise SystemExit("multimode expects an IQ capture")
        found = (sharded(iq, fs) if args.pattern else
                 scan_multimode(iq, fs, args.channels, _parse_map(args.map),
                                device=dev))
    if own_group:
        from libsdr_tpu_torch.parallel.distributed import shutdown_multihost
        shutdown_multihost()
    if rank == 0:
        _print_found(found, fs, args.channels)
    return found


def _print_found(found, fs: float, m: int) -> None:
    for ch in sorted(found):
        mode, out = found[ch]
        f_center = ch * fs / m if ch <= m // 2 else ch * fs / m - fs
        hdr = f"ch {ch:4d} ({f_center / 1e3:+9.1f} kHz) [{mode}]"
        if mode == "pocsag":
            for msg in out:
                print(f"{hdr}: POCSAG @{msg.address} '{msg.best_decode()}'")
        elif mode == "ax25":
            for frame, aprs in out:
                print(f"{hdr}: {frame}")
                if aprs is not None:
                    print(f"{hdr}:   {aprs}")
        else:
            print(f"{hdr}: {out.strip()}")
    if not found:
        print("no traffic decoded")


if __name__ == "__main__":
    main()
