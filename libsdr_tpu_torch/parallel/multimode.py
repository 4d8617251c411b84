"""The sharded multi-mode decoder bank (counterpart of
``libsdr_tpu.parallel.multimode``): a time-sharded channelizer and
channel-sharded per-mode demod/decode chains over the n ranks of a 1-D
mesh axis, laid out as ``parallel/wideband.py``:

1. **Channelize, time-sharded.**  Each rank runs the channelizer (K4's
   channel variant on a card, :func:`wideband.channelize_local`) on its B/n
   segment, the P-frame history from the left neighbour.  The COMPLEX bank
   is kept: the mode chains need it (USB for RTTY, PSK31's own baseband
   select).
2. **Reshard.**  One all_to_all turns (M channels, t/n local time) into
   (M/n local channels, t full time): the complex float32 bank crosses
   once.
3. **Decode, channel-sharded.**  Each rank runs every mode chain on its
   local channel groups (``ops/bitsync.apply_mode_chains``: the BitStream
   PLLs as one banked K3 launch, the PSK31 group's IQBaseBand on K1b).  To
   be one program on every rank, modes go by a repeating ``mode_pattern``
   over the global channel index (channel ch gets ``mode_pattern[ch %
   len(mode_pattern)]``), whose length divides the rank's group M/n.

On one rank it is the one-device bank (``apps/multimode.build_bank`` with
the pattern's map), bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.parallel.wideband import (_history, _setup,
                                                channelize_local)


def build_multimode_step(n_channels: int, block: int, fs_hz: float,
                         mode_pattern: Sequence[str],
                         taps_per_branch: int = 8, plane_dtype=None,
                         mesh=None, axis: str = "d", device=None):
    """Build (step, init_carry, place_input, groups) for the sharded
    multi-mode bank.

    ``step(carry, x)`` consumes this rank's part (``place_input``) of a
    global (B,) complex wideband block and returns ``{mode: Ragged bits}``
    for the rank's channels of that mode, rows in ascending global channel
    order; ``groups[mode]`` lists the mode's global channels, ranks' rows
    one after another.  Each row is that mode's windowed bit stream
    (compacted T/window slots; PSK31 unwindowed).

    ``mode_pattern``: the repeating channel -> mode assignment, e.g.
    ``("pocsag", "ax25", "rtty", "psk31")``; its length must divide
    M / n.  ``plane_dtype``: the input planes' dtype (``torch.bfloat16``
    for blocks straight off the u8 wire, ``io.ingest.stream_raw_iq_bf16``:
    lossless for 8-bit sources; K4 takes the bf16 planes and the mode
    chains see the float32 bank).  ``mesh``/``axis``/``device`` as
    :func:`wideband.build_wideband_step`."""
    from libsdr_tpu_torch.apps.multimode import mode_parts
    from libsdr_tpu_torch.ops.bitsync import apply_mode_chains
    from libsdr_tpu_torch.parallel.distributed import place_global
    from libsdr_tpu_torch.parallel.halo import all_to_all

    m, p = int(n_channels), int(taps_per_branch)
    ax, dev, taps3, tw = _setup(mesh, axis, device, block, m, p)
    n = ax.size
    g = m // n                       # channels a rank after the reshard
    pat = list(mode_pattern)
    if g % len(pat):
        raise ValueError(f"mode_pattern length {len(pat)} must divide the "
                         f"per-device channel group M/n = {g}")

    # The rank's mode chains, the same on every rank (the pattern repeats
    # within each contiguous g-channel shard): the one-device bank's on
    # the rank's g channels.
    sub, loc_groups, windows = mode_parts(
        fs_hz / m, block // m, {i: pat[i % len(pat)] for i in range(g)})
    groups = {mode: np.concatenate([d * g + idxs for d in range(n)])
              .astype(np.int32) for mode, idxs in loc_groups.items()}

    def step(carry, x_local):
        hist_g, carries = carry
        hist, new_hist = _history(hist_g, x_local, m, p, ax)
        y = channelize_local(x_local, hist, taps3, m, p, twiddles=tw)
        # (M, t/n) time-sharded -> (M/n, t_full) channel-sharded
        y = all_to_all(y, ax, split_axis=0, concat_axis=1)
        outs, new_c = apply_mode_chains(sub, carries, y, loc_groups,
                                        windows)
        return (new_hist, new_c), outs

    in_dtype = plane_dtype if plane_dtype is not None else torch.float32

    def init_carry():
        return (cplx.zeros((p, m), in_dtype, dev),
                {mode: pl.init_carry(dev) for mode, pl in sub.items()})

    def place_input(x):
        return place_global(x, mesh, (axis,), in_dtype, dev)

    return step, init_carry, place_input, groups
