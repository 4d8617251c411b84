"""The traffic generator is deterministic in the seed, every seed gives the
same work, and the pages are the program's own format (the test may
import the program; the generator does not)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import manifest, signals
from benchmark.signals import pocsag_pages
from benchmark.reference import pocsag

from conftest import tiny_cell

BIG = 2 ** 31 + 12_345


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))


def test_fm_tones_follow_the_seed():
    cell = tiny_cell("fm_bank.capture")
    a, _ = signals.make(cell.config, cell.traffic, BIG, "cpu")
    b, _ = signals.make(cell.config, cell.traffic, BIG, "cpu")
    c, _ = signals.make(cell.config, cell.traffic, BIG + 1, "cpu")
    assert _same(a, b) and not _same(a, c)
    assert len(a) == cell.traffic["distinct_blocks"]
    assert a[0][0].shape == (cell.config["channels"],
                             cell.traffic["block_samples"])
    assert a[0][0].dtype == torch.float32


def test_pages_follow_the_seed_in_another_order():
    cell = tiny_cell("pager.capture")
    a, pa = signals.make(cell.config, cell.traffic, BIG, "cpu")
    b, pb = signals.make(cell.config, cell.traffic, BIG, "cpu")
    c, pc = signals.make(cell.config, cell.traffic, 7, "cpu")
    assert _same(a, b) and not _same(a, c)
    assert [(ch, s) for ch, _, s in pa] == [(ch, s) for ch, _, s in pb]
    assert sorted(s for _, _, s in pa) == sorted(s for _, _, s in pc)
    assert [len(p) for _, p, _ in pa] == [len(p) for _, p, _ in pc]


def test_the_whole_band_carries_67_pages_as_the_program_plans_them():
    from libsdr_tpu_torch.tools.wideband_signals import PAGER_CHANNELS
    cell = manifest.cell("pager.capture")
    chans = pocsag_pages.page_channels(cell.config["channels"], cell.traffic)
    assert tuple(chans) == PAGER_CHANNELS and len(chans) == 67


def test_pages_are_the_programs_bits():
    from libsdr_tpu_torch.decode import pocsag_decode_bits
    from libsdr_tpu_torch.decode.pocsag import pocsag_encode_batch
    for addr, text in ((100_016, "W1 CH 16"), (100_000 + 1020, "W1 CH 1020"),
                       (7, "A LONGER PAGE THAT TAKES TWO BATCHES OF WORDS")):
        ours = pocsag.encode_page(addr, 1, text)
        assert np.array_equal(ours, pocsag_encode_batch(addr, 1, text))
        (msg,) = pocsag_decode_bits(ours)
        bits = tuple((msg.payload[i // 8] >> (7 - i % 8)) & 1
                     for i in range(msg.bits))
        assert pocsag.decode(ours) == [(addr, 1, bits)]
