"""The comparison fails what it must: with the timed path broken underneath
(a step that returns its state unchanged, half the channels left out, an
answer altered where it is produced: an audio sample, or three bits of a
page's address word) a whole run reads ``correct`` false,
and so does the control, the program's own bfloat16-plane path.  One
chip, so no exchange between chips to leave out.  The runs skip the
harness's look for a card and run the program's plain path on the CPU
(the ``cuda`` case runs the same on the card)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.signals import pocsag_pages

from conftest import run_tiny, tiny_cell

FM_CELLS = ["fm_bank.capture", "fm_bank.stream"]
FAULTS = ["stale_state", "half_channels", "altered_answer"]


def _break_fm(monkeypatch, fault):
    from libsdr_tpu_torch.ops.fm_fused import FMBasebandFused
    apply = FMBasebandFused.apply

    def broken(self, carry, x):
        new, y = apply(self, carry, x)
        if fault == "stale_state":
            return carry, y
        y = y.clone()
        if fault == "half_channels":
            y[y.shape[0] // 2:] = 0
        else:
            y[0, y.shape[-1] // 2] += 0.1
        return new, y
    monkeypatch.setattr(FMBasebandFused, "apply", broken)


def _break_pager(monkeypatch, fault, cell, seed):
    from libsdr_tpu_torch.parallel import wideband
    build = wideband.build_scanner_step
    cfg, tr = cell.config, cell.traffic
    m = cfg["channels"]
    frames = tr["block_samples"] // m
    # the first page's address word: the block it lies in, its frame there
    ch, page, start = pocsag_pages.page_plan(cfg, tr, seed)[0]
    spb = cfg["sample_rate"] / m / cfg["baud"]
    word = 600 + 32 + 64 * ((tr["address0"] + ch) & 7)
    mid = start + int((word + 4) * spb)
    blk, at = divmod(mid, frames)

    def broken_build(*a, **k):
        step, init, place = build(*a, **k)
        calls = [0]

        def step2(carry, x):
            new, y = step(carry, x)
            i, calls[0] = calls[0], calls[0] + 1
            if fault == "stale_state":
                return carry, y
            y = y.clone()
            if fault == "half_channels":
                y[m // 2:] = 0
            elif i % tr["distinct_blocks"] == blk:
                # three bits of the address word: past what BCH repairs
                w = frames // y.shape[-1]
                valid = torch.nonzero(y[ch, at // w:] >= 2)[:3, 0]
                y[ch, at // w + valid] ^= 1
            return new, y
        return step2, init, place
    monkeypatch.setattr(wideband, "build_scanner_step", broken_build)


@pytest.mark.parametrize("name", FM_CELLS + ["pager.capture"])
def test_sound_run_is_correct(name):
    r = run_tiny(name)
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", FM_CELLS + ["pager.capture"])
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    seed = 31
    if name.startswith("fm_bank"):
        _break_fm(monkeypatch, fault)
    else:
        _break_pager(monkeypatch, fault, tiny_cell(name), seed)
    r = run_tiny(name, seed=seed)
    assert not r["correct"], r["compared"]


def _control(name, device):
    return harness.run_cell(tiny_cell(name), 41, 0.05, False, device,
                            time.perf_counter(), planes="bfloat16")


@pytest.mark.parametrize("name", FM_CELLS + ["pager.capture"])
def test_control_is_not_correct(name):
    r = _control(name, "cpu")
    assert not r["correct"], r["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", FM_CELLS + ["pager.capture"])
def test_control_is_not_correct_on_the_card(card, name):
    assert harness.run_cell(tiny_cell(name), 41, 0.05, False, card,
                            time.perf_counter())["correct"]
    assert not _control(name, card)["correct"]
