"""``ops/pll.window_pack``, the pager scanner's windowed compaction of the
bit-sync PLL's packed bytes, on the CPU: its plain version byte for byte
against the JAX package's arithmetic (``libsdr_tpu.core.ragged.
compact_windows``, the lane gather and the packing, as the JAX scanner
step does them), the wrapper's dispatch and refusals, and the scanner
step's packed and Ragged outputs.  The kernel's card tests are in
``tests/test_torch_cuda.py`` (that file imports no JAX)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libsdr_tpu.core import ragged as jragged
from libsdr_tpu_torch.core.cplx import Complex
from libsdr_tpu_torch.ops.pfb import lane_of_channel
from libsdr_tpu_torch.ops.pll import window_pack, window_pack_plain
from libsdr_tpu_torch.parallel.wideband import build_scanner_step

T = 64 * 5


def _packed(seed: int, m: int, t: int) -> np.ndarray:
    """PLL bytes drawn from a seed: bit 0 the bit, bit 1 the valid flag,
    half the steps valid, so windows of 2 or more steps hold 2-3 valid
    items (the sum the PLL's bit gap never makes, and the wrapper must
    still give as the plain version does)."""
    return np.random.default_rng(seed).integers(0, 4, (m, t), dtype=np.uint8)


def _jax_windows(raw: np.ndarray, w: int, rows) -> np.ndarray:
    r = jragged.compact_windows(
        jragged.Ragged(jnp.asarray(raw & 1), jnp.asarray((raw & 2) != 0)), w)
    data, valid = r.data, r.valid
    if rows is not None:
        data, valid = data[..., rows, :], valid[..., rows, :]
    return np.asarray(data | (valid.astype(jnp.uint8) << 1))


@pytest.mark.parametrize("rows", ["lanes", "none"])
@pytest.mark.parametrize("w", [1, 2, 4, 16, 64])
@pytest.mark.parametrize("m", [16, 256, 1024])
def test_window_pack_plain_matches_jax(m, w, rows):
    raw = _packed(m * 100 + w, m, T)
    lanes = lane_of_channel(m) if rows == "lanes" else None
    want = _jax_windows(raw, w, lanes)
    x = torch.from_numpy(raw)
    plain = window_pack_plain(x, w, None if lanes is None
                              else torch.from_numpy(lanes))
    n = window_pack.launches
    got = window_pack(x, w, rows=lanes)         # a CPU tensor: plain
    assert window_pack.launches == n
    assert got.dtype == torch.uint8 and tuple(got.shape) == (m, T // w)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)
    if w > 1:
        per = ((raw & 2) != 0).reshape(m, T // w, w).sum(-1)
        assert (per >= 2).any()


@pytest.mark.parametrize("w,t", [(3, 96), (12, 96), (256, 512), (512, 1024)])
def test_window_pack_plain_any_window_matches_jax(w, t):
    """Windows outside pick_window's powers of two, and windows of 256 or
    more, where a row of valid 1 bits sums past 255 and wraps (bytes 3:
    512 items a window read 0 | 2)."""
    raw = _packed(w, 7, t)
    raw[2] = 3
    rows = np.array([6, 2, 2, 0, 5])
    for r in (None, rows):
        want = _jax_windows(raw, w, r)
        got = window_pack(torch.from_numpy(raw), w, rows=r)
        np.testing.assert_array_equal(got.numpy(), want)
    full = window_pack(torch.from_numpy(raw[2:3]), w).numpy()
    assert (full == ((w & 0xFF) | 2)).all()


def test_window_pack_refuses_what_it_does_not_take():
    x = torch.zeros(4, 32, dtype=torch.uint8)
    for bad in (x.to(torch.int32), x[0]):
        with pytest.raises(ValueError, match="uint8"):
            window_pack(bad, 4)
    for w in (0, 5, 64):
        with pytest.raises(ValueError, match="divide"):
            window_pack(x, w)
    for rows in (torch.tensor([0, 4]), torch.tensor([-1]), [0.0, 1.0],
                 torch.zeros(2, 2, dtype=torch.int64)):
        with pytest.raises(ValueError, match="rows"):
            window_pack(x, 4, rows=rows)
    with pytest.raises(ValueError, match="no kernel"):
        window_pack(torch.empty(4, 32, dtype=torch.uint8, device="meta"), 4)
    assert tuple(window_pack(x, 4, rows=torch.zeros(0, dtype=torch.int64))
                 .shape) == (0, 8)


@pytest.mark.parametrize("m", [16, 256])
def test_scanner_packed_and_ragged_outputs_agree(m):
    """The scanner step's Ragged output is its packed output unpacked, and
    both are the windows of the PLL's bytes in channel order; without a
    window the step keeps its unwindowed path."""
    fs = m * 24_000.0
    block = m * 16 * 64
    g = torch.Generator().manual_seed(m)
    x = Complex(torch.randn(block, generator=g),
                torch.randn(block, generator=g))
    outs = {}
    for w, packed in ((16, True), (16, False), (0, True), (0, False)):
        step, init, place = build_scanner_step(m, block, fs,
                                               compact_window=w,
                                               packed=packed, device="cpu")
        _, outs[w, packed] = step(init(), place(x))
    y = outs[16, True]
    assert y.dtype == torch.uint8 and tuple(y.shape) == (m, block // m // 16)
    for w in (16, 0):
        r, y = outs[w, False], outs[w, True]
        assert torch.equal(r.data.to(torch.uint8), y & 1)
        assert torch.equal(r.valid, y >= 2)
    raw = outs[0, True].contiguous()        # channel order, unwindowed
    assert torch.equal(outs[16, True], window_pack_plain(raw, 16))
