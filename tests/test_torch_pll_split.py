"""The decomposition of the card's PLL kernels (``csrc/bitsync.cu``),
emulated on the CPU by ``libsdr_tpu_torch.ops.pll.pll_split``, against the
JAX package: the majority pass's bit masks, the serial pass that carries
only phase and omega and writes an emit mask, and the bits pass that
rebuilds last_bits from per-word and per-chunk summaries.

The reference is the JAX kernels ``pll_pallas`` and ``pll_pallas_bank`` in
interpret mode where their gate takes the shape (M a multiple of 128, T a
multiple of 8, L <= 512), else the JAX BitStream's scan, and the port's
plain version ``pll_plain``.  Every output byte and every carry is
bit-exact.  The edges: a block with no emit, lanes with fewer than 16
emits (so part of last_bits_in survives), T of 1, 31, 33 and others not a
multiple of 32, chunk boundaries (chunks of 1, 2 and 32 words), windows up
to 896, omega starting outside its bounds (the clamp of the block's first
step), and both bit mappings.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libsdr_tpu as J
from libsdr_tpu.ops import pallas_bitsync as jpb
from libsdr_tpu_torch.ops.pll import (CHUNK_WORDS, _to_words, _word_bits,
                                      pll_bank_plain, pll_plain, pll_split)


def _runs(rng, m, t, run):
    """(m, t) uint8 symbols in runs of about ``run`` steps, with flips."""
    sym = np.repeat(rng.integers(0, 2, (m, t // run + 2)), run, axis=1)
    flips = rng.random((m, sym.shape[1])) < 0.02
    return (sym ^ flips)[:, :t].astype(np.uint8)


def _equal(got, want):
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"result {k}")


@pytest.mark.parametrize("t", [1, 31, 32, 33, 100])
def test_words_round_trip(t):
    """Bit k of word j is step 32j + k; the steps past T are zero."""
    bits = torch.from_numpy(np.random.default_rng(t).random((3, t)) < 0.5)
    w = _to_words(bits, -(-t // 32))
    assert w.shape == (3, -(-t // 32))
    assert int(w.max()) < 2 ** 32
    assert torch.equal(_word_bits(w, t), bits)
    assert int((w[:, -1] >> (t - 32 * (w.shape[1] - 1))).max()) == 0


@pytest.mark.parametrize("chunk_words", [CHUNK_WORDS, 2])
@pytest.mark.parametrize("mode", [False, True])
def test_split_matches_pallas_kernel(rng, mode, chunk_words):
    """pll_split against pll_pallas (interpret mode) and pll_plain, two
    chained blocks of 264 steps (8 words and a part word; chunks of 2 words
    put boundaries inside the block); the port lane-major, the JAX kernel
    time-major."""
    t, m, L = 264, 128, 20
    om0 = 1.0 / L
    kw = dict(omega_min=om0 * 0.995, omega_max=om0 * 1.005, gain=5e-4)
    jst = [jnp.zeros((L - 1, m), np.int32), jnp.zeros((m,), np.int32),
           jnp.zeros((m,), np.float32), jnp.full((m,), om0, np.float32),
           jnp.zeros((m,), np.int32)]
    pst = [torch.zeros(m, L - 1, dtype=torch.int32),
           torch.zeros(m, dtype=torch.int32), torch.zeros(m),
           torch.full((m,), om0), torch.zeros(m, dtype=torch.int32)]
    for _ in range(2):
        sym = _runs(rng, m, t, 8)
        jout, *jst = jpb.pll_pallas(jnp.asarray(sym.T), *jst,
                                    transition=mode, interpret=True, **kw)
        got = pll_split(torch.from_numpy(sym), *pst, transition=mode,
                        chunk_words=chunk_words, **kw)
        np.testing.assert_array_equal(got[0].numpy().T,
                                      np.asarray(jout).astype(np.uint8))
        np.testing.assert_array_equal(got[1].numpy().T, np.asarray(jst[0]))
        _equal(got[2:], jst[1:])
        _equal(got, pll_plain(torch.from_numpy(sym), *pst, transition=mode,
                              **kw))
        pst = list(got[1:])


def test_split_matches_pallas_bank_kernel(rng):
    """pll_split with per-lane parameters against pll_pallas_bank
    (interpret mode) and pll_bank_plain on a bank of L = 20 normal, 20
    transition and 264 normal lanes, two chained blocks."""
    t = 256
    cfg = [(20, 0, 48), (20, 1, 40), (264, 0, 40)]
    ells = np.concatenate([np.full(n, e, np.int32) for e, _, n in cfg])
    trans = np.concatenate([np.full(n, tr, np.int32) for _, tr, n in cfg])
    m, r = len(ells), 263
    om0 = (1.0 / ells).astype(np.float32)
    kw = dict(omega_min=om0 * np.float32(0.995),
              omega_max=om0 * np.float32(1.005),
              gain=np.full(m, 5e-4, np.float32), transition=trans, ell=ells)
    uniq = (20, 264)
    onehot = np.stack([(ells == e).astype(np.int32) for e in uniq])
    jst = [jnp.zeros((r, m), np.int32), jnp.zeros((m,), np.int32),
           jnp.zeros((m,), np.float32), jnp.asarray(om0),
           jnp.zeros((m,), np.int32)]
    pst = [torch.zeros(m, r, dtype=torch.int32),
           torch.zeros(m, dtype=torch.int32), torch.zeros(m),
           torch.from_numpy(om0), torch.zeros(m, dtype=torch.int32)]
    for _ in range(2):
        sym = _runs(rng, m, t, 10)
        jout, *jst = jpb.pll_pallas_bank(
            jnp.asarray(sym.T), *jst, jnp.asarray(kw["omega_min"]),
            jnp.asarray(kw["omega_max"]), jnp.asarray(kw["gain"]),
            jnp.asarray(trans), jnp.asarray(onehot), ells=uniq,
            interpret=True)
        got = pll_split(torch.from_numpy(sym), *pst, **kw)
        np.testing.assert_array_equal(got[0].numpy().T,
                                      np.asarray(jout).astype(np.uint8))
        _equal(got[2:], jst[1:])
        _equal(got, pll_bank_plain(torch.from_numpy(sym), *pst, **kw))
        jsg = np.asarray(jst[0]).T
        for i, e in enumerate(ells):
            np.testing.assert_array_equal(got[1][i, r - (e - 1):].numpy(),
                                          jsg[i, r - (e - 1):])
        jst[0] = jnp.asarray(np.where(
            np.arange(r)[None, :] >= r - (ells[:, None] - 1), jsg, 0).T)
        pst = list(got[1:])


# (L, mode, T, omega0 scale, omega bounds about omega0, chunk words): the
# edges of the split, each over two chained blocks against the JAX scan.
EDGES = {
    "no emit": (20, "normal", 64, 0.02, (0.01, 2.0), CHUNK_WORDS),
    "few emits": (40, "transition", 256, 1.0, (0.995, 1.005), CHUNK_WORDS),
    "16 emits a word": (2, "normal", 2048, 1.0, (0.995, 1.005),
                        CHUNK_WORDS),
    "T=1": (20, "transition", 1, 1.0, (0.995, 1.005), CHUNK_WORDS),
    "T=31": (20, "normal", 31, 1.0, (0.995, 1.005), CHUNK_WORDS),
    "T=33": (20, "transition", 33, 1.0, (0.5, 2.0), CHUNK_WORDS),
    "T=100 chunks of 1 word": (8, "normal", 100, 1.0, (0.5, 2.0), 1),
    "chunk boundaries": (20, "transition", 2100, 1.0, (0.995, 1.005),
                         CHUNK_WORDS),
    "chunk boundaries, 2 words": (2, "normal", 2100, 1.0, (0.5, 2.0), 2),
    "omega clamped at step 0": (20, "normal", 96, 3.0, (0.995, 1.005),
                                CHUNK_WORDS),
    "L=512": (512, "transition", 1040, 1.0, (0.5, 2.0), CHUNK_WORDS),
    "L=896": (896, "normal", 2050, 1.0, (0.995, 1.005), CHUNK_WORDS),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_split_edges_match_jax_scan(rng, case):
    """pll_split against the JAX BitStream (its scan, or its kernel where
    the gate takes the shape) and pll_plain at the split's edges, two
    chained blocks from a carried window of marks, last_bits_in random
    16-bit values so that a lane with fewer than 16 emits keeps part of
    it."""
    L, mode, t, scale, (lo, hi), chunk_words = EDGES[case]
    m = 8
    bs = J.ops.BitStream(1200.0, mode=mode)
    bs.bind(J.StreamSpec(np.uint8, 1200.0 * L, t, channels=(m,)))
    assert bs.corr_len == L
    om0 = np.float32(bs._omega0)
    bs._omega_min, bs._omega_max = om0 * lo, om0 * hi
    kw = dict(omega_min=bs._omega_min, omega_max=bs._omega_max,
              gain=bs._pll_gain, transition=mode == "transition")
    lb0 = rng.integers(0, 1 << 16, m).astype(np.int32)
    om_in = np.full(m, om0 * np.float32(scale), np.float32)
    # the carried window all marks, so no lane crosses at the first step
    # (only the block's first step then clamps omega)
    signs = np.ones((m, L - 1), np.int32)
    ss = np.full(m, L, np.int32)
    jc = dict(signs=jnp.asarray(signs), sym_sum=jnp.asarray(ss),
              phase=jnp.zeros(m, np.float32), omega=jnp.asarray(om_in),
              last_bits=jnp.asarray(lb0))
    pst = [torch.from_numpy(signs), torch.from_numpy(ss), torch.zeros(m),
           torch.from_numpy(om_in), torch.from_numpy(lb0)]
    emits = np.zeros(m, np.int64)
    for _ in range(2):
        sym = _runs(rng, m, t, max(1, L // 2))
        jc, jr = bs.apply(jc, jnp.asarray(sym))
        got = pll_split(torch.from_numpy(sym), *pst,
                        chunk_words=chunk_words, **kw)
        np.testing.assert_array_equal((got[0] & 1).numpy(),
                                      np.asarray(jr.data))
        np.testing.assert_array_equal((got[0] >> 1).numpy().astype(bool),
                                      np.asarray(jr.valid))
        for k, v in zip(("signs", "sym_sum", "phase", "omega", "last_bits"),
                        got[1:]):
            np.testing.assert_array_equal(v.numpy(), np.asarray(jc[k]),
                                          err_msg=k)
        _equal(got, pll_plain(torch.from_numpy(sym), *pst, **kw))
        emits += (got[0] >> 1).sum(1).numpy()
        pst = list(got[1:])
    if case == "no emit":
        assert emits.max() == 0
        np.testing.assert_array_equal(pst[4].numpy(), lb0)
    if case == "few emits":   # lanes with < 16 emits keep lb0's low bits
        assert 0 < emits.max() < 16
        np.testing.assert_array_equal(pst[4].numpy() >> emits,
                                      lb0 & (0xFFFF >> emits))
