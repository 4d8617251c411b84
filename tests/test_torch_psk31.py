"""The port's BPSK31 op (``libsdr_tpu_torch/ops/psk31.py``) and
``ops/iir.py::iir_first_order_varcoef`` against the JAX package on the CPU.

On the CPU ``bpsk31_scan`` takes its plain version, the numpy loop that
``csrc/psk31.cu`` repeats on the card step for step (the card's tests are
in ``tests/test_torch_cuda.py``).  The inputs are made with numpy from a
seed and go through both packages.  Bounds:

* BPSK31: bits and valid flags equal to the JAX scan's, on channels that
  carry a signal (each channel its own text at its own carrier offset, at
  20 dB SNR), with the carry handed between the packages.  Channels of
  noise alone are not held to the JAX bits: a last-bit difference in the
  phasor sends the carrier PLL another way there (ROADMAP.md, Queue 3);
* ``iir_first_order_varcoef``: within 1e-5 of max |y| of the JAX scan and
  of a float64 loop (both sum in float32, in another association).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libsdr_tpu as J
import libsdr_tpu_torch as P
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu_torch import interop
from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.cplx import Complex

FS = 2000
TEXTS = [f"cq de k{ch} pse k" for ch in range(8)]
OFFSETS_HZ = (-7.5, -5.0, -2.5, 0.0, 1.5, 3.0, 4.5, 6.0)
SNR_DB = 20.0


def _to_jax(tree):
    """A host carry (interop.state_to_numpy) as the JAX package's carry."""
    if isinstance(tree, interop.PlanarArray):
        return jcplx.Complex(jnp.asarray(tree.re), jnp.asarray(tree.im))
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _bank_signal(block, seed=31):
    """(8, N) complex64: channel ch sends TEXTS[ch] in BPSK31 (64 samples a
    symbol at 2 kHz, idle symbols before and after) on a carrier
    OFFSETS_HZ[ch] off, in complex Gaussian noise SNR_DB below the unit
    carrier; N a multiple of ``block``."""
    from libsdr_tpu_torch.decode import varicode_encode_bits

    bits = [np.concatenate([np.ones(16, np.uint8), varicode_encode_bits(t),
                            np.ones(16, np.uint8)]) for t in TEXTS]
    n_sym = max(len(b) for b in bits)
    n = -(-n_sym * 64 // block) * block
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(10 ** (-SNR_DB / 10) / 2)
    rows = []
    for b, f in zip(bits, OFFSETS_HZ):
        b = np.concatenate([b, np.ones(-(-n // 64) - len(b), np.uint8)])
        ph = np.repeat(np.cumsum(np.where(b == 0, np.pi, 0.0)), 64)[:n]
        rows.append(np.exp(1j * (ph + 2 * np.pi * f * t / FS))
                    + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n)))
    return np.stack(rows).astype(np.complex64)


def _ops(channels, block):
    from libsdr_tpu.ops import BPSK31 as JBPSK31
    from libsdr_tpu_torch.ops import BPSK31

    jop, pop = JBPSK31(), BPSK31()
    jop.bind(J.StreamSpec(np.complex64, FS, block, channels=channels))
    pop.bind(P.StreamSpec(np.complex64, FS, block, channels=channels))
    return jop, pop


@pytest.mark.parametrize("block", [1000, 1003])
def test_bpsk31_bank_bits_equal_jax(block):
    """Eight channels, each its own text at its own carrier offset, over
    chained blocks: every block's bits and valid flags equal the JAX
    scan's, the carry handed from the port to JAX after even blocks and
    from JAX to the port after odd ones; each channel decodes its text.
    At 1003 samples a block the ring index enters the blocks at every
    start 0-7."""
    from libsdr_tpu_torch.decode import VaricodeDecoder

    sig = _bank_signal(block)
    jop, pop = _ops((8,), block)
    jc, pc = jop.init_carry(), pop.init_carry("cpu")
    bits, starts = [], set()
    for i in range(sig.shape[1] // block):
        blk = sig[:, i * block:(i + 1) * block]
        starts.add(int(pc["dl_idx"]))
        jc, jy = jop.apply(jc, jcplx.as_block(blk))
        pc, py = pop.apply(pc, cplx.as_block(blk))
        np.testing.assert_array_equal(py.valid.numpy(), np.asarray(jy.valid))
        np.testing.assert_array_equal(py.data.numpy(), np.asarray(jy.data))
        bits.append((py.data.numpy(), py.valid.numpy()))
        if i % 2 == 0:
            jc = _to_jax(interop.state_to_numpy(pc))
        else:
            pc = interop.state_from_numpy(jc, "cpu")
    assert starts == (set(range(8)) if block == 1003 else {0})
    data = np.concatenate([d for d, _ in bits], axis=1)
    valid = np.concatenate([v for _, v in bits], axis=1)
    for ch, text in enumerate(TEXTS):
        assert text in VaricodeDecoder().process(data[ch][valid[ch]]), ch


@pytest.mark.parametrize("start", range(8))
def test_bpsk31_every_ring_start_equals_jax(start):
    """From one carry (a block of 1000 run by the port) with the ring index
    set to each start 0-7 in both packages, a block of 101 samples: the
    same bits and valid flags, the ring index start + 101 mod 8, and the
    ring within 1e-5 of its largest value (the two phasors may part in
    their last bit)."""
    sig = _bank_signal(1000)
    jop, pop = _ops((8,), 101)
    pc, _ = pop.apply(pop.init_carry("cpu"), cplx.as_block(sig[:, :1000]))
    host = interop.state_to_numpy(pc)
    host["dl_idx"] = np.asarray(start, np.int32)
    blk = sig[:, 1000:1101]
    jc, jy = jop.apply(_to_jax(host), jcplx.as_block(blk))
    pc, py = pop.apply(interop.state_from_numpy(host, "cpu"),
                       cplx.as_block(blk))
    np.testing.assert_array_equal(py.valid.numpy(), np.asarray(jy.valid))
    np.testing.assert_array_equal(py.data.numpy(), np.asarray(jy.data))
    assert int(pc["dl_idx"]) == int(jc["dl_idx"]) == (start + 101) % 8
    ring = cplx.to_numpy(pc["dl"])
    np.testing.assert_allclose(ring, jcplx.to_numpy(jc["dl"]), rtol=0,
                               atol=1e-5 * np.abs(ring).max())


def test_bpsk31_channel_dims_are_one_bank():
    """A (2, 4) channel bank gives the (8,) bank's bits and carry, leaf for
    leaf reshaped."""
    sig = _bank_signal(1000)[:, :1000]
    _, flat = _ops((8,), 1000)
    _, grid = _ops((2, 4), 1000)
    fc, fy = flat.apply(flat.init_carry("cpu"), cplx.as_block(sig))
    gc, gy = grid.apply(grid.init_carry("cpu"),
                        cplx.as_block(sig.reshape(2, 4, 1000)))
    assert gy.data.shape == (2, 4, 1000) and gy.valid.dtype == torch.bool
    assert torch.equal(gy.data.reshape(8, 1000), fy.data)
    assert torch.equal(gy.valid.reshape(8, 1000), fy.valid)
    for k, v in fc.items():
        g = gc[k]
        if isinstance(v, Complex):
            assert g.re.shape[:2] == (2, 4)
            assert torch.equal(g.re.reshape(v.re.shape), v.re)
            assert torch.equal(g.im.reshape(v.im.shape), v.im)
        else:
            assert torch.equal(g.reshape(v.shape), v)


def test_bpsk31_scan_refuses_other_devices():
    """No kernel for a device other than the CPU and CUDA, and no carry
    leaf read from another device than the block's."""
    from libsdr_tpu_torch.ops import BPSK31
    from libsdr_tpu_torch.ops.psk31 import bpsk31_scan

    op = BPSK31()
    op.bind(P.StreamSpec(np.complex64, FS, 16, channels=(2,)))
    meta = Complex(torch.empty((2, 16), device="meta"),
                   torch.empty((2, 16), device="meta"))
    carry = {k: v.to("meta") for k, v in op.init_carry("cpu").items()}
    with pytest.raises(ValueError, match="no kernel"):
        bpsk31_scan(meta, carry, **op.constants())
    with pytest.raises(ValueError, match="carry leaf"):
        bpsk31_scan(meta, op.init_carry("cpu"), **op.constants())


# -- iir_first_order_varcoef ---------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 257), (2, 4, 1024)])
def test_iir_first_order_varcoef_matches_jax(shape):
    """Random per-sample coefficients a in (0, 1), b, x and y0: within 1e-5
    of max |y| of the JAX scan and of the recurrence in float64; the final
    state is the output's last sample."""
    from libsdr_tpu.ops.iir import iir_first_order_varcoef as jvar
    from libsdr_tpu_torch.ops.iir import iir_first_order_varcoef

    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    a = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    y0 = rng.normal(size=shape[:-1]).astype(np.float32)
    y, last = iir_first_order_varcoef(*map(torch.from_numpy, (x, a, b, y0)))
    jy, jlast = jvar(*map(jnp.asarray, (x, a, b, y0)))
    ref = np.empty(shape)
    prev = y0.astype(np.float64)
    for n in range(shape[-1]):
        prev = a[..., n] * prev + b[..., n].astype(np.float64) * x[..., n]
        ref[..., n] = prev
    tol = 1e-5 * np.abs(ref).max()
    assert y.dtype == torch.float32 and y.shape == shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=tol)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=tol)
    np.testing.assert_array_equal(last.numpy(), y.numpy()[..., -1])
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0,
                               atol=tol)


def test_iir_first_order_varcoef_scalar_state_and_broadcast_b():
    """A scalar y0 and a b broadcast over the block, as the JAX function
    takes them."""
    from libsdr_tpu.ops.iir import iir_first_order_varcoef as jvar
    from libsdr_tpu_torch.ops.iir import iir_first_order_varcoef

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 300)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, size=(2, 300)).astype(np.float32)
    y, _ = iir_first_order_varcoef(torch.from_numpy(x), torch.from_numpy(a),
                                   0.5, 0.25)
    jy, _ = jvar(jnp.asarray(x), jnp.asarray(a), 0.5, 0.25)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())


# -- the noise channels of the multi-mode bank ---------------------------------

def _rel(got, want, rows):
    got, want = np.asarray(got)[rows], np.asarray(want)[rows]
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_cli_band_noise_channels_part_only_in_the_recurrences(tmp_path):
    """Where the port and the JAX package first part on the channels of
    noise alone, on the CLI band of tests/test_torch_parallel.py (32
    channels at 768 kHz, the pattern pocsag,ax25,rtty,psk31, the WAV's
    int16 samples, the CLI's blocks of 12,000 frames, four blocks):

    1. K4's output (the Channelizer) within the reference's gate, 2e-5 of
       max |Y|;
    2. BPSK31's input (the PSK31 group's IQBaseBand) and the RTTY
       detector's input (USBDemod) on the noise channels within 1e-5 of
       their largest value (float32 FIRs summed in two orders);
    3. from the same input and carry, BPSK31's carried state step by step:
       it parts at the second step, by the phasor's last bit (numpy's
       float64 cos and sin rounded against XLA's float32 ones), and the
       carrier PLL, which locks to nothing on noise, drifts apart;
    4. so the decisions part, on noise channels only: BPSK31's bits from
       the same input, and the RTTY detector's symbols, each package on
       its own chain.

    Points 1-2 hold, so the noise channels' different text is a gap by
    design (ROADMAP.md, Queue 3).  Run with -s for the numbers."""
    import jax

    from libsdr_tpu.apps import multimode as jmm
    from libsdr_tpu_torch.apps import multimode as pmm
    from libsdr_tpu_torch.io import read_wav_iq, write_wav_iq
    from libsdr_tpu_torch.ops.psk31 import bpsk31_scan_plain
    from libsdr_tpu_torch.tools import ingest_bank as IB
    from libsdr_tpu_torch.tools.wideband_signals import mixed_band
    from tests.test_torch_parallel import ACTIVE, M_CLI, PATTERN

    m, fs, frames = M_CLI, M_CLI * 24_000.0, 12_000
    band = mixed_band(ACTIVE, m, "cpu", gen=torch.Generator().manual_seed(15),
                      sigma=0.02)
    scale = IB.unclipped_scale([Complex(band.re[None], band.im[None])], 0.9)
    write_wav_iq(str(tmp_path / "band.wav"), cplx.to_numpy(band) * scale,
                 int(fs))
    iq, _ = read_wav_iq(str(tmp_path / "band.wav"))
    b = m * frames
    iq = np.concatenate([iq, np.zeros((-len(iq)) % b, iq.dtype)])
    mode_map = {ch: PATTERN[ch % 4] for ch in range(m)}
    jchan, jsub, jgroups, _ = jmm._build_parts(fs, b, m, mode_map)
    pchan, psub, pgroups, _ = pmm._build_parts(fs, b, m, mode_map)
    noise = {mo: np.flatnonzero(~np.isin(pgroups[mo], list(ACTIVE)))
             for mo in ("psk31", "rtty")}
    # the group's stages before the recurrence: PSK31's IQBaseBand, RTTY's
    # USBDemod and FSKDetector
    stages = {"psk31": (jsub["psk31"].stages[:1], psub["psk31"].stages[:1]),
              "rtty": (jsub["rtty"].stages[:2], psub["rtty"].stages[:2])}
    jc, pc = jchan.init_carry(), pchan.init_carry("cpu")
    sc = {mo: ([s.init_carry() for s in j], [s.init_carry("cpu") for s in p])
          for mo, (j, p) in stages.items()}
    k4, front, psk_in, rtty_sym = 0.0, {}, [], [0, 0]

    def plain(v):
        return (jcplx.to_numpy(v) if hasattr(v, "re") and not isinstance(
            v, Complex) else cplx.to_numpy(v) if isinstance(v, Complex)
            else np.asarray(v))

    for i in range(len(iq) // b):
        blk = iq[i * b:(i + 1) * b]
        jc, jy = jchan.apply(jc, jcplx.as_block(blk))
        pc, py = pchan.apply(pc, cplx.as_block(blk))
        jy, py = plain(jy), plain(py)
        k4 = max(k4, _rel(py, jy, slice(None)))
        for mo, (js, ps) in stages.items():
            jo, po = jcplx.as_block(jy[pgroups[mo]]), cplx.as_block(
                py[pgroups[mo]])
            for n, (a, c) in enumerate(zip(js, ps)):
                sc[mo][0][n], jo = a.apply(sc[mo][0][n], jo)
                sc[mo][1][n], po = c.apply(sc[mo][1][n], po)
                if n == 0:
                    front[mo] = max(front.get(mo, 0.0),
                                    _rel(plain(po), plain(jo), noise[mo]))
            if mo == "psk31":
                psk_in.append(plain(po))
            else:
                apart = plain(po)[noise[mo]] != plain(jo)[noise[mo]]
                rtty_sym[0] += int(apart.sum())
                rtty_sym[1] += apart.size
    # 3-4: BPSK31 from the same input and carry, step by step
    jbp, pbp = jsub["psk31"].stages[1], psub["psk31"].stages[1]
    jstep = jax.jit(jbp.apply)
    jcar, pcar = jbp.init_carry(), pbp.init_carry("cpu")
    x = np.concatenate(psk_in, axis=1)
    first_state = first_bit = None
    decisions = [0, 0]
    for n in range(x.shape[1]):
        xn = x[:, n:n + 1]
        jcar, jout = jstep(jcar, jcplx.as_block(xn))
        pcar, pbits, pval = bpsk31_scan_plain(cplx.as_block(xn), pcar,
                                              **pbp.constants())
        host = interop.state_to_numpy(pcar)
        parted = [k for k, v in host.items()
                  if not np.array_equal(np.asarray(getattr(v, "re", v)),
                                        np.asarray(getattr(jcar[k], "re",
                                                           jcar[k])))]
        if first_state is None and parted:
            first_state = (n, sorted(parted))
        pv, jv = pval.numpy()[:, 0], np.asarray(jout.valid)[:, 0]
        pd = pbits.numpy()[:, 0] * pv
        jd = np.asarray(jout.data)[:, 0] * jv
        apart = ((pv != jv) | (pd != jd))[noise["psk31"]]
        decisions[0] += int(apart.sum())
        decisions[1] += int((pv | jv)[noise["psk31"]].sum())
        if first_bit is None and apart.any():
            first_bit = n
        # the active channel keeps the JAX decisions
        assert not ((pv != jv) | (pd != jd))[
            ~np.isin(np.arange(len(pv)), noise["psk31"])].any(), n
    p_gap = np.abs(host["P"] - np.asarray(jcar["P"]))[noise["psk31"]].max()
    print(f"\nnoise channels, port vs JAX on the CLI band: 1. K4 "
          f"{k4:.3e} of max |Y| (gate 2e-5); 2. BPSK31's input "
          f"{front['psk31']:.3e}, the RTTY detector's input "
          f"{front['rtty']:.3e} of their largest value (bound 1e-5); 3. "
          f"BPSK31's state from the same input parts at step "
          f"{first_state}, P apart by up to {p_gap:.3e} rad after "
          f"{x.shape[1]} steps; 4. BPSK31's decisions apart from step "
          f"{first_bit}: {decisions[0]} of {decisions[1]} emits on "
          f"{len(noise['psk31'])} noise channels; the RTTY detector's "
          f"symbols {rtty_sym[0]} of {rtty_sym[1]} on "
          f"{len(noise['rtty'])} noise channels")
    assert k4 < 2e-5
    assert front["psk31"] < 1e-5 and front["rtty"] < 1e-5
    assert first_state is not None
