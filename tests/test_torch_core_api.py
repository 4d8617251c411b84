"""The port's core API beyond the main path against the JAX package, on the
same numpy inputs, on the CPU (``device="cpu"``):

* ``Lambda``, ``Proxy``, ``Tee`` and ``Combine`` (tests/test_core.py's
  cases), within 1e-6;
* ``run_pipeline(chunks_per_dispatch=K)`` at K = 1, 3 and 7 against JAX's
  (3e-7, as tests/test_core.py allows), the port at K = 3 and 7 bit for bit
  against K = 1, and the ragged ASKDetector -> BitStream chain bit for bit;
  ``Pipeline.compile_chunked`` in both modes against K single steps;
* ``reblock``, ``Throughput``, the debug sinks' text, ``StageTimer`` and
  ``trace``;
* checkpoint / resume bit-identical, ``run_resumable``, and a checkpoint
  that the JAX package wrote continued by the port.

The chunked dispatch through a CUDA graph is held on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libsdr_tpu as J
import libsdr_tpu_torch as P
from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core import ConfigError

CPU = "cpu"


def _x(rng, n, kind):
    if kind == "complex":
        return (rng.normal(size=n) + 1j * rng.normal(size=n)
                ).astype(np.complex64)
    return rng.normal(size=n).astype(np.float32)


# -- Lambda, Proxy, Tee, Combine --------------------------------------------

@pytest.mark.parametrize("kind", ["real", "complex"])
def test_lambda_proxy_pipeline_matches_jax(rng, kind):
    """Scale -> Lambda(x + 1) -> Proxy through run_pipeline, as
    tests/test_core.py::test_pipeline_step_and_driver (the Lambda's
    function on tensors, or on both planes of a Complex)."""
    from libsdr_tpu.core.block import Lambda as JLambda, Proxy as JProxy
    from libsdr_tpu.ops.utils import Scale as JScale
    from libsdr_tpu_torch.core import Lambda
    from libsdr_tpu_torch.core.block import Proxy
    from libsdr_tpu_torch.ops import Scale

    dt = np.complex64 if kind == "complex" else np.float32
    x = _x(rng, 4 * 256, kind)
    jp = J.Pipeline([JScale(0.5), JLambda(lambda v: v + 1.0), JProxy()])
    jp.bind(J.StreamSpec(dt, 8000, 256))
    _, want = J.core.run_pipeline(jp, J.core.stream_blocks(x, 256))

    pp = P.Pipeline([Scale(0.5), Lambda(lambda v: v + 1.0, name="plus1"),
                     Proxy()])
    pp.bind(P.StreamSpec(dt, 8000, 256))
    assert repr(pp.stages[1]) == "<Lambda:plus1>"
    _, got = P.core.run_pipeline(pp, P.core.stream_blocks(x, 256),
                                 device=CPU)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got, 0.5 * x + 1.0, atol=1e-6)


def test_lambda_spec_fn_and_proxy_after_autocast(rng):
    """Lambda's spec function, and tests/test_core.py::
    test_autocast_and_proxy."""
    from libsdr_tpu.core.block import Proxy as JProxy
    from libsdr_tpu.ops.utils import AutoCast as JAutoCast
    from libsdr_tpu_torch.core import Lambda
    from libsdr_tpu_torch.core.block import Proxy
    from libsdr_tpu_torch.ops import AutoCast

    lam = Lambda(lambda v: v[..., ::2],
                 spec_fn=lambda s: s.with_(block_size=s.block_size // 2,
                                           sample_rate=s.sample_rate / 2))
    out = lam.bind(P.StreamSpec(np.float32, 8000, 16))
    assert out.block_size == 8 and out.rate_hz == 4000
    x = rng.integers(-32768, 32767, 16).astype(np.int16)
    jp = J.Pipeline([JAutoCast(), JProxy()])
    jp.bind(J.StreamSpec(jnp.int16, 8000, 16))
    _, want = jp.apply(jp.init_carry(), jnp.asarray(x))
    pp = P.Pipeline([AutoCast(), Proxy()])
    assert pp.bind(P.StreamSpec(np.int16, 8000, 16)).dtype == torch.float32
    _, got = pp.apply(pp.init_carry(CPU), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_tee_combine_matches_jax(rng, kind):
    """Fan-out and join (tests/test_core.py::test_tee_combine_join): a Tee
    of a FIR and a scale, stacked by Combine on a channel axis; the Tee's
    carry made on the device asked for."""
    from libsdr_tpu.core.graph import Combine as JCombine, Tee as JTee
    from libsdr_tpu.ops import FIRFilter as JFIR
    from libsdr_tpu.ops.utils import Scale as JScale
    from libsdr_tpu_torch.core.graph import Combine, Tee
    from libsdr_tpu_torch.ops import FIRFilter, Scale

    dt = np.complex64 if kind == "complex" else np.float32
    x = _x(rng, 2 * 64, kind)
    outs = {}
    for pkg, tee, comb in (
            (J, JTee([JFIR(order=9, kind="lowpass", fu=1000.0),
                      JScale(-1.0)]), JCombine(2)),
            (P, Tee([FIRFilter(order=9, kind="lowpass", fu=1000.0),
                     Scale(-1.0)]), Combine(2))):
        spec = pkg.StreamSpec(dt, 8000, 64)
        tee.bind(spec)
        assert comb.bind(tee.branch_specs[0]).channels == (2,)
        if pkg is J:
            c = tee.init_carry()
        else:
            c = tee.init_carry(CPU)
            assert c[0][0].device.type == "cpu"
        ys = []
        for k in range(2):
            xb = x[k * 64:(k + 1) * 64]
            blk = (jcplx.as_block(xb) if pkg is J
                   else cplx.as_block(xb, torch.float32, CPU))
            c, pair = tee.apply(c, blk)
            _, stacked = comb.apply((), pair)
            ys.append(jcplx.to_numpy(stacked) if pkg is J
                      else cplx.to_numpy(stacked))
        outs[pkg.__name__] = np.concatenate(ys, -1)
    got, want = outs["libsdr_tpu_torch"], outs["libsdr_tpu"]
    assert got.shape == (2, 128)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[1], -x, atol=1e-6)
    with pytest.raises(ValueError):
        Combine(3).apply((), (torch.zeros(4), torch.zeros(4)))


# -- chunked dispatch and the in-flight window --------------------------------

def _fir_pipe(pkg):
    p = pkg.Pipeline([pkg.ops.FIRFilter(order=17, kind="lowpass", fu=1500.0),
                      pkg.ops.Scale(0.5)])
    p.bind(pkg.StreamSpec(np.float32, 8000, 256))
    return p


def test_chunks_per_dispatch_matches_jax_and_k1(rng):
    """run_pipeline at K = 1, 3 (two groups and a trailing block) and 7
    (one dispatch) over 7 blocks with a stateful FIR carry: each within
    3e-7 of JAX's run at the same K, and the port's K = 3 and 7 bit for bit
    equal to its K = 1 (tests/test_core.py::
    test_chunks_per_dispatch_matches_single)."""
    x = rng.normal(size=7 * 256).astype(np.float32)
    got = {}
    for k in (1, 3, 7):
        _, want = J.core.run_pipeline(_fir_pipe(J),
                                      J.core.stream_blocks(x, 256),
                                      chunks_per_dispatch=k)
        sunk = []
        _, got[k] = P.core.run_pipeline(
            _fir_pipe(P), P.core.stream_blocks(x, 256), sink=sunk.append,
            device=CPU, chunks_per_dispatch=k)
        np.testing.assert_allclose(got[k], np.asarray(want), atol=3e-7)
        assert len(sunk) == 7 and all(s.shape == (256,) for s in sunk)
        np.testing.assert_array_equal(np.concatenate(sunk), got[k])
    np.testing.assert_array_equal(got[3], got[1])
    np.testing.assert_array_equal(got[7], got[1])
    with pytest.raises(ValueError):
        P.core.run_pipeline(_fir_pipe(P), [], device=CPU,
                            chunks_per_dispatch=0)


def test_chunks_per_dispatch_ragged_matches_jax(rng):
    """The ragged ASKDetector -> BitStream chain through the same knob: K =
    3 bit for bit equal to K = 1, and to the JAX package's bits."""
    x = rng.normal(size=7 * 256).astype(np.float32)

    def run(pkg, k):
        p = pkg.Pipeline([pkg.ops.ASKDetector(),
                          pkg.ops.BitStream(1000.0, mode="normal")])
        p.bind(pkg.StreamSpec(np.float32, 8000, 256))
        kw = {} if pkg is J else dict(device=CPU)
        _, bits = pkg.core.run_pipeline(p, pkg.core.stream_blocks(x, 256),
                                        chunks_per_dispatch=k, **kw)
        return np.asarray(bits)

    want = run(J, 1)
    assert len(want) > 0
    np.testing.assert_array_equal(run(P, 1), want)
    np.testing.assert_array_equal(run(P, 3), run(P, 1))


def test_compile_chunked_modes_match_single_steps(rng):
    """'unroll' (tuples of blocks) and 'scan' (K-stacked tensors) against K
    single steps on a stateful carry, as tests/test_core.py::
    test_compile_chunked_modes_agree; on the CPU both loop over apply, so
    bit for bit."""
    p = P.Pipeline([P.ops.FIRFilter(order=17, kind="lowpass", fu=1500.0)])
    p.bind(P.StreamSpec(np.float32, 8000, 256))
    xs = [torch.from_numpy(rng.normal(size=256).astype(np.float32))
          for _ in range(3)]
    c = p.init_carry(CPU)
    step = p.compile()
    singles = []
    for x in xs:
        c, y = step(c, x)
        singles.append(y)
    cu, ys_u = p.compile_chunked("unroll")(p.init_carry(CPU), tuple(xs))
    cs, ys_s = p.compile_chunked("scan")(p.init_carry(CPU), torch.stack(xs))
    assert isinstance(ys_u, tuple) and ys_s.shape == (3, 256)
    for i in range(3):
        assert torch.equal(singles[i], ys_u[i])
        assert torch.equal(singles[i], ys_s[i])
    assert torch.equal(cu[0][0], c[0][0]) and torch.equal(cs[0][0], c[0][0])
    assert p.compile_chunked("unroll") is p.compile_chunked("unroll")
    with pytest.raises(ValueError):
        p.compile_chunked("vmap")


def test_compile_chunked_scan_of_complex_blocks(rng):
    """'scan' over K-stacked Complex blocks gives K-stacked Complex outputs
    equal to the single steps."""
    p = P.Pipeline([P.ops.FIRFilter(order=9, kind="lowpass", fu=1500.0)])
    p.bind(P.StreamSpec(np.complex64, 8000, 128, channels=(2,)))
    x = (rng.normal(size=(3, 2, 128)) + 1j * rng.normal(size=(3, 2, 128))
         ).astype(np.complex64)
    xs = cplx.as_block(x, torch.float32, CPU)
    c = p.init_carry(CPU)
    _, ys = p.compile_chunked("scan")(c, xs)
    for i in range(3):
        c, y = p.apply(c, xs[i])
        assert torch.equal(ys.re[i], y.re) and torch.equal(ys.im[i], y.im)


# -- reblock, Throughput, debug sinks, profiling ------------------------------

def test_reblock_matches_jax():
    from libsdr_tpu.core.runtime import reblock as jreblock
    from libsdr_tpu_torch.core.runtime import reblock
    blocks = [np.arange(5.0), np.arange(5.0, 12.0), np.arange(12.0, 13.0)]
    out = list(reblock(iter(blocks), 4))
    np.testing.assert_array_equal(np.concatenate(out), np.arange(12.0))
    assert all(b.shape[-1] == 4 for b in out)
    for a, b in zip(out, jreblock(iter(blocks), 4)):
        np.testing.assert_array_equal(a, b)
    two = [np.arange(6.0).reshape(2, 3), np.arange(6.0, 10.0).reshape(2, 2)]
    np.testing.assert_array_equal(np.concatenate(list(reblock(two, 2)), -1),
                                  np.concatenate(two, -1)[:, :4])


def test_throughput_drop_metrics():
    """tests/test_live.py::test_throughput_drop_metrics; update_from takes
    any object with a total bytes_dropped."""
    from libsdr_tpu_torch.core.runtime import Throughput
    th = Throughput()
    th.add(900)
    th.add_dropped(100)
    assert th.drop_fraction == pytest.approx(0.1)
    assert "dropped" in th.report() and th.msps > 0
    th2 = Throughput()
    th2.add(900)
    th2.update_from(SimpleNamespace(bytes_in=2000, bytes_dropped=200))
    assert th2.dropped == 100
    assert th2.drop_fraction == pytest.approx(0.1)
    assert Throughput().drop_fraction == 0.0


def test_debug_sinks_print_what_jax_prints(capsys):
    """DebugStore keeps the blocks; TextDump and BitDump (dense and ragged)
    print the JAX package's text."""
    from libsdr_tpu.ops import debug as jdebug
    from libsdr_tpu_torch.core.ragged import Ragged
    from libsdr_tpu_torch.ops import BitDump, DebugStore, TextDump

    store = DebugStore()
    store(np.arange(4.0))
    store(np.arange(4.0) + 4)
    np.testing.assert_array_equal(store.concatenated(), np.arange(8.0))
    assert DebugStore(keep_all=False).blocks == []
    ragged = Ragged(np.array([1, 0, 1, 1], np.uint8),
                    np.array([True, False, True, True]))
    texts = []
    for mod in (jdebug, P.ops.debug):
        mod.TextDump()(np.asarray([1.5, 2.5, 1e-7]))
        mod.TextDump(fmt="{:.2f}")(np.asarray([[1.0], [2.0]]))
        mod.BitDump()(np.asarray([1, 0, 1]))
        mod.BitDump()(ragged)
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]
    assert "1.5 2.5" in texts[1] and "1 0 1" in texts[1]
    assert TextDump is P.ops.debug.TextDump and BitDump is P.ops.BitDump


def test_stage_timer_and_trace(tmp_path):
    """The host stage timer and torch.profiler tracing
    (tests/test_core.py::test_profiling_helpers)."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.utils.profiling import StageTimer, trace

    t = StageTimer()
    for _ in range(2):
        with t.region("work") as sync:
            y = torch.ones((64, 64)) @ torch.ones((64, 64))
            sync(y)
            sync((Complex(y, y), {"k": [y]}))
    rep = t.report()
    assert rep["work"]["calls"] == 2 and rep["work"]["total_s"] > 0
    d = tmp_path / "prof"
    with trace(str(d)):
        y = torch.ones((64, 64)) @ torch.ones((64, 64))
    files = [f for _, _, fs in os.walk(d) for f in fs]
    assert files, "profiler produced no trace files"


# -- checkpoint / resume -------------------------------------------------------

def _ck_pipe(pkg, kind="real"):
    dt = np.complex64 if kind == "complex" else np.float32
    p = pkg.Pipeline([pkg.ops.FIRFilter(order=31, kind="lowpass", fu=4000)])
    p.bind(pkg.StreamSpec(dt, 48000, 256))
    return p


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_checkpoint_resume_bit_identical(tmp_path, rng, kind):
    """Restart from block 4 continues bit-identically
    (tests/test_core.py::test_checkpoint_resume)."""
    from libsdr_tpu_torch.core.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    x = _x(rng, 8 * 256, kind)
    blk = [cplx.as_block(x[i * 256:(i + 1) * 256], torch.float32, CPU)
           for i in range(8)]
    p = _ck_pipe(P, kind)
    carry = p.init_carry(CPU)
    outs = []
    for i in range(8):
        carry, y = p.apply(carry, blk[i])
        outs.append(cplx.to_numpy(y))
        if i == 3:
            save_checkpoint(str(tmp_path / "ck.npz"), carry, i + 1,
                            meta={"who": "test"})
    p2 = _ck_pipe(P, kind)
    carry2, pos, meta = load_checkpoint(str(tmp_path / "ck.npz"),
                                        p2.init_carry(CPU))
    assert pos == 4 and meta == {"who": "test"}
    outs2 = []
    for i in range(pos, 8):
        carry2, y = p2.apply(carry2, blk[i])
        outs2.append(cplx.to_numpy(y))
    np.testing.assert_array_equal(np.concatenate(outs2, -1),
                                  np.concatenate(outs, -1)[..., 4 * 256:])
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "ck.npz"), ())


def test_checkpoint_widens_bfloat16_leaves(tmp_path):
    """bfloat16 leaves are stored as float32 (npz has no bfloat16) and come
    back in the live leaf's dtype, bit for bit."""
    from libsdr_tpu_torch.core.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    carry = (cplx.Complex(torch.randn(3, 5).bfloat16(),
                          torch.randn(3, 5).bfloat16()),
             {"n": torch.tensor(7, dtype=torch.int32)})
    save_checkpoint(str(tmp_path / "b.npz"), carry, 2)
    with np.load(str(tmp_path / "b.npz")) as z:
        assert z["leaf_0"].dtype == np.float32
    like = (cplx.zeros((3, 5), torch.bfloat16),
            {"n": torch.zeros((), dtype=torch.int32)})
    back, pos, _ = load_checkpoint(str(tmp_path / "b.npz"), like)
    assert pos == 2 and back[0].re.dtype == torch.bfloat16
    assert torch.equal(back[0].re, carry[0].re)
    assert torch.equal(back[0].im, carry[0].im)
    assert torch.equal(back[1]["n"], carry[1]["n"])


def test_checkpoint_written_by_jax_continues_in_the_port(tmp_path, rng):
    """A checkpoint that the JAX package's save_checkpoint wrote after block
    4 of test_core.py's FIRFilter pipeline loads into the port, which
    continues within FIR_REL (1e-5, tests/test_torch_fir_mxu.py's FIRFilter
    parity bound) of the JAX package's own continuation."""
    from libsdr_tpu.core.checkpoint import save_checkpoint as jsave
    from libsdr_tpu_torch.core.checkpoint import load_checkpoint
    x = rng.normal(size=8 * 256).astype(np.float32)
    jp = _ck_pipe(J)
    c = jp.init_carry()
    want = []
    for i in range(8):
        c, y = jp.apply(c, jnp.asarray(x[i * 256:(i + 1) * 256]))
        if i == 3:
            jsave(str(tmp_path / "jax.npz"), c, i + 1)
        if i >= 4:
            want.append(np.asarray(y))
    pp = _ck_pipe(P)
    carry, pos, _ = load_checkpoint(str(tmp_path / "jax.npz"),
                                    pp.init_carry(CPU))
    assert pos == 4
    got = []
    for i in range(pos, 8):
        carry, y = pp.apply(carry, torch.from_numpy(
            x[i * 256:(i + 1) * 256]))
        got.append(y.numpy())
    got, want = np.concatenate(got), np.concatenate(want)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_run_resumable_resumes(tmp_path, rng):
    """run_resumable checkpoints every N blocks and, restarted on its
    checkpoint, continues where it stopped: its sink's blocks and final
    carry equal one uninterrupted run's."""
    from libsdr_tpu_torch.core.checkpoint import run_resumable
    x = rng.normal(size=8 * 256).astype(np.float32)
    path = str(tmp_path / "run.npz")

    def blocks(upto):
        return lambda start: (x[i * 256:(i + 1) * 256]
                              for i in range(start, upto))

    full = []
    c_full, n = run_resumable(_ck_pipe(P), blocks(8), str(tmp_path / "a.npz"),
                              checkpoint_every=2, sink=full.append,
                              device=CPU)
    assert n == 8
    part = []
    _, n1 = run_resumable(_ck_pipe(P), blocks(5), path, checkpoint_every=2,
                          sink=part.append, device=CPU)
    c2, n2 = run_resumable(_ck_pipe(P), blocks(8), path, checkpoint_every=2,
                           sink=part.append, device=CPU)
    assert (n1, n2) == (5, 8) and len(part) == 8
    np.testing.assert_array_equal(np.concatenate(part), np.concatenate(full))
    assert torch.equal(c2[0][0], c_full[0][0])


def test_chunked_step_refuses_host_values_in_the_carry():
    """A CUDA graph cannot update host values: a carry that holds one is
    refused with ConfigError naming the pipeline, before any capture."""
    from libsdr_tpu_torch.core.graph import _GraphChunk
    p = P.Pipeline([P.ops.Scale(2.0)], name="hosty")
    p.bind(P.StreamSpec(np.float32, 8000, 16))
    with pytest.raises(ConfigError, match="hosty"):
        _GraphChunk(p, (3,), (torch.zeros(16),), torch.device("cpu"))


def test_graph_warm_up_leaves_the_launch_counts_alone():
    """The counted kernel entries, and the snapshot and restore the graph's
    warm-up uses so that only the capture moves the counts."""
    from libsdr_tpu_torch.core.graph import (_counts, _restore_counts,
                                             kernel_entries)
    from libsdr_tpu_torch.ops import fir_fm as F
    names = [e.__name__ for e in kernel_entries()]
    assert names[:5] == ["fir_fm_exact", "fir_exact", "fir_am_exact",
                         "fir_usb_exact", "fir_afsk_exact"]
    assert {"pll", "pll_bank", "pfb_mxu", "fir_mxu"} <= set(names)
    saved = _counts()
    n, tc = F.fir_fm_exact.launches, F.fir_fm_exact.routes["tc"]
    F.fir_fm_exact.launches += 3
    F.fir_fm_exact.routes["tc"] += 3
    _restore_counts(saved)
    assert F.fir_fm_exact.launches == n
    assert F.fir_fm_exact.routes["tc"] == tc
