"""Multi-process runs of the port's sharded wideband receiver
(``libsdr_tpu_torch.parallel.distributed``), the counterparts of
``tests/test_distributed.py``: a real two-process gloo group (a
``file://`` store under the test's directory, no port) through
``libsdr_tpu_torch.tools.dist_worker``, with host-sharded ingest, and the
lost-host restart from sharded checkpoints under ``run_supervised``; then
the single-process contracts of placement, checkpoints and the supervisor.

Each rank's output is held against the port's one-process run bit for
bit, and against the JAX package's sharded step (on as many of its
virtual devices) by the angle bounds of ``tests/test_torch_wideband.py``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from libsdr_tpu_torch.core.stream import ConfigError
from libsdr_tpu_torch.parallel import distributed as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEDIAN, P99 = 5e-5, 1e-3
M = 8


def _env():
    return dict(os.environ, PYTHONPATH=ROOT)


def _worker(mode, store, n, rank, *extra):
    return [sys.executable, "-m", "libsdr_tpu_torch.tools.dist_worker", mode,
            "--store", store, "--nproc", str(n), "--rank", str(rank),
            "--device", "cpu", "--timeout", "120"] + list(extra)


def _rows(paths):
    rows = {}
    for path in paths:
        with np.load(path) as z:
            for k in z.files:
                rows[int(k.split("_")[1])] = z[k]
    return np.concatenate([rows[r] for r in sorted(rows)], axis=0)


def _one_rank(n_proc, blocks):
    """The port's one-process wideband step over ``blocks``; the last
    output."""
    from libsdr_tpu_torch.parallel.wideband import build_wideband_step

    block = M * n_proc * 32
    step, init, place = build_wideband_step(M, block, device="cpu")
    c, y = init(), None
    for x in blocks:
        c, y = step(c, place(x))
    return y.numpy()


def _jax_sharded(n_dev, blocks):
    from libsdr_tpu.parallel.wideband import build_wideband_step

    block = M * n_dev * 32
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("d",))
    step, init, place = build_wideband_step(mesh, M, block)
    c, y = init(), None
    for x in blocks:
        c, y = step(c, place(x))
    return np.asarray(y)


def _angle_ok(got, want):
    err = np.abs(np.remainder(got - want + np.pi, 2 * np.pi) - np.pi)
    return np.median(err) < MEDIAN and np.percentile(err, 99) < P99


def test_two_process_wideband_with_host_sharded_ingest(tmp_path):
    """Two gloo ranks run two chained wideband steps, each reading only its
    own half of the capture (the worker checks every index its fetch is
    asked for); the rows of both equal the one-process run bit for bit and
    the JAX package's two-device run within the angle bounds."""
    n = 2
    store = "file://" + str(tmp_path / "store")
    outs = [str(tmp_path / f"rows{r}.npz") for r in range(n)]
    procs = [subprocess.Popen(_worker("ingest", store, n, r, "--out",
                                      outs[r]),
                              cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r]}"
        assert f"rank {r} OK" in logs[r]
    got = _rows(outs)
    block = M * n * 32
    rng = np.random.default_rng(99)
    x = (rng.normal(size=block) + 1j * rng.normal(size=block)).astype(
        np.complex64)
    assert got.shape == (M, block // M)
    np.testing.assert_array_equal(got, _one_rank(n, [x, x]))
    assert _angle_ok(got, _jax_sharded(n, [x, x]))


def test_lost_host_detection_and_restart_from_checkpoint(tmp_path):
    """Rank 1 of a two-process job dies at block 2; run_supervised sees the
    lost host, kills the survivor and relaunches; both ranks resume from
    their sharded checkpoints (blocks 0-1 ran only in incarnation 0, 2-3
    only in incarnation 1), and the last block's output equals an
    uninterrupted one-process run bit for bit."""
    n = 2
    wd = str(tmp_path)

    def make_cmd(coordinator, pid, incarnation):
        return _worker("failover", coordinator, n, pid, "--incarnation",
                       str(incarnation), "--workdir", wd, "--crash-at", "2",
                       "--crash-rank", "1")

    restarts = D.run_supervised(
        make_cmd, n, max_restarts=2, timeout_s=240, store_dir=wd,
        popen_kwargs=dict(cwd=ROOT, env=_env(), stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL))
    assert restarts == 1
    for r in range(n):
        lines = (tmp_path / f"log_p{r}.txt").read_text().splitlines()
        want = ["inc0 block0", "inc0 block1", "inc1 block2", "inc1 block3"]
        assert lines == want, (r, lines)
    got = _rows([tmp_path / f"out_p{r}.npz" for r in range(n)])
    block = M * n * 32
    rng = np.random.default_rng(5)
    blocks = [(rng.normal(size=block) + 1j * rng.normal(size=block)
               ).astype(np.complex64) for _ in range(4)]
    np.testing.assert_array_equal(got, _one_rank(n, blocks))


def test_run_supervised_gives_up_after_its_budget(tmp_path):
    calls = []

    def make_cmd(coordinator, pid, incarnation):
        calls.append((coordinator, pid, incarnation))
        return [sys.executable, "-c", "import sys; sys.exit(3)"]

    with pytest.raises(RuntimeError, match="failed 2 times"):
        D.run_supervised(make_cmd, 2, max_restarts=1, poll_s=0.05,
                         store_dir=str(tmp_path))
    assert [c[2] for c in calls] == [0, 0, 1, 1]
    assert calls[0][0] != calls[2][0]           # a new store a launch
    assert all(c[0].startswith("file://") for c in calls)


def test_run_supervised_default_store_is_temporary():
    """Without a store directory each launch gets a new ``file://`` store
    in a temporary directory, which is gone when the job ends."""
    calls = []

    def make_cmd(coordinator, pid, incarnation):
        calls.append(coordinator)
        return [sys.executable, "-c", "import sys; sys.exit(0)"]

    assert D.run_supervised(make_cmd, 2, poll_s=0.05) == 0
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0].startswith("file://")
    assert not os.path.exists(os.path.dirname(calls[0][len("file://"):]))


def test_sharded_checkpoint_round_trip(tmp_path):
    """A rank's carry (bf16 history, float32 seed, a dict) saved and
    restored in the live dtypes; a file of another rank is refused."""
    from libsdr_tpu_torch.core import cplx

    carry = (cplx.Complex(torch.randn(8, 4).bfloat16(),
                          torch.randn(8, 4).bfloat16()),
             {"phase": torch.randn(4), "n": torch.arange(4)})
    path = str(tmp_path / "ck.npz")
    D.save_sharded_checkpoint(path, carry, 7)
    like = (cplx.zeros((8, 4), torch.bfloat16, "cpu"),
            {"phase": torch.zeros(4), "n": torch.zeros(4, dtype=torch.int64)})
    got, pos = D.load_sharded_checkpoint(path, like)
    assert pos == 7 and got[0].re.dtype == torch.bfloat16
    assert torch.equal(got[0].re, carry[0].re)
    assert torch.equal(got[1]["phase"], carry[1]["phase"])
    assert torch.equal(got[1]["n"], carry[1]["n"])
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.dumps({"position": 7, "n_leaves": 4, "rank": 1,
                         "world": 2})
    arrays["__header__"] = np.frombuffer(header.encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ConfigError, match="rank 1 of 2"):
        D.load_sharded_checkpoint(path, like)


def test_placement_without_a_group():
    """One process: init_multihost is a no-op that names the device, the
    shard is the whole array, the rank feeds every channel."""
    assert D.init_multihost(num_processes=1, device="cpu") == \
        torch.device("cpu")
    x = (np.arange(8) + 1j * np.arange(8)).astype(np.complex64)
    got = D.place_global(x, None, ("d",), device="cpu")
    assert torch.equal(got.re, torch.arange(8, dtype=torch.float32))
    assert D.shard_index((4, 8), None, ("d", None)) == (slice(0, 4),
                                                        slice(0, 8))
    seen = []
    got = D.place_global_ingest((8,), None, ("d",),
                                lambda idx: seen.append(idx) or x[idx],
                                device="cpu")
    assert seen == [(slice(0, 8),)] and got.shape == (8,)
    assert D.process_local_batch(16) == slice(0, 16)
