"""``multimode --live --pattern`` over the ranks of a group, on the CPU:
two gloo ranks started as ``torchrun`` starts them (tests/
test_torch_parallel.py's harness, a ``file://`` store), rank 0 reading
the band of ``band_files`` from a FIFO and broadcasting it block by block
(``parallel/halo.py::broadcast_chunks``).  Rank 0 prints what the
one-device run prints from the same bytes, bit for bit, and its active
channels decode what the JAX package's ``scan_multimode_sharded`` over 2
CPU devices decodes from them; rank 1 prints nothing; both exit 0: with
and without ``--bf16``, when the wire ends mid-block and when
``--live-timeout`` ends it while the writer holds the FIFO open.  Every
subprocess and thread has a deadline.  Two ranks cannot share one card
(NCCL refuses it), so the group is tested over gloo only."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests.test_torch_parallel import (ACTIVE, CLI, M_CLI, PATTERN, ROOT,
                                       _summary, band_files)  # noqa: F401

RATE = M_CLI * 24_000
BLOCK_BYTES = 2 * M_CLI * 12_000     # the bank's block at this rate, u8
DEADLINE = 120


def _fifo_writer(path, data: bytes, hold: float = 0.0):
    """A thread that writes ``data`` into the FIFO, keeps it open ``hold``
    seconds more, then closes it."""
    def run():
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            time.sleep(hold)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _decodes(out: str) -> str:
    """A run's printed decodes: its output without the live line (whose
    rate is the wall clock's)."""
    return "".join(ln for ln in out.splitlines(keepends=True)
                   if not ln.startswith("live:"))


def _live_line(out: str) -> str:
    (line,) = [ln for ln in out.splitlines() if ln.startswith("live:")]
    return line.split(" dropped")[0]


def _jax_found(data: np.ndarray, tmp_path, bf16: bool):
    """JAX's scan_multimode_sharded over 2 CPU devices on the same bytes
    (its file stream converts and pads as its live stream does)."""
    import jax
    import jax.numpy as jnp

    from libsdr_tpu.apps import multimode as jmm
    from libsdr_tpu.io import ingest

    cap = tmp_path / "jax.u8"
    data.tofile(cap)
    if bf16:
        def blocks(b):
            return ingest.stream_raw_iq_bf16(str(cap), b)
    else:
        def blocks(b):
            return ingest.stream_raw_iq(str(cap), b)
    return jmm.scan_multimode_sharded(
        None, float(RATE), M_CLI, PATTERN, devices=jax.devices()[:2],
        plane_dtype=jnp.bfloat16 if bf16 else None, blocks=blocks)


@pytest.mark.parametrize("case", ["f32", "bf16", "mid_block", "timeout"])
def test_multimode_live_pattern_two_ranks(band_files, tmp_path, case,  # noqa: F811
                                          capsys):
    from libsdr_tpu_torch.apps import multimode

    data = np.fromfile(band_files / "wire.u8", np.uint8)
    if case == "mid_block":          # one block and a half, and a sample
        data = data[:BLOCK_BYTES + BLOCK_BYTES // 2 + 2]
    assert len(data) % BLOCK_BYTES     # every case ends inside a block
    bf16 = case in ("bf16", "timeout")
    hold = 4.0 if case == "timeout" else 0.0
    args = ["--rate", str(RATE), "--live-timeout",
            "1" if case == "timeout" else "20"] + CLI + ["--device", "cpu"]
    args += ["--bf16"] if bf16 else []

    # two ranks, rank 0 on the FIFO
    fifo = str(tmp_path / "group.fifo")
    os.mkfifo(fifo)
    n = 2
    procs = [subprocess.Popen(
        [sys.executable, "-m", "libsdr_tpu_torch.apps.multimode",
         "--live", f"fifo://{fifo}"] + args,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                 WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                 SDR_INIT_METHOD="file://" + str(tmp_path / "store")))
        for r in range(n)]
    writer = _fifo_writer(fifo, data.tobytes(), hold)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    writer.join(DEADLINE)
    assert not writer.is_alive()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][1]}"
    assert outs[1][0] == ""

    # the one-device run on the same bytes
    solo = str(tmp_path / "solo.fifo")
    os.mkfifo(solo)
    writer = _fifo_writer(solo, data.tobytes(), hold)
    capsys.readouterr()
    found = multimode.main(["--live", f"fifo://{solo}"] + args)
    writer.join(DEADLINE)
    want = capsys.readouterr().out
    assert _decodes(outs[0][0]) == _decodes(want)
    assert _live_line(outs[0][0]) == _live_line(want) == (
        f"live: {len(data)} bytes in, 0")

    # JAX's sharded bank on 2 devices
    got, jwant = _summary(found), _summary(_jax_found(data, tmp_path, bf16))
    assert {ch: got.get(ch) for ch in ACTIVE} == \
        {ch: jwant.get(ch) for ch in ACTIVE}
    if case != "mid_block":
        assert all(ch in got for ch in ACTIVE), sorted(got)
