"""The port's sharded paths (``libsdr_tpu_torch.parallel``: halo, mesh,
wideband, multimode; ``apps/multimode --pattern/--bf16``) on the CPU,
against their n == 1 runs and against the JAX package on its 8-device
virtual CPU mesh (``tests/conftest.py``).

The multi-rank cases run ``libsdr_tpu_torch.tools.dryrun_multichip`` (and
``tools.dist_worker``) as 2 and 4 gloo ranks with a ``file://`` store:
every build function there is held against its n == 1 run in the same rank, bit
for bit where the JAX package's own tests are bit for bit
(``tests/test_parallel.py``: the wideband, scanner and multimode steps;
``shard_map_pipeline_step``), within their bounds elsewhere (the halo FIR
1e-5, the GSPMD pipeline 2e-4).  Against JAX: the FM outputs by the angle
bounds of ``tests/test_torch_wideband.py`` (median 5e-5, 99th percentile
1e-3 rad: the angle of a near-zero z on random data is amplified), the AM
bank with its AGC by ``tests/test_torch_analog.py``'s (rtol 2e-4, atol
2e-5), the FIR by 1e-5, the decoders by their decodes.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from libsdr_tpu.core import cplx as jcplx
from libsdr_tpu_torch.core import cplx
from libsdr_tpu_torch.core.stream import ConfigError
from libsdr_tpu_torch.tools import dryrun_multichip as DR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEDIAN, P99 = 5e-5, 1e-3
PATTERN = ("pocsag", "ax25", "rtty", "psk31")
TIMEOUT = 240


def _angle_err(a, b):
    return np.abs(np.remainder(a - b + np.pi, 2 * np.pi) - np.pi)


def _angle_ok(got, want):
    err = _angle_err(np.asarray(got, np.float64), np.asarray(want,
                                                             np.float64))
    return np.median(err) < MEDIAN and np.percentile(err, 99) < P99


def _jmesh(n, name="d"):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


@pytest.fixture(scope="module", params=[2, 4])
def dryrun(request, tmp_path_factory):
    """The dry run on n gloo ranks: (n, {label head: line}, rank files)."""
    out = tmp_path_factory.mktemp(f"dryrun{request.param}")
    rc, log0, logs = DR.launch(request.param, device="cpu", out=str(out),
                               timeout=TIMEOUT)
    assert rc == 0, "\n".join(logs)
    lines = {}
    for line in log0.splitlines():
        head = line.split("(", 1)[1].split(":", 1)[0]
        lines[head] = line
    ranks = [dict(np.load(out / f"rank{r}.npz"))
             for r in range(request.param)]
    return request.param, lines, ranks


@pytest.mark.parametrize("label", ["GSPMD fm bank", "halo spans a shard",
                                   "halo FIR", "wideband P=3",
                                   "wideband P=8", "scanner (FM + ASK + PLL)",
                                   "multi-mode bank", "shard_map fm bank",
                                   "shard_map am bank"])
def test_sharded_step_matches_one_rank(dryrun, label):
    """Every build function on n ranks against its n == 1 run in the same rank:
    bit for bit but the halo FIR and the GSPMD pipeline, which hold their
    JAX tests' bounds (and are bit for bit on the CPU too)."""
    n, lines, _ = dryrun
    line = lines[label]
    assert line.startswith("dryrun_multichip OK"), line
    assert f"{n} ranks on cpu" in line
    assert "bit for bit True" in line, line


def test_fir_overlap_save_sharded_matches_jax(dryrun):
    """The time-sharded overlap-save FIR (three carried blocks) against the
    JAX package's one-device fir_overlap_save."""
    from libsdr_tpu.ops import firdesign
    from libsdr_tpu.ops.fir import fir_overlap_save

    n, _, ranks = dryrun
    got = np.concatenate([r["fir"].reshape(3, -1) for r in ranks],
                         axis=1).reshape(-1)
    taps = firdesign.lowpass(33, 4000, 48000).astype(np.float32)
    b = 1024
    x = np.random.default_rng(1234).normal(size=3 * b).astype(np.float32)
    tail, want = jax.numpy.zeros(32, jax.numpy.float32), []
    for i in range(3):
        y, tail = fir_overlap_save(taps, jax.numpy.asarray(
            x[i * b:(i + 1) * b]), tail)
        want.append(np.asarray(y))
    np.testing.assert_allclose(got, np.concatenate(want), atol=1e-5)


def test_shard_pipeline_step_matches_jax(dryrun):
    """shard_pipeline_step's FM bank (16 ch x 2048, IQBaseBand(order 16,
    decim 4) -> FMDemod -> FMDeemph) on the port's ('ch', 'time') mesh
    against the JAX package's GSPMD step on the same mesh shape."""
    from libsdr_tpu import Pipeline, StreamSpec
    from libsdr_tpu.ops import FMDeemph, FMDemod, IQBaseBand
    from libsdr_tpu.parallel.mesh import make_mesh, shard_pipeline_step

    n, _, ranks = dryrun
    n_ch, fs, b = 16, 64_000.0, 2048
    got = np.zeros((n_ch, b // 4), np.float32)
    for r in ranks:
        c0, c1, t0, t1 = r["gspmd_idx"]
        got[c0:c1, t0:t1] = r["gspmd"]
    p = Pipeline([IQBaseBand(fc=fs / 8, width=fs / 5, order=16, decim=4,
                             design="textbook"), FMDemod(), FMDeemph()])
    p.bind(StreamSpec(np.complex64, fs, b, channels=(n_ch,)))
    n_time = 2
    step, place, carry = shard_pipeline_step(
        p, make_mesh(n_channel=n // n_time, n_time=n_time))
    x = DR._complex(np.random.default_rng(1234), (n_ch, b))
    _, want = step(carry, place(x))
    assert _angle_ok(got, np.asarray(want))


@pytest.mark.parametrize("name", ["fm", "am"])
def test_shard_map_pipeline_step_matches_jax(dryrun, name):
    """shard_map_pipeline_step's channelwise banks (64 ch x 4096) against
    the JAX package's shard_map step over as many devices."""
    from libsdr_tpu import Pipeline, StreamSpec
    from libsdr_tpu.ops import (AGC, AMDemod, FMDeemph, FMDemod,
                                IQBaseBand)
    from libsdr_tpu.parallel.mesh import shard_map_pipeline_step

    n, _, ranks = dryrun
    n_ch, fs, b = 64, 192_000.0, 4096
    got = np.concatenate([r[f"shard_map_{name}"] for r in ranks])
    front = IQBaseBand(fc=24e3, width=12.5e3, order=48, out_rate=48e3,
                       design="textbook")
    stages = ([front, FMDemod(), FMDeemph()] if name == "fm" else
              [front, AMDemod(), AGC(tau=0.03)])
    p = Pipeline(stages)
    p.bind(StreamSpec(np.complex64, fs, b, channels=(n_ch,)))
    step, place, carry = shard_map_pipeline_step(p, _jmesh(n, "ch"))
    x = DR._complex(np.random.default_rng(1234), (n_ch, b))
    _, want = step(carry, place(x))
    want = np.asarray(want)
    if name == "fm":
        assert _angle_ok(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_wideband_two_ranks_match_jax(dryrun):
    """The sharded wideband step (16 ch, P = 8, two blocks) against the JAX
    package's sharded step on as many devices."""
    from libsdr_tpu.parallel.wideband import build_wideband_step

    n, _, ranks = dryrun
    got = np.concatenate([r["wideband"] for r in ranks])
    m, block = 16, 16 * 8 * 16
    rng = np.random.default_rng(3)
    step, init, place = build_wideband_step(_jmesh(n), m, block)
    c, want = init(), []
    for _ in range(2):
        c, y = step(c, place(DR._complex(rng, block)))
        want.append(np.asarray(y))
    assert got.shape == (m, 2 * block // m)
    assert _angle_ok(got, np.concatenate(want, axis=-1))


# -- n == 1: the build functions and the app against build_bank and JAX -------------

def _blocks(m, t_full, seed=7, k=2, scale=0.3):
    rng = np.random.default_rng(seed)
    return [DR._complex(rng, m * t_full, scale) for _ in range(k)]


def test_multimode_step_one_rank_is_build_bank():
    """build_multimode_step at n == 1 gives build_bank's Ragged outputs bit
    for bit (both through channelize_local), over chained blocks."""
    from libsdr_tpu_torch.apps import multimode
    from libsdr_tpu_torch.parallel.multimode import build_multimode_step

    m, t_full = 32, 576
    fs, block = m * 24_000.0, m * t_full
    mode_map = {ch: PATTERN[ch % 4] for ch in range(m)}
    step, init, place, groups = build_multimode_step(m, block, fs, PATTERN,
                                                     device="cpu")
    bstep, binit, bgroups = multimode.build_bank(fs, block, m, mode_map)
    c, bc = init(), binit("cpu")
    for x in _blocks(m, t_full):
        c, o = step(c, place(x))
        bc, bo = bstep(bc, cplx.as_block(x))
        assert set(o) == set(bo)
        for mode in o:
            np.testing.assert_array_equal(groups[mode], bgroups[mode])
            assert torch.equal(o[mode].valid, bo[mode].valid)
            assert torch.equal(o[mode].data * o[mode].valid,
                               bo[mode].data * bo[mode].valid)


def test_multimode_step_one_rank_matches_jax():
    """The port's n == 1 multimode step against the JAX package's on
    make_mixed_band (tests/test_apps.py): the channelized bank of each
    block within 2e-5 of its largest |Y| (tests/test_torch_wideband.py's
    channelizer bound), and every active channel decodes what the JAX
    step's bits decode."""
    from libsdr_tpu.parallel import wideband as jwb
    from libsdr_tpu.parallel.multimode import build_multimode_step as jbuild
    from libsdr_tpu_torch.apps.multimode import decode_mode_bits
    from libsdr_tpu_torch.core.ragged import Ragged, compact
    from libsdr_tpu_torch.parallel import wideband as pwb
    from libsdr_tpu_torch.parallel.multimode import build_multimode_step
    from tests.test_apps import make_mixed_band

    m, p, t_full = 32, 8, 4608
    fs, block = m * 24_000.0, m * t_full
    active = {4: "pocsag", 9: "ax25", 14: "rtty", 19: "psk31"}
    wide = make_mixed_band(active, m)
    wide = np.concatenate([wide, np.zeros(-len(wide) % block,
                                          np.complex64)])
    step, init, place, groups = build_multimode_step(m, block, fs, PATTERN,
                                                     device="cpu")
    jstep, jinit, jplace, jgroups = jbuild(_jmesh(1), m, block, fs, PATTERN)
    taps3 = pwb._taps(m, p)
    c, jc = init(), jinit()
    acc = {mode: ([], [], [], []) for mode in PATTERN}
    for i in range(len(wide) // block):
        x = wide[i * block:(i + 1) * block]
        hist = c[0]
        y = cplx.to_numpy(pwb.channelize_segment(cplx.as_block(x), hist,
                                                 taps3, m, p))
        jy = jcplx.to_numpy(jwb.channelize_segment(
            jcplx.as_block(x), jcplx.as_block(cplx.to_numpy(hist)),
            jax.numpy.asarray(taps3), m, p))
        assert np.abs(y - jy).max() <= 2e-5 * np.abs(jy).max()
        c, o = step(c, place(x))
        jc, jo = jstep(jc, jplace(x))
        for mode in PATTERN:
            for lst, v in zip(acc[mode], (o[mode].data, o[mode].valid,
                                          jo[mode].data, jo[mode].valid)):
                lst.append(np.asarray(v))
    for ch, mode in active.items():
        row = list(groups[mode]).index(ch)
        assert list(jgroups[mode]).index(ch) == row
        d, v, jd, jv = (np.concatenate([a[row] for a in lst])
                        for lst in acc[mode])
        got = decode_mode_bits(mode, compact(Ragged(d, v)))
        assert _summary({ch: (mode, got)}) == _summary(
            {ch: (mode, _jax_decode(mode, jd, jv))})


def _jax_decode(mode, d, v):
    from libsdr_tpu.apps.multimode import decode_mode_bits
    from libsdr_tpu.core.ragged import Ragged, compact

    return decode_mode_bits(mode, compact(Ragged(d, v)))


def _summary(found):
    """{channel: (mode, comparable decode)} of either package's bank."""
    out = {}
    for ch, (mode, dec) in found.items():
        if mode == "pocsag":
            out[int(ch)] = (mode, [[msg.address, msg.as_text()]
                                   for msg in dec])
        elif mode == "ax25":
            out[int(ch)] = (mode, [[str(f), a is not None] for f, a in dec])
        else:
            out[int(ch)] = (mode, dec.strip())
    return out


def test_scan_multimode_sharded_matches_jax():
    """apps/multimode.scan_multimode_sharded at n == 1 on make_mixed_band
    against the JAX package's (on its 8 devices): the four active channels
    decode their messages, the same as JAX's."""
    from libsdr_tpu.apps import multimode as jmm
    from libsdr_tpu_torch.apps import multimode
    from tests.test_apps import make_mixed_band

    m = 32
    fs = m * 24_000.0
    active = {4: "pocsag", 9: "ax25", 14: "rtty", 19: "psk31"}
    wide = make_mixed_band(active, m)
    got = _summary(multimode.scan_multimode_sharded(
        wide, fs, m, PATTERN, block=m * 4608, device="cpu"))
    want = _summary(jmm.scan_multimode_sharded(
        wide, fs, m, PATTERN, block=m * 4608, devices=jax.devices()))
    assert {ch: got[ch] for ch in active} == {ch: want[ch] for ch in active}
    assert got[4][1][0][0] == 99 and got[4][1][0][1].startswith("MIXED")
    assert "MULTI" in got[14][1] and "cq tpu" in got[19][1]


# -- the CLI: --pattern, --bf16 --raw, two ranks -------------------------------

M_CLI = 32
ACTIVE = {4: "pocsag", 9: "ax25", 14: "rtty", 19: "psk31", 25: "ax25",
          30: "rtty"}


@pytest.fixture(scope="module")
def band_files(tmp_path_factory):
    """tools/wideband_signals.mixed_band (channels band-limited, with noise:
    nothing decodes off its channel) scaled to a peak of 0.9 full scale,
    as a WAV and as a u8 wire file (tools/ingest_bank.quantize_u8).  Both
    files clip nothing: the band's peak, 3.05, would clip in either (and
    so would tests/test_parallel.py's fixed factor of 0.45)."""
    from libsdr_tpu_torch.core.cplx import Complex
    from libsdr_tpu_torch.io import write_wav_iq
    from libsdr_tpu_torch.tools import ingest_bank as IB
    from libsdr_tpu_torch.tools.wideband_signals import mixed_band

    d = tmp_path_factory.mktemp("band")
    gen = torch.Generator().manual_seed(15)
    band = mixed_band(ACTIVE, M_CLI, "cpu", gen=gen, sigma=0.02)
    x = Complex(band.re[None], band.im[None])
    scale = IB.unclipped_scale([x], 0.9)
    IB.quantize_u8(x, scale).numpy().tofile(d / "wire.u8")
    write_wav_iq(str(d / "band.wav"), cplx.to_numpy(band) * scale,
                 M_CLI * 24_000)
    return d


def _marks(found):
    """{channel: the channel numbers its messages carry}, for the channels
    whose messages carry one (the noise channels' RTTY and PSK31 decoders
    print noise, which carries none)."""
    from libsdr_tpu_torch.tools.wideband_signals import mixed_marks

    marks = {ch: mixed_marks(mo, dec) for ch, (mo, dec) in found.items()}
    return {ch: v for ch, v in marks.items() if v}


def _same_as_jax(got, want):
    """The active channels decode what the JAX CLI decodes, and nothing
    decodes off its channel."""
    got, want = _summary(got), _summary(want)
    assert {ch: got.get(ch) for ch in ACTIVE} == \
        {ch: want.get(ch) for ch in ACTIVE}


CLI = ["--channels", str(M_CLI), "--pattern", ",".join(PATTERN)]


def test_multimode_cli_pattern_matches_jax(band_files):
    """multimode --file --pattern: the JAX CLI's decodes with the same
    arguments on the active channels, each its own message, and no message
    off its channel."""
    from libsdr_tpu.apps import multimode as jmm
    from libsdr_tpu_torch.apps import multimode

    args = ["--file", str(band_files / "band.wav")] + CLI
    got = multimode.main(args + ["--device", "cpu"])
    _same_as_jax(got, jmm.main(args))
    assert _marks(got) == {ch: {ch} for ch in ACTIVE}


def test_multimode_cli_bf16_raw_matches_jax(band_files):
    """multimode --raw (u8) --bf16 --pattern: the u8 wire as bf16 planes
    into the channelizer; the JAX CLI's decodes on the active channels,
    each its own message, none off its channel."""
    from libsdr_tpu.apps import multimode as jmm
    from libsdr_tpu_torch.apps import multimode

    args = ["--raw", str(band_files / "wire.u8"), "--rate",
            str(M_CLI * 24_000), "--bf16"] + CLI
    got = multimode.main(args + ["--device", "cpu"])
    _same_as_jax(got, jmm.main(args))
    assert _marks(got) == {ch: {ch} for ch in ACTIVE}


@pytest.mark.parametrize("wire", ["wav", "bf16"])
def test_multimode_cli_pattern_two_ranks(band_files, tmp_path, wire,
                                         capsys):
    """The CLI itself as torchrun starts it on two ranks (WORLD_SIZE, RANK
    and LOCAL_RANK in the environment; the group's rendezvous a
    ``file://`` store by SDR_INIT_METHOD, no port): it joins the group,
    gathers the one-process decodes, rank 0 alone prints them, and both
    ranks leave the group and exit with 0."""
    from libsdr_tpu_torch.apps import multimode

    if wire == "wav":
        args = ["--file", str(band_files / "band.wav")] + CLI
    else:
        args = ["--raw", str(band_files / "wire.u8"), "--rate",
                str(M_CLI * 24_000), "--bf16"] + CLI
    args += ["--device", "cpu"]
    n = 2
    procs = [subprocess.Popen(
        [sys.executable, "-m", "libsdr_tpu_torch.apps.multimode"] + args,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                 WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                 SDR_INIT_METHOD="file://" + str(tmp_path / "store")))
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][1]}"
    capsys.readouterr()
    multimode.main(args)
    want = capsys.readouterr().out
    assert "ch    4" in want
    assert outs[0][0] == want and outs[1][0] == ""


def test_multimode_cli_refusals(band_files, capsys):
    from libsdr_tpu_torch.apps import multimode

    wav = ["--file", str(band_files / "band.wav"), "--device", "cpu"]
    for args, msg in (
            (wav, "exactly one of --map / --pattern"),
            (wav + ["--map", "1:rtty", "--pattern", "rtty"],
             "exactly one of --map / --pattern"),
            (wav + ["--pattern", "rtty,fax"], "--pattern modes must be"),
            (wav + ["--map", "1:rtty", "--bf16"], "--bf16 runs the sharded"),
            (wav + ["--pattern", "rtty", "--bf16"],
             "--bf16 needs a --raw uint8")):
        with pytest.raises(SystemExit, match=msg):
            multimode.main(args)


# -- contracts without a process group ----------------------------------------

def test_steps_without_a_group_run_one_device():
    from libsdr_tpu_torch.parallel import make_mesh
    from libsdr_tpu_torch.parallel.distributed import (global_mesh,
                                                       rank_device)
    from libsdr_tpu_torch.parallel.multimode import build_multimode_step
    from libsdr_tpu_torch.parallel.wideband import build_wideband_step

    assert make_mesh() is None and global_mesh() is None
    with pytest.raises(ConfigError, match="needs a process group"):
        make_mesh(2, 1)
    assert rank_device(None, "cpu") == torch.device("cpu")
    with pytest.raises(ConfigError, match="pass a mesh"):
        build_wideband_step(16, 16 * 32, device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="mode_pattern length 3"):
        build_multimode_step(32, 32 * 576, 32 * 24e3, PATTERN[:3],
                             device="cpu")
    with pytest.raises(ValueError, match="P \\+ 1"):
        build_wideband_step(16, 16 * 8, device="cpu")
