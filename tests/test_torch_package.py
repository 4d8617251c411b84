"""Package-level properties of the port: it never loads JAX, and its
on-card smoke run refuses to run, without printing a result, where there is
no CUDA device or no package beside it."""

import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "libsdr_tpu_torch"


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import libsdr_tpu_torch, libsdr_tpu_torch.core, "
            "libsdr_tpu_torch.ops, libsdr_tpu_torch.interop, "
            "libsdr_tpu_torch._build\n"
            "from libsdr_tpu_torch.ops import fm_fused, fir_fm, agc, utils\n"
            "from libsdr_tpu_torch.ops import fsk, pll, bitsync, afsk_fused\n"
            "from libsdr_tpu_torch.ops import channelizer, pfb, wideband_rx\n"
            "from libsdr_tpu_torch.ops import fftfilter, interpolate, psk31\n"
            "from libsdr_tpu_torch.ops.psk31 import bpsk31_scan, "
            "bpsk31_scan_plain\n"
            "from libsdr_tpu_torch.ops.iir import iir_first_order_varcoef\n"
            "import libsdr_tpu_torch.ops.fft\n"
            "from libsdr_tpu_torch.parallel import wideband, multimode, "
            "halo, mesh, distributed\n"
            "from libsdr_tpu_torch.core import ragged\n"
            "from libsdr_tpu_torch import decode\n"
            "from libsdr_tpu_torch.decode import aprs\n"
            "from libsdr_tpu_torch.apps import chains, rx, fm_rx, wavplay\n"
            "from libsdr_tpu_torch.apps import pocsag_rx, ax25_rx, rtty_rx, tx\n"
            "from libsdr_tpu_torch.apps import scanner, multimode, psk31_rx\n"
            "from libsdr_tpu_torch.apps import spectrum\n"
            "from libsdr_tpu_torch.tools import fir_paths, digital_profile, "
            "digital_signals, wideband_signals, dist_worker, "
            "dryrun_multichip, multimode_times, psk31_times\n"
            "from libsdr_tpu_torch import io\n"
            "from libsdr_tpu_torch.utils import options, logging\n"
            "from libsdr_tpu_torch import native\n"
            "from libsdr_tpu_torch.io import ingest, live\n"
            "from libsdr_tpu_torch.utils import http\n"
            "from libsdr_tpu_torch.apps import aprs_service\n"
            "import numpy as np\n"
            "from libsdr_tpu_torch.decode import pocsag_decode_bits\n"
            "pocsag_decode_bits(np.zeros(64, np.uint8))\n"
            "native.RingBuffer(64).close()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'libsdr_tpu' or "
            "m.startswith('libsdr_tpu.'))\n"
            "assert not bad, bad\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'sdr_native-' in maps\n"
            "assert '_sdr_native.so' not in maps, 'the JAX package .so'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|libsdr_tpu)(\.|\s|$)",
                     re.MULTILINE)
    sources = list(PKG.rglob("*.py"))
    offenders = [str(p) for p in sources if pat.search(p.read_text())]
    assert not offenders
    names = {str(p.relative_to(PKG)) for p in sources}
    assert {"native/__init__.py", "io/ingest.py", "io/live.py",
            "utils/http.py", "apps/aprs_service.py"} <= names
    # the native library is the port's own build, never the JAX package's
    assert not [str(p) for p in sources if "_sdr_native" in p.read_text()]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")


def _assert_refused(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_without_cuda():
    _no_cuda()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    _assert_refused(proc)


def test_chip_smoke_refuses_alone(tmp_path):
    _no_cuda()
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    _assert_refused(proc)
