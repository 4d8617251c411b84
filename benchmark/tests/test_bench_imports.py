"""No run loads JAX or the JAX package: the check compares whole
top-level names, and a run of every cell passes it."""

from __future__ import annotations

import subprocess
import sys
import types
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]


def test_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "libsdr_tpu_torch_like",
                        types.ModuleType("x"))
    for name in ("jax", "jaxlib", "flax", "libsdr_tpu"):
        assert name not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "libsdr_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax", "libsdr_tpu"]


def test_a_run_of_every_cell_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import run_tiny\n"
        "from benchmark import manifest, run\n"
        "for w in manifest.load()['workloads']:\n"
        "    assert run_tiny(w['name'], trace=True)['correct'], w\n"
        "assert 'libsdr_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
