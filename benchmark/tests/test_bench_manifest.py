"""The manifest keeps the contract, every cell finds its files by name, and
a cell, a configuration, a kind of traffic and a metric are added by new
files and entries alone."""

from __future__ import annotations

import json
import re
import shutil
import time

from benchmark import harness, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj"
                   r"|head|expan|per_tok")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_manifest_keeps_the_contract():
    keeps_the_contract(manifest.ROOT)


def keeps_the_contract(root):
    man = manifest.load(root)
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(man)) <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    for path in man["paths"]:
        assert PATH.match(path) and not path.startswith("/")
        assert ".." not in path.split("/") and not path.endswith("_torch")
        assert (root / path).is_dir()
    assert 1 <= len(man["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in man["command"])
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert 2 + 14 * 24 * (man["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    for kind, keys in ENTRY_KEYS.items():
        assert 1 <= len(man[kind]) <= {"per_layer": 128, "end_to_end": 16}.get(
            kind, 24)
        names = [e["name"] for e in man[kind]]
        assert len(names) == len(set(names))
        for e in man[kind]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    cfgs = {c["name"]: c for c in man["configs"]}
    files = [c["file"] for c in cfgs.values()]
    assert len(files) == len(set(files))
    for c in cfgs.values():
        assert any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in man["paths"])
        data = json.loads((root / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in data, (c["name"], key)
            assert not WIDTH.search(key), (c["name"], key)
    wls = man["workloads"]
    assert {w["config"] for w in wls} == set(cfgs)
    pairs = [(w["config"], w["traffic"]) for w in wls]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) and NAME.match(w["traffic"])
               for w in wls)
    assert sum(w["chips"] == 4 for w in wls) <= max(1, len(wls) // 4)
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", [])) <= {w["name"] for w in wls}


def test_every_cell_finds_its_files():
    man = manifest.load()
    for w in man["workloads"]:
        cell = manifest.cell(w["name"])
        assert cell.config["system"]
        assert hasattr(cell.module("systems", cell.config["system"]),
                       "System")
        assert callable(cell.module("signals", cell.traffic["signal"]).make)
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.module("metrics", m["name"]).read)
        assert set(cell.config["limits"]) and cell.config["cost"]


def test_extra_cell_from_files_alone(tmp_path):
    """A new configuration, traffic mix, per-layer metric and cell, added
    as files and entries in a copy of the tree, run with no edit of a file
    that was there."""
    root = tmp_path / "tree"
    shutil.copytree(manifest.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest.load()
    cfg = json.loads((manifest.ROOT / "benchmark/configs/fm_bank_100.json")
                     .read_text())
    cfg["channels"] = 2
    (root / "benchmark/configs/fm_bank_2.json").write_text(json.dumps(cfg))
    # a new kind of traffic: its generator, found by the name it is given
    gen = root / "benchmark/signals/fm_tones_counted.py"
    gen.write_text((root / "benchmark/signals/fm_tones.py").read_text()
                   + "\nSEEDS = []\n_make = make\n\n\ndef make(*a):\n"
                   "    SEEDS.append(a[2])\n    return _make(*a)\n")
    tr = json.loads((manifest.ROOT / "benchmark/traffic/capture.json")
                    .read_text())
    tr.update(block_samples=4096, signal="fm_tones_counted")
    (root / "benchmark/traffic/tiny.json").write_text(json.dumps(tr))
    (root / "benchmark/metrics/blocks_done.py").write_text(
        "def read(ctx):\n    return float(ctx.window.blocks)\n")
    man["configs"].append({"name": "fm_bank_2", "source": "a test",
                           "file": "benchmark/configs/fm_bank_2.json",
                           "reduced": ["channels"], "why": "a test"})
    man["workloads"].append({"name": "fm_bank.tiny", "config": "fm_bank_2",
                             "traffic": "tiny", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "blocks_done", "unit": "count",
                             "better": "higher", "source": "program_counter",
                             "layer": "Entry", "moves": "throughput",
                             "workloads": ["fm_bank.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    keeps_the_contract(root)
    cell = manifest.cell("fm_bank.tiny", root=root)
    assert cell.config["channels"] == 2
    assert "blocks_done" in [m["name"] for m in cell.per_layer]
    r = harness.run_cell(cell, 3, 0.05, True, "cpu", time.perf_counter())
    assert r["correct"]
    assert manifest.load_module(gen).SEEDS == [3]
    assert r["metrics"]["blocks_done"]["value"] == r["attempted"] > 0
    assert "blocks_done" not in [
        m["name"] for m in manifest.cell("fm_bank.capture", root).per_layer]
