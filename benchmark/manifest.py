"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file the
manifest gives, and a traffic mix, read from ``benchmark/traffic/<name>.json``
and made by the generator ``benchmark/signals/<signal>.py`` it names.  The
configuration's ``system`` names the module that runs the program,
``benchmark/systems/<system>.py``; each metric, end-to-end or per-layer, is
read by ``benchmark/metrics/<name>.py``.  A cell, a configuration, a traffic
mix or a metric is added by adding its files and its entry: nothing here
lists them.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # the manifest's metric entries this cell reports
    per_layer: list
    root: Path

    def module(self, kind: str, name: str):
        """``benchmark/<kind>/<name>.py`` of this manifest's tree."""
        return load_module(self.root / "benchmark" / kind / f"{name}.py")


@functools.lru_cache(maxsize=None)
def load_module(path: Path):
    """The module at ``path``, loaded once."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    name = "benchmark._found." + "_".join(path.with_suffix("").parts[-2:])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic read."""
    root = Path(root)
    man = load(root)
    wl = {w["name"]: w for w in man["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = wl[name]
    cfg = {c["name"]: c for c in man["configs"]}[w["config"]]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"]
           if _reports(m, name) and m["moves"] in moved]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per, root)
