"""Finds what belongs to a cell by its name, so that a later change adds a
cell, a configuration, a traffic mix or a metric as files and entries and
edits none:

- ``BENCHMARK.json`` (the repository's root): the cells, configurations
  and metrics;
- ``configs/<config>.json``: a configuration's sizes (the entry's
  ``file``), whose ``system`` names the adapter ``systems/<system>.py``;
- ``reference/<config>.py``: the configuration's plain reference;
- ``traffic/<mix>.json``: a traffic mix's parameters;
- ``cells/<workload>.json``: a cell's limits for ``correct``;
- ``metrics/<metric>.py``: the reader of one metric.

Every function takes the folder that holds ``BENCHMARK.json`` as ``root``
(the repository's root by default), so a test can point it at a copy.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

REPO = Path(__file__).resolve().parents[2]
HERE = "benchmark"


def load_benchmark(root: Path = REPO) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = REPO) -> dict:
    """The configuration's file, with its entry's ``name`` and ``source``."""
    for c in bench["configs"]:
        if c["name"] == name:
            out = json.loads((Path(root) / c["file"]).read_text())
            out.update(name=c["name"], source=c["source"])
            return out
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = REPO) -> dict:
    return json.loads((Path(root) / HERE / "traffic" / f"{name}.json").read_text())


def cell(name: str, root: Path = REPO) -> dict:
    return json.loads((Path(root) / HERE / "cells" / f"{name}.json").read_text())


def metrics_of(bench: dict, workload_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    whose ``workloads`` name it, and those without the key whose moved (or,
    end to end, own) metric the cell reports."""
    w = workload_name
    e2e = [m for m in bench["end_to_end"] if w in m.get("workloads", [w])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (w in m["workloads"] if "workloads" in m else m["moves"] in names)]


def _load(path: Path) -> ModuleType:
    """A module of this folder by its path (names may hold dots and
    dashes), loaded once per process."""
    path = path.resolve()
    key = f"{HERE}._by_path.{hashlib.sha256(str(path).encode()).hexdigest()[:16]}"
    if key in sys.modules:
        return sys.modules[key]
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def system(name: str, root: Path = REPO) -> ModuleType:
    return _load(Path(root) / HERE / "systems" / f"{name}.py")


def reference(config_name: str, root: Path = REPO) -> ModuleType:
    return _load(Path(root) / HERE / "reference" / f"{config_name}.py")


def metric(name: str, root: Path = REPO) -> ModuleType:
    return _load(Path(root) / HERE / "metrics" / f"{name}.py")
