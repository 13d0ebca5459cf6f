"""The benchmark's cells and metrics, each found by its name.

``BENCHMARK.json`` at the checkout's root declares every cell
(``workloads``: a configuration, a traffic mix, the chips) and every
metric. Each name leads to a file of its own, so a cell, a configuration,
a traffic mix, a driver kind or a metric is added by adding files:

  bench/configs/<config>.json       model sizes, cut and PIM settings
  bench/traffic/<traffic>.json      traffic parameters; names its driver
  bench/drivers/<kind>.py           one way of driving the program
  bench/limits/<workload>.json      the limits of a cell's compared numbers
  bench/e2e/<metric>.py             an end-to-end metric's computation
  bench/metrics/<metric>.py         a per-layer metric's reader
  bench/reference/<reference>.py    a configuration's plain reference
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple       # the spec's end-to-end metrics this cell reports
    per_layer: tuple        # the spec's per-layer metrics read in this cell


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str) -> bool:
    """Whether ``workload`` reports an end-to-end ``metric``: it lists the
    cell, or it lists none (every cell)."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, root: Path = ROOT, spec: dict | None = None) -> Cell:
    """The workload ``name`` and the files it names; raises KeyError for a
    name the spec lacks."""
    spec = load_spec(root) if spec is None else spec
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    [cfg_entry] = [c for c in spec["configs"] if c["name"] == w["config"]]
    e2e = tuple(m for m in spec["end_to_end"] if reports(m, name))
    moved = {m["name"] for m in e2e}
    per_layer = tuple(
        m for m in spec["per_layer"]
        if (name in m["workloads"] if "workloads" in m
            else m["moves"] in moved))
    bench = root / "bench"
    return Cell(name=name, chips=int(w["chips"]),
                config=read_json(root / cfg_entry["file"]),
                traffic=read_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(bench / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def load_module(path: Path):
    """Import the Python file ``path`` as a module of its own (a metric's
    file name may hold dots, which ``import`` cannot name)."""
    mod_name = "bench_file_" + re.sub(r"\W", "_", str(
        path.relative_to(path.parents[1])))
    loader = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod


def driver(kind: str, root: Path = ROOT):
    return load_module(root / "bench" / "drivers" / f"{kind}.py")


def e2e_module(name: str, root: Path = ROOT):
    return load_module(root / "bench" / "e2e" / f"{name}.py")


def reader(name: str, root: Path = ROOT):
    return load_module(root / "bench" / "metrics" / f"{name}.py")


def reference(name: str, root: Path = ROOT):
    return load_module(root / "bench" / "reference" / f"{name}.py")
