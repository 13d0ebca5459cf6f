"""BENCHMARK.json keeps to its contract, and every file it names is found
by name."""

import json
import re

import pytest

from bench.core import spec as specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = specs.load_spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert [m["name"] for m in SPEC["end_to_end"]][0] == "setup_s"
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    cell = specs.cell(workload)
    assert specs.driver(cell.traffic["driver"]).Driver
    assert specs.reference(cell.config["reference"]).DenseReference
    assert {"top_gap", "converts_diff", "spec_failures"} <= set(cell.limits)
    assert cell.end_to_end[0]["name"] == "setup_s"
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end:
        assert callable(specs.e2e_module(m["name"]).compute)
    for m in cell.per_layer:
        assert callable(specs.reader(m["name"]).read)
        if "workloads" not in m:
            continue
        moved = {e["name"] for e in cell.end_to_end}
        assert m["moves"] in moved, (m["name"], workload)


def test_config_files_state_their_cut():
    for c in SPEC["configs"]:
        cfg = specs.read_json(specs.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["source"].startswith(c["source"])
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for k in ("overrides", "assumed", "deployment", "pim", "model"):
            assert k in cfg
        assert set(cfg["pim"]) >= {"pim_mode", "pim_weight_slicing",
                                   "pim_speculation", "pim_adc_bits"}
