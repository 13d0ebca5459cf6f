"""The control, on the card at each cell's own size: the reference put in
the program's place one precision lower (int4 codes in every projection,
``DenseReference(bits=4)``) has to come out not correct, while the program
on the same seeds comes out correct. Each run prints its readings as one
JSON line (run with ``-s``)."""

import json

import pytest

import bench.run as R
from bench.core import spec as specs

SEEDS = (2 ** 31 + 101, 3 ** 20 + 7, 5 ** 13 + 11)
WORKLOADS = [w["name"] for w in specs.load_spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload, card):
    seconds = specs.load_spec()["run_seconds"]
    limit = specs.cell(workload).limits["top_gap"]
    readings = []
    for seed in SEEDS:
        out = R.run_cell(workload, seed, seconds, False, control=True)
        n = out["numbers"]
        readings.append(n)
        print(json.dumps({"workload": workload, "seed": seed,
                          "top_gap": n["top_gap"],
                          "control_top_gap": n["control_top_gap"],
                          "checked_tokens": n["checked_tokens"],
                          "converts_diff": n["converts_diff"],
                          "spec_failures": n["spec_failures"]}),
              flush=True)
    for n in readings:
        assert n["top_gap"] <= limit < n["control_top_gap"], n
