"""Cells of the benchmark at a small size, for runs on the CPU: the same
traffic mixes and drivers, the model's widths and depth cut (the port's
configuration follows through its overrides)."""

from __future__ import annotations

import copy
import dataclasses

from bench.core import spec as specs

SMALL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 256}


def small_cell(name: str, traffic: dict | None = None, **limits):
    cell = specs.cell(name)
    config = copy.deepcopy(cell.config)
    model = dict(config["model"], **SMALL)
    if config["model"]["n_heads"] == config["model"]["n_kv_heads"]:
        model["n_kv_heads"] = model["n_heads"]  # multi-head stays so
    config["model"] = model
    config["overrides"] = {k: v for k, v in model.items()
                           if k not in ("head_dim", "qkv_bias", "causal",
                                        "activation", "dtype")}
    config["overrides"]["head_dim"] = model["head_dim"]
    tr = copy.deepcopy(cell.traffic)
    tr.update(traffic or {})
    return dataclasses.replace(cell, config=config, traffic=tr,
                               limits=dict(cell.limits, **limits))
