"""The system under test: the port's configuration, kernels and PIM
compile, as a configuration file states them.

This and the drivers are the only files of the benchmark that import the
port (``repro_torch``); the plain reference imports none of it.
"""

from __future__ import annotations

import dataclasses
import time

import torch

# the configuration file's ``model`` keys and the port's ArchConfig fields
# that must agree with them (head_dim through ``resolved_head_dim``)
MODEL_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab_size", "qkv_bias", "causal", "activation",
                "rope_theta", "norm_eps", "dtype")
PIM_FIELDS = ("pim_mode", "pim_weight_slicing", "pim_speculation",
              "pim_adc_bits")
# the kernel that each PIM mode's projections launch
KERNELS = {"exact": "fused_spec_crossbar", "fast": "centered_int8_matmul"}


def program_config(config: dict):
    """The port's ``ArchConfig``: its registered configuration with the
    file's ``overrides`` and PIM settings. Raises where it departs from the
    sizes the reference is handed (``model``), or from the plain dense
    attention model the reference computes."""
    from repro_torch import configs
    pim = {k: (tuple(v) if isinstance(v, list) else v)
           for k, v in config["pim"].items() if k in PIM_FIELDS}
    cfg = dataclasses.replace(configs.get(config["program_config"]),
                              **config["overrides"], **pim)
    model = config["model"]
    bad = {k: (getattr(cfg, k), model[k]) for k in MODEL_FIELDS
           if getattr(cfg, k) != model[k]}
    if cfg.resolved_head_dim != model["head_dim"]:
        bad["head_dim"] = (cfg.resolved_head_dim, model["head_dim"])
    plain = dict(block_pattern=("attn",), n_experts=0, qk_norm=False,
                 input_mode="tokens", kv_cache_dtype=model["dtype"],
                 pim_crossbar_backend="ideal")
    bad.update({k: (getattr(cfg, k), v) for k, v in plain.items()
                if getattr(cfg, k) != v})
    if bad:
        raise ValueError(f"{config['name']}: the port's config departs from "
                         f"the file (port, file): {bad}")
    return cfg


def build_kernels(cfg, device) -> None:
    """Build (or find built) the kernel the projections launch, so that
    nothing compiles inside the window."""
    if torch.device(device).type != "cuda" or cfg.pim_mode not in KERNELS:
        return
    from repro_torch.kernels import build
    build.build([KERNELS[cfg.pim_mode]])


def compile_plans(params: dict, cfg, calib) -> tuple[dict, float]:
    """``compile_pim_params`` on the calibration tokens: the plans and
    its wall seconds, ending in a synchronize."""
    from repro_torch.models import pim_compile
    t0 = time.perf_counter()
    compiled = pim_compile.compile_pim_params(params, cfg, calib)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return compiled.plans, time.perf_counter() - t0


def launches() -> dict:
    from repro_torch.kernels import ops
    return dict(ops.launch_counts())


def stats_sink():
    """The PIM layer's work-stats collector (its simulated counters)."""
    from repro_torch.models import layers
    return layers.collect_pim_stats()


def fold_stats(sink: list) -> None:
    """Sum a collector's entries on the device into one, in place, so a
    long window does not hold a stats object per projection."""
    from repro_torch.models import layers
    if len(sink) > 1:
        sink[:] = [layers.pim_stats_device_totals(sink)]


def stats_totals(sink: list) -> dict:
    from repro_torch.models import layers
    return layers.pim_stats_totals(sink)
