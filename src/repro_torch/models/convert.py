"""Carry the reference's weights and compiled plans across to the port.

``params_from_reference`` takes the pytree that ``repro.models.transformer.
init_params`` returns, as numpy arrays, and lays it out as the port's
params: the reference stacks each pattern position's layers on a leading
repeat axis (``params["blocks"][i][...][r]``); the port keeps one dict per
layer, layer ``r * len(pattern) + i``. ``plans_from_reference`` does the
same for the plan tree ``repro.models.pim_compile`` returns, so the port's
forward can run on the reference's own per-site plans. With them both
implementations compute the same function in the parity tests.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import _check_supported


def _unstack(np_blocks: list, cfg: ArchConfig, leaf_fn) -> list:
    """Reference ``blocks`` (one subtree per pattern position, leaves
    stacked over repeats) -> one dict per layer, layer ``r * n_pat + i``."""
    n_pat = len(cfg.block_pattern)
    layers = [None] * cfg.n_layers
    for i, stack in enumerate(np_blocks):
        for r in range(cfg.n_repeats):
            layers[r * n_pat + i] = {
                group: {name: leaf_fn(leaf, r) for name, leaf in sub.items()}
                for group, sub in stack.items()}
    return layers


def params_from_reference(np_params: dict, cfg: ArchConfig,
                          device=None) -> dict:
    """Reference ``T.init_params`` pytree (numpy leaves) -> port params in
    ``cfg.dtype`` on ``device``. bf16 leaves pass through float32, which
    holds them exactly."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    return {"embed": {k: t(v) for k, v in np_params["embed"].items()},
            "layers": _unstack(np_params["blocks"], cfg,
                               lambda leaf, r: t(leaf[r])),
            "final_norm": {"scale": t(np_params["final_norm"]["scale"])}}


def plans_from_reference(np_plans: dict, cfg: ArchConfig,
                         device=None) -> dict:
    """Reference compiled plan tree (``{"embed": {"head": leaf}, "blocks":
    [{"core": ..., "ffn": ...}]}``, leaves stacked over repeats, numpy) ->
    the port's ``{"layers": [...], "head": leaf}`` on ``device``. Every
    leaf keeps its dtype (int8 planes, int32 centers and shifts, bool
    masks, float32 scales)."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def leaf(d: dict, r=None) -> dict:
        return {k: torch.from_numpy(np.array(v if r is None else v[r]))
                .to(dev) for k, v in d.items()}

    return {"layers": _unstack(np_plans["blocks"], cfg, leaf),
            "head": leaf(np_plans["embed"]["head"])}
