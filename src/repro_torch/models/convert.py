"""Carry the reference's weights across to the port.

``params_from_reference`` takes the pytree that ``repro.models.transformer.
init_params`` returns, as numpy arrays, and lays it out as the port's
params: the reference stacks each pattern position's layers on a leading
repeat axis (``params["blocks"][i][...][r]``); the port keeps one dict per
layer, layer ``r * len(pattern) + i``. With it both implementations compute
the same function in the parity tests.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import _check_supported


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

    n_pat = len(cfg.block_pattern)
    layers = [None] * cfg.n_layers
    for i, stack in enumerate(np_params["blocks"]):
        for r in range(cfg.n_repeats):
            layers[r * n_pat + i] = {
                group: {name: t(leaf[r]) for name, leaf in sub.items()}
                for group, sub in stack.items()}
    return {"embed": {k: t(v) for k, v in np_params["embed"].items()},
            "layers": layers,
            "final_norm": {"scale": t(np_params["final_norm"]["scale"])}}
