"""AdamW and its learning-rate schedules, plain PyTorch.

Port of ``repro.train.optimizer``. Moments can be kept in bf16
(``state_dtype='bfloat16'``), which takes the bytes per parameter from
2+4+4+4 to 2+2+2+2. The casts are the reference's: the clip multiplies in
float32 and casts back to the gradient's dtype; the update computes in
float32, writes each parameter in its own dtype and the moments in
``state_dtype``; ``step`` is an int32 count.

Unlike the reference's, ``apply_updates`` updates the parameters and the
moments in place, under ``torch.no_grad()``, as the port's decode state is
updated in place: a step at full width would otherwise hold two copies of
the weights and of both moments. It returns the same objects it was given.
The state's logical shardings (``state_specs``) mirror the parameters';
placed as DTensors (``repro_torch.dist.place``), the update runs on them
unchanged, each rank on its shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.train import _tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 scalar on the step's device: linear warmup, then cosine decay
    to 0 at ``total_steps`` (or constant)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * frac))


def init_state(cfg: AdamWConfig, params: Any) -> dict:
    """Zero moments in ``state_dtype`` beside each parameter, and a zero
    int32 step on the parameters' device."""
    dt = getattr(torch, cfg.state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": _tree.tree_map(zeros, params),
            "v": _tree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_tree.leaves(params)[0].device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sums = [torch.sum(torch.square(g.to(torch.float32)))
            for g in _tree.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """(the tree scaled to global norm ``max_norm`` if above it, its norm
    before)."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return _tree.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), gn


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: dict) -> tuple[Any, dict, dict]:
    """One AdamW step, in place. Returns (params, state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))
    for p, g, m, v in zip(*(_tree.leaves(t) for t in
                            (params, grads, state["m"], state["v"])),
                          strict=True):
        gf = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * gf
        v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(gf)
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def state_specs(param_specs: Any) -> dict:
    """Optimizer-state logical shardings mirror the parameter shardings."""
    return {"m": param_specs, "v": param_specs, "step": ()}
