"""PIM-backed model execution: the compile-step facade for whole LMs.

``prepare_pim_params(params, cfg, calib_tokens)`` returns the plan tree the
serve engines consume (``None`` for ``pim_mode='off'``); use
``pim_compile.compile_pim_params`` directly for the per-site table. Plan
leaves are plain dicts of tensors; the weight slicing rides inside them
(``slice_shifts`` / ``slice_valid``), while the ADC resolution and
speculation stay on ``ArchConfig`` and are rebuilt at dispatch by
``models.layers.pim_matmul``.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.pim_compile import (
    CompiledPim,
    SitePlan,
    compile_pim_params,
)

__all__ = ["CompiledPim", "SitePlan", "compile_pim_params",
           "prepare_pim_params"]


def prepare_pim_params(params: dict, cfg: ArchConfig, calib_tokens):
    """Compile ``params`` into a PIM plan tree for ``cfg.pim_mode``."""
    compiled = compile_pim_params(params, cfg, calib_tokens)
    return None if compiled is None else compiled.plans
