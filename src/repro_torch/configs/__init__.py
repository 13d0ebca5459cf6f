"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the configurations this slice serves are registered: qwen1.5-0.5b
(the full-width serve target) and yi-6b (whose ``reduced()`` twin is the
GQA case in the parity tests).
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.qwen1_5_0_5b import CONFIG as QWEN15_05B
from repro_torch.configs.yi_6b import CONFIG as YI_6B

__all__ = ["ArchConfig", "REGISTRY", "get"]

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in (QWEN15_05B, YI_6B)}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
