"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the configurations the port serves are registered: qwen1.5-0.5b
(the dense full-width serve target), yi-6b (whose ``reduced()`` twin is
the GQA case in the parity tests), phi3.5-moe-42b (top-2 softmax MoE on
every layer, served at its published widths with depth cut) and
llama4-maverick-400b (top-1 sigmoid MoE alternating with dense FFNs; too
wide for one card, so only its ``reduced()`` twin runs).
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.llama4_maverick_400b import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.phi3_5_moe_42b import CONFIG as PHI35_MOE
from repro_torch.configs.qwen1_5_0_5b import CONFIG as QWEN15_05B
from repro_torch.configs.yi_6b import CONFIG as YI_6B

__all__ = ["ArchConfig", "REGISTRY", "get"]

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in (PHI35_MOE, LLAMA4_MAVERICK, YI_6B, QWEN15_05B)}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
