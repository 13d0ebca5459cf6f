"""Architecture registry of the port: ``--arch <id>`` resolves here.

All eleven of the reference's configurations are registered:
qwen1.5-0.5b (the dense full-width serve target), yi-6b (whose
``reduced()`` twin is the GQA case in the parity tests), the dense decoders
chameleon-34b (qk-norm), qwen2.5-32b and qwen1.5-110b (QKV bias; too large
for one card whole, so they run at published widths with depth cut),
phi3.5-moe-42b (top-2 softmax MoE on every layer, served at its published
widths with depth cut), llama4-maverick-400b (top-1 sigmoid MoE alternating
with dense FFNs; too wide for one card, so only its ``reduced()`` twin
runs), rwkv6-3b (attention-free, served whole at its published size),
jamba-1.5-large-398b (mamba and attention layers, MoE on every other one;
at 90.5 GB in bf16 for its smallest whole depth it runs one layer at a
time on one card, or whole at ``reduced()`` widths), and the two
encoder-only models, raella-bert-large (the paper's own transformer) and
hubert-xlarge (frame-embedding inputs), which run ``forward`` and
``lm_loss`` whole at their published sizes; the engines refuse them, as
the reference's do (no decode).
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.chameleon_34b import CONFIG as CHAMELEON_34B
from repro_torch.configs.hubert_xlarge import CONFIG as HUBERT_XLARGE
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA15_LARGE
from repro_torch.configs.llama4_maverick_400b import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.phi3_5_moe_42b import CONFIG as PHI35_MOE
from repro_torch.configs.qwen1_5_0_5b import CONFIG as QWEN15_05B
from repro_torch.configs.qwen1_5_110b import CONFIG as QWEN15_110B
from repro_torch.configs.qwen2_5_32b import CONFIG as QWEN25_32B
from repro_torch.configs.raella_bert_large import CONFIG as RAELLA_BERT_LARGE
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.yi_6b import CONFIG as YI_6B

__all__ = ["ArchConfig", "ASSIGNED", "REGISTRY", "get"]

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in (PHI35_MOE, LLAMA4_MAVERICK, JAMBA15_LARGE,
                        QWEN15_110B, YI_6B, QWEN25_32B, QWEN15_05B,
                        HUBERT_XLARGE, RWKV6_3B, CHAMELEON_34B,
                        RAELLA_BERT_LARGE)}

# the LM zoo ``paper.lm_on_pim`` walks: every arch but the paper's own BERT,
# in registry order
ASSIGNED = tuple(n for n in REGISTRY if n != "raella-bert-large")


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
