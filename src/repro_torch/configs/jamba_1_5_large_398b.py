"""jamba-1.5-large-398b [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2,
Mamba:attention 1:7 interleave (one attention layer per 8), MoE every
other layer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    n_experts=16, experts_per_token=2, moe_every=2,
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    opt_state_dtype="bfloat16",  # 398B
    micro_batches=16,
)
