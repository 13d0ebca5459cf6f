"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    n_experts=16, experts_per_token=2, moe_every=1,
    opt_state_dtype="float32",
    micro_batches=2,
)
