"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4; early fusion].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1, interleaved every other layer (the real Maverick alternates dense /
MoE FFNs; this also lands the 400B total parameter count).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    n_experts=128, experts_per_token=1, moe_every=2,
    block_pattern=("attn", "attn"),  # even layers MoE, odd layers dense
    opt_state_dtype="bfloat16",  # 400B: fp32 m/v does not fit one pod
    micro_batches=16,
)
