"""qwen1.5-110b [hf:Qwen/Qwen1.5-110B].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab_size=152064, qkv_bias=True,
    opt_state_dtype="bfloat16",  # 110B: keep single-pod HBM headroom
    micro_batches=8,
)
