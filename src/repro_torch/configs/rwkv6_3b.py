"""rwkv6-3b (Finch) [arXiv:2404.05892] — attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab_size=65536,
    block_pattern=("rwkv",), rwkv_head_dim=64, activation="relu2",
)
