"""hubert-xlarge [arXiv:2106.07447] — encoder-only audio transformer.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit targets).
The conv waveform frontend is not modelled: the model takes precomputed
frame embeddings (B, S, 1280) (``input_mode="embeddings"``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, input_mode="embeddings", activation="gelu",
)
