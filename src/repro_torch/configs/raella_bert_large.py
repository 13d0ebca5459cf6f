"""BERT-Large — the RAELLA paper's own transformer workload (§6.2).

24L d_model=1024 16H d_ff=4096, encoder-only, GELU (signed activations ->
the paper's two-cycle input processing). Feedforward layers are the part
the paper accelerates (the JAX package's fig12/table4 benchmarks use
this config).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="raella-bert-large", family="audio",  # encoder-only family
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=30522,
    causal=False, activation="gelu",
)
