"""chameleon-34b [arXiv:2405.09818] — early-fusion VLM backbone.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text + VQ image
tokens in one vocabulary). QK-norm as in the paper. The VQ image tokenizer
is a STUB per the assignment: input_specs() feeds the fused token stream.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536, qk_norm=True,
    micro_batches=2,
)
