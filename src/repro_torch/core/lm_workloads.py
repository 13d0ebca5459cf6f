"""Bridge: assigned LM architectures -> PIM workload tables.

Maps every weight-static matmul of an ArchConfig (QKV/O projections, dense
FFN, MoE experts, SSM projections, LM head) onto ``mapping.LayerShape`` so
the Titanium-Law model can answer: *what would serving this architecture on
RAELLA vs 8b-ISAAC silicon cost?* Dynamic matmuls (attention scores/values,
SSM recurrences) stay digital, exactly as the paper scopes BERT (§6.2).

Notes:
- decode-style serving: one token per step -> n_positions = tokens served;
- activations after SiLU/GELU are signed -> two-cycle input processing
  (the paper's BERT treatment); post-ReLU-free LM blocks are signed;
- MoE: each token exercises top-k experts, so MACs scale by k/E while the
  crossbar footprint holds all E experts (utilization cost PIM pays).

A copy of the JAX package's ``repro.core.lm_workloads`` (the port imports
nothing of ``repro``).
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.core.mapping import LayerShape


def from_arch_config(cfg: ArchConfig, tokens: int = 4096) -> list[LayerShape]:
    """Weight-static layers of one full forward over ``tokens`` tokens."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    layers: list[LayerShape] = []

    def fc(name, din, dout, n_tokens=tokens, last=False):
        layers.append(LayerShape(
            name=name, filter_len=din, n_filters=dout, n_positions=n_tokens,
            signed_inputs=True, last_layer=last, row_positions=n_tokens))

    for i, kind in enumerate(cfg.block_pattern):
        for r in range(cfg.n_repeats):
            tag = f"{kind}{i}r{r}"
            if kind == "attn":
                fc(f"{tag}_q", d, cfg.n_heads * hd)
                fc(f"{tag}_k", d, cfg.n_kv_heads * hd)
                fc(f"{tag}_v", d, cfg.n_kv_heads * hd)
                fc(f"{tag}_o", cfg.n_heads * hd, d)
            elif kind == "mamba":
                di = cfg.mamba_expand * d
                fc(f"{tag}_in", d, 2 * di)
                fc(f"{tag}_x", di, max(1, d // 16) + 2 * cfg.mamba_d_state)
                fc(f"{tag}_out", di, d)
            elif kind == "rwkv":
                for nm in ("r", "k", "v", "g", "o"):
                    fc(f"{tag}_{nm}", d, d)
            # FFN
            if kind == "rwkv":
                fc(f"{tag}_cmk", d, cfg.d_ff)
                fc(f"{tag}_cmv", cfg.d_ff, d)
            elif cfg.moe_layer(i):
                # top-k of E experts active per token; weights for all E
                # are resident (footprint), MACs scale with active tokens
                active = max(1, tokens * cfg.experts_per_token
                             // max(cfg.n_experts, 1))
                for e in range(cfg.n_experts):
                    fc(f"{tag}_e{e}w1", d, cfg.d_ff, n_tokens=active)
                    fc(f"{tag}_e{e}w3", d, cfg.d_ff, n_tokens=active)
                    fc(f"{tag}_e{e}w2", cfg.d_ff, d, n_tokens=active)
            else:
                fc(f"{tag}_w1", d, cfg.d_ff)
                fc(f"{tag}_w3", d, cfg.d_ff)
                fc(f"{tag}_w2", cfg.d_ff, d)
    fc("lm_head", d, cfg.vocab_size, last=True)
    return layers
