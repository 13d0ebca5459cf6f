"""Model assembly for dense attention transformers, plain PyTorch.

Port of the dense-attention subset of ``repro.models.transformer``. The
reference stacks layers per pattern repeat under ``lax.scan``; the port
keeps one parameter dict per layer in ``params["layers"]`` and walks them
in a Python loop (``models.convert`` carries a reference pytree across).

Public surface:
  init_params(cfg, seed=, device=)           -> params
  forward(params, cfg, tokens, plans)        -> logits
  init_decode_state(cfg, B, L, ...)          -> state (contiguous caches)
  prefill / prefill_chunk / decode_step / insert_request

Decode states hold per-layer ``{"k", "v"}`` caches ``(B, max_len, K, hd)``
and ``pos``: a Python int (lockstep; the host always knows it) or a
``(B,)`` int64 tensor (per-slot, continuous batching). Unlike the
reference's immutable arrays, ``prefill_chunk``, ``decode_step`` and
``insert_request`` write into the state's cache tensors in place — a decode
step would otherwise copy the whole KV cache.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


def _check_supported(cfg: ArchConfig) -> None:
    if tuple(cfg.block_pattern) != ("attn",) or cfg.is_moe \
            or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense attention-only token models "
            "(MoE, mamba, rwkv and embedding inputs are later slices)")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("int8 KV caches are a later slice")


# ------------------------------------------------------------------ init
def init_params(cfg: ArchConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters with the reference's shapes, distributions and
    scales (``T.init_params`` / ``L.init_attention`` / ``L.init_mlp`` /
    ``L.init_embedding``): normal weights scaled by fan-in ** -0.5, zero
    QKV biases, unit norms — drawn from a ``torch.Generator`` on the
    target device (the values differ from ``jax.random``'s)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    def ones(n):
        return {"scale": torch.ones(n, dtype=dt, device=dev)}

    layers = []
    for _ in range(cfg.n_layers):
        core = {"wq": normal((d, h * hd), d ** -0.5),
                "wk": normal((d, kv * hd), d ** -0.5),
                "wv": normal((d, kv * hd), d ** -0.5),
                "wo": normal((h * hd, d), (h * hd) ** -0.5)}
        if cfg.qkv_bias:
            for name, n in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
                core[name] = torch.zeros(n, dtype=dt, device=dev)
        if cfg.qk_norm:
            core["q_norm"] = torch.ones(hd, dtype=dt, device=dev)
            core["k_norm"] = torch.ones(hd, dtype=dt, device=dev)
        ffn = {"w1": normal((d, f), d ** -0.5), "w3": normal((d, f), d ** -0.5),
               "w2": normal((f, d), f ** -0.5)}
        layers.append({"norm1": ones(d), "core": core, "norm2": ones(d),
                       "ffn": ffn})
    embed = {"embed": normal((cfg.vocab_size, d), d ** -0.5),
             "head": normal((d, cfg.vocab_size), d ** -0.5)}
    return {"embed": embed, "layers": layers, "final_norm": ones(d)}


# ------------------------------------------------------------------ forward
def _layer_plans(cfg: ArchConfig, plans) -> list:
    return [None] * cfg.n_layers if plans is None else plans["layers"]


def _head_plan(plans):
    return None if plans is None else plans["head"]


def apply_block(bp: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, plan=None) -> torch.Tensor:
    h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    x = x + L.attention_block(bp["core"], cfg, h, positions,
                              plans=L.plan_leaf(plan, "core"))
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    return x + L.mlp_block(bp["ffn"], cfg, h, plans=L.plan_leaf(plan, "ffn"))


def embed_inputs(params: dict, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    _check_supported(cfg)
    return L.embed(params["embed"], tokens)


def forward_hidden(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                   plans=None) -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D)."""
    x = embed_inputs(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    with L.suspend_pim_stats():
        for bp, plan in zip(params["layers"], _layer_plans(cfg, plans)):
            x = apply_block(bp, cfg, x, positions, plan)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            plans=None) -> torch.Tensor:
    """Full-sequence forward to logits. tokens: (B, S) ids."""
    return L.lm_head(params["embed"], cfg,
                     forward_hidden(params, cfg, tokens, plans),
                     plan=_head_plan(plans))


# ------------------------------------------------------------------ decode
def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      per_slot_pos: bool = False, device=None) -> dict:
    """Zeroed per-layer KV caches ``(batch, max_len, kv_heads, head_dim)``
    and a position: int 0, or a ``(batch,)`` tensor with ``per_slot_pos``
    (the substrate for continuous batching)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.kv_cache_dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    caches = [{"k": torch.zeros(shape, dtype=dt, device=dev),
               "v": torch.zeros(shape, dtype=dt, device=dev)}
              for _ in range(cfg.n_layers)]
    pos = torch.zeros(batch, dtype=torch.int64, device=dev) \
        if per_slot_pos else 0
    return {"caches": caches, "pos": pos}


def _write_token(buf: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write a one-token slice ``new`` (B, 1, ...) into a (B, L, ...) cache
    in place. A scalar ``pos`` writes one column; a (B,) pos writes each
    slot at its own offset, and offsets past the cache write nothing (idle
    slots keep advancing), as the reference's ``mode="drop"`` scatter."""
    if isinstance(pos, int):
        buf[:, pos] = new[:, 0].to(buf.dtype)
        return
    B, max_len = buf.shape[0], buf.shape[1]
    rows = torch.arange(B, device=buf.device)
    idx = pos.clamp(max=max_len - 1)
    keep = (pos < max_len).reshape((B,) + (1,) * (buf.ndim - 2))
    buf[rows, idx] = torch.where(keep, new[:, 0].to(buf.dtype),
                                 buf[rows, idx])


def _attn_decode(bp: dict, cfg: ArchConfig, cache: dict, x: torch.Tensor,
                 pos, plans=None) -> torch.Tensor:
    """Single-token attention against the cache (written in place)."""
    B = x.shape[0]
    if isinstance(pos, int):
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
    else:
        positions = pos[:, None]
    q, k_new, v_new = L.qkv_project(bp["core"], cfg, x, positions, plans)
    _write_token(cache["k"], k_new, pos)
    _write_token(cache["v"], v_new, pos)
    out = L.chunked_attention(q, cache["k"], cache["v"], q_positions=positions,
                              kv_len=pos + 1, causal=True)
    return L.pim_matmul(out.reshape(B, 1, -1), bp["core"]["wo"],
                        L.plan_leaf(plans, "wo"), cfg)


def decode_step(params: dict, cfg: ArchConfig, state: dict,
                tokens: torch.Tensor, plans=None) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1) ids. Every slot's position advances
    by one; the caches are updated in place."""
    x = embed_inputs(params, cfg, tokens)
    pos = state["pos"]
    for bp, cache, plan in zip(params["layers"], state["caches"],
                               _layer_plans(cfg, plans)):
        h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
        x = x + _attn_decode(bp, cfg, cache, h, pos,
                             plans=L.plan_leaf(plan, "core"))
        h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
        x = x + L.mlp_block(bp["ffn"], cfg, h,
                            plans=L.plan_leaf(plan, "ffn"))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.lm_head(params["embed"], cfg, x, plan=_head_plan(plans))
    return logits, {"caches": state["caches"], "pos": pos + 1}


# ------------------------------------------------------------------ prefill
def _prefill_layers(params: dict, cfg: ArchConfig, x: torch.Tensor,
                    caches: list, pos0: int, plans, raw_attn: bool):
    """Run a prompt chunk at offset ``pos0`` through every layer, storing
    its K/V into ``caches`` in place. ``raw_attn`` attends over this
    call's own K/V (whole-prompt prefill); otherwise over the cache, which
    holds the earlier chunks (chunked continuation)."""
    B, C = x.shape[0], x.shape[1]
    positions = (pos0 + torch.arange(C, device=x.device)).expand(B, C)
    with L.suspend_pim_stats():
        for bp, cache, plan in zip(params["layers"], caches,
                                   _layer_plans(cfg, plans)):
            core_plan = L.plan_leaf(plan, "core")
            hn = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
            q, k, v = L.qkv_project(bp["core"], cfg, hn, positions, core_plan)
            cache["k"][:, pos0:pos0 + C] = k.to(cache["k"].dtype)
            cache["v"][:, pos0:pos0 + C] = v.to(cache["v"].dtype)
            if raw_attn:
                o = L.chunked_attention(q, k, v, q_positions=positions,
                                        kv_len=C, causal=cfg.causal)
            else:
                o = L.chunked_attention(
                    q, cache["k"].to(hn.dtype), cache["v"].to(hn.dtype),
                    q_positions=positions, kv_len=pos0 + C, causal=True)
            x = x + L.pim_matmul(o.reshape(B, C, -1), bp["core"]["wo"],
                                 L.plan_leaf(core_plan, "wo"), cfg)
            hn2 = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
            x = x + L.mlp_block(bp["ffn"], cfg, hn2,
                                plans=L.plan_leaf(plan, "ffn"))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(params["embed"], cfg, x[:, -1:], plan=_head_plan(plans))


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            max_len: int | None = None,
            plans=None) -> tuple[torch.Tensor, dict]:
    """Process a prompt, returning last-position logits and a filled
    decode state (caches sized to ``max_len``, default the prompt)."""
    x = embed_inputs(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    state = init_decode_state(cfg, B, max_len or S, device=x.device)
    logits = _prefill_layers(params, cfg, x, state["caches"], 0, plans,
                             raw_attn=True)
    return logits, {"caches": state["caches"], "pos": S}


def prefill_chunk(params: dict, cfg: ArchConfig, state: dict,
                  tokens: torch.Tensor,
                  plans=None) -> tuple[torch.Tensor, dict]:
    """Process the next prompt chunk of an in-flight (chunked) prefill.

    ``state`` is a scalar-pos decode state whose caches hold positions
    ``[0, state["pos"])``; ``tokens`` (B, C) continue the prompt there.
    Over a whole prompt this reproduces ``prefill`` for float KV caches.
    """
    x = embed_inputs(params, cfg, tokens)
    pos0 = state["pos"]
    logits = _prefill_layers(params, cfg, x, state["caches"], pos0, plans,
                             raw_attn=False)
    return logits, {"caches": state["caches"], "pos": pos0 + x.shape[1]}


def insert_request(state: dict, one: dict, slot: int) -> dict:
    """Splice a batch-1 scalar-pos state into slot ``slot`` of a per-slot
    state, in place: every cache row of the slot is replaced."""
    for cache, c1 in zip(state["caches"], one["caches"]):
        for key in cache:
            cache[key][slot] = c1[key][0].to(cache[key].dtype)
    state["pos"][slot] = one["pos"]
    return state
