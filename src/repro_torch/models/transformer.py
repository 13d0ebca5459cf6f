"""Model assembly: attention, mamba and rwkv6 blocks, plain PyTorch.

Port of ``repro.models.transformer``: attention layers with dense or
mixture-of-experts FFNs, causal or not (the encoder-only configs), mamba
layers (jamba) and rwkv6 layers, whose channel-mix takes the FFN's place.
Layer ``l`` has pattern index ``l % len(block_pattern)``, which picks its
kind and, through ``cfg.moe_layer``, a MoE FFN. The reference stacks
layers per pattern repeat under ``lax.scan``; the port keeps one parameter
dict per layer in ``params["layers"]`` and walks them in a Python loop
(``models.convert`` carries a reference pytree across). Inputs are token
ids ``(B, S)``, or with ``input_mode="embeddings"`` (hubert) frame
embeddings ``(B, S, D)`` cast to ``cfg.dtype`` (``embed_inputs``); such a
model keeps its unused ``embed.embed`` table, as the reference's does.

Public surface:
  init_params(cfg, seed=, device=)           -> params
  forward(params, cfg, inputs, plans)        -> logits
  lm_loss(params, cfg, batch)                -> scalar (differentiable)
  init_decode_state(cfg, B, L, ..., paged=)  -> state (contiguous or paged)
  prefill / prefill_chunk / decode_step / insert_request
  init_layer / apply_block / run_layer       -> one layer (fresh / cached)
  PagedLayout / prefill_chunk_paged / insert_request_paged
  param_specs(cfg) / cache_specs(cfg, paged=) -> logical sharding axes

Decode states hold one cache dict per layer and ``pos``: a Python int
(lockstep; the host always knows it) or a ``(B,)`` int64 tensor (per-slot,
continuous batching). An attention layer's cache is ``{"k", "v"}``
``(B, max_len, K, hd)``; with ``kv_cache_dtype="int8"`` it holds int8
codes plus float32 ``k_scale``/``v_scale`` leaves, one scale per (token,
head). A paged state holds one block pool per attention layer,
``(n_blocks + 1, block_size, K, hd)``, shared by every slot and addressed
through per-slot block tables. A recurrent layer's cache is its carry with
a slot axis, paged or not: mamba ``{"h", "conv"}``, rwkv ``{"h", "x_prev",
"cm_prev"}`` (``models.ssm``). Prefill and decode continue the carries
from the state, so a zero state is a fresh sequence.

Unlike the reference's immutable arrays, ``prefill_chunk``,
``prefill_chunk_paged``, ``decode_step`` and the ``insert_request`` pair
update the state in place: attention caches are written in place (a
decode step would otherwise copy the whole KV cache) and recurrent carries
are replaced in their cache dicts. In a paged pool, slots whose table
entry is the sentinel write into the scratch row, several of them in one
``index_put`` possibly at one index (CUDA then keeps an arbitrary one);
every such position lies at or past its reader's ``kv_len``, so no live
row ever takes a duplicate write.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import parallel
from repro_torch.dist import sharding as dsh
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.obs import tracing


def block_kind(cfg: ArchConfig, layer: int) -> str:
    """Layer ``layer``'s block kind: attn, mamba or rwkv."""
    return cfg.block_pattern[layer % len(cfg.block_pattern)]


def ffn_block(bp: dict, cfg: ArchConfig, layer: int, x: torch.Tensor,
              plan=None, part=None) -> torch.Tensor:
    """Layer ``layer``'s FFN: ``moe_block`` where the config puts a MoE
    FFN, else the gated MLP (an rwkv layer's channel-mix: ``run_layer``),
    tensor-parallel (a MoE FFN expert-sliced) under a partition."""
    if L.is_moe_layer(cfg, layer):
        return L.moe_block(bp["ffn"], cfg, x, plans=L.plan_leaf(plan, "ffn"),
                           part=part)
    return L.mlp_block(bp["ffn"], cfg, x, plans=L.plan_leaf(plan, "ffn"),
                       part=part)


def _init_carry(cfg: ArchConfig, kind: str, batch: int, device,
                part=None) -> dict:
    """A mamba or rwkv layer's zero carry for ``batch`` slots (under a
    partition, of the rank's d_inner block or heads)."""
    init = S.init_mamba_state if kind == "mamba" else S.init_rwkv_state
    return init(cfg, batch, device, part)


# ------------------------------------------------------------------ init
def _draws(cfg: ArchConfig, device, seed: int):
    """Weight drawers on ``device`` from one ``torch.Generator``:
    ``normal(shape, scale)`` and ``uniform(shape)`` in ``cfg.dtype``, and
    the generator for float32 draws."""
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dt)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float32).to(dt)
    return gen, normal, uniform


def _init_layer(cfg: ArchConfig, layer: int, draws, dev) -> dict:
    gen, normal, uniform = draws
    dt = getattr(torch, cfg.dtype)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    kind = block_kind(cfg, layer)
    if kind == "attn":
        core = {"wq": normal((d, h * hd), d ** -0.5),
                "wk": normal((d, kv * hd), d ** -0.5),
                "wv": normal((d, kv * hd), d ** -0.5),
                "wo": normal((h * hd, d), (h * hd) ** -0.5)}
        if cfg.qkv_bias:
            for name, n in (("bq", h * hd), ("bk", kv * hd),
                            ("bv", kv * hd)):
                core[name] = torch.zeros(n, dtype=dt, device=dev)
        if cfg.qk_norm:
            core["q_norm"] = torch.ones(hd, dtype=dt, device=dev)
            core["k_norm"] = torch.ones(hd, dtype=dt, device=dev)
    elif kind == "mamba":
        core = S.init_mamba(cfg, normal, dev)
    else:
        core = S.init_rwkv(cfg, normal, uniform, dev)
    if kind == "rwkv":
        ffn = S.init_rwkv_channel_mix(cfg, normal, uniform)
    elif L.is_moe_layer(cfg, layer):
        e = cfg.n_experts
        ffn = {"router": (torch.randn((d, e), generator=gen, device=dev)
                          * d ** -0.5),  # float32, as the reference's
               "w1": normal((e, d, f), d ** -0.5),
               "w3": normal((e, d, f), d ** -0.5),
               "w2": normal((e, f, d), f ** -0.5)}
    else:
        ffn = {"w1": normal((d, f), d ** -0.5),
               "w3": normal((d, f), d ** -0.5),
               "w2": normal((f, d), f ** -0.5)}

    def ones(n):
        return {"scale": torch.ones(n, dtype=dt, device=dev)}
    return {"norm1": ones(d), "core": core, "norm2": ones(d), "ffn": ffn}


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters with the reference's shapes, distributions and
    scales (``T.init_params`` / ``L.init_attention`` / ``L.init_mlp`` /
    ``L.init_moe`` / ``L.init_embedding`` / ``ssm.init_mamba`` /
    ``ssm.init_rwkv`` / ``ssm.init_rwkv_channel_mix``): normal weights
    scaled by fan-in ** -0.5, zero QKV biases, unit norms, a float32 router
    and ``(E, d_in, d_out)`` expert weights on MoE layers, float32
    ``A_log``, ``D``, ``decay_base`` and ``bonus`` — drawn from a
    ``torch.Generator`` on the target device (the values differ from
    ``jax.random``'s)."""
    dev = resolve_device(device)
    draws = _draws(cfg, dev, seed)
    layers = [_init_layer(cfg, layer, draws, dev)
              for layer in range(cfg.n_layers)]
    normal, d = draws[1], cfg.d_model
    embed = {"embed": normal((cfg.vocab_size, d), d ** -0.5),
             "head": normal((d, cfg.vocab_size), d ** -0.5)}
    return {"embed": embed, "layers": layers,
            "final_norm": {"scale": torch.ones(
                d, dtype=getattr(torch, cfg.dtype), device=dev)}}


# ------------------------------------------------------------------ specs
# Logical sharding axes of each leaf, the reference's (``L.init_attention``,
# ``L.init_mlp``, ``L.init_moe``, ``ssm.init_mamba``, ``ssm.init_rwkv``,
# ``ssm.init_rwkv_channel_mix``, ``L.init_embedding``), per layer: the
# reference's stacked spec without its leading repeat ``None``.
_MLP_SPECS = {"w1": ("fsdp", "tp"), "w3": ("fsdp", "tp"),
              "w2": ("tp", "fsdp")}
_MOE_SPECS = {"router": (None, None), "w1": ("experts", "fsdp", "tp"),
              "w3": ("experts", "fsdp", "tp"),
              "w2": ("experts", "tp", "fsdp")}
_MAMBA_SPECS = {
    "in_proj": ("fsdp", "tp"), "conv_w": (None, "tp"), "conv_b": ("tp",),
    "x_proj": ("tp", None), "dt_proj": (None, "tp"), "dt_bias": ("tp",),
    "A_log": ("tp", None), "D": ("tp",), "out_proj": ("tp", "fsdp")}
_RWKV_SPECS = {
    "mix": (None, None),
    "wr": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wg": ("fsdp", "tp"), "wo": ("tp", "fsdp"),
    "decay_base": (None,), "decay_A": (None, None), "decay_B": (None, None),
    "bonus": ("heads", None), "ln_x": (None,)}
_RWKV_CHANNEL_MIX_SPECS = {"mix": (None, None), "wk": ("fsdp", "tp"),
                           "wv": ("tp", "fsdp"), "wr": ("fsdp", None)}


def layer_param_specs(cfg: ArchConfig, layer: int) -> dict:
    """Logical axes of layer ``layer``'s parameter dict."""
    kind = block_kind(cfg, layer)
    if kind == "attn":
        core = {"wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads"),
                "wv": ("fsdp", "kv_heads"), "wo": ("heads", "fsdp")}
        if cfg.qkv_bias:
            core.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
        if cfg.qk_norm:
            core.update(q_norm=(None,), k_norm=(None,))
    else:
        core = dict(_MAMBA_SPECS if kind == "mamba" else _RWKV_SPECS)
    if kind == "rwkv":
        ffn = dict(_RWKV_CHANNEL_MIX_SPECS)
    else:
        ffn = dict(_MOE_SPECS if L.is_moe_layer(cfg, layer) else _MLP_SPECS)
    return {"norm1": {"scale": (None,)}, "core": core,
            "norm2": {"scale": (None,)}, "ffn": ffn}


def param_specs(cfg: ArchConfig) -> dict:
    """Logical sharding axes mirroring the ``init_params`` tree, built from
    tables (no array is allocated, so a 400B config resolves at once)."""
    return {"embed": {"embed": ("vocab", "fsdp"), "head": ("fsdp", "vocab")},
            "layers": [layer_param_specs(cfg, layer)
                       for layer in range(cfg.n_layers)],
            "final_norm": {"scale": (None,)}}


def cache_specs(cfg: ArchConfig, *, paged: bool = False) -> dict:
    """Logical shardings of the ``init_decode_state`` tree (the KV cache
    seq-sharded). A paged pool shards its *block* axis on ``cache_batch``
    (blocks play the role per-slot regions play contiguously); an int8
    cache's ``k_scale``/``v_scale`` drop the head-dim axis; ``pos`` is
    replicated."""
    caches = []
    for layer in range(cfg.n_layers):
        kind = block_kind(cfg, layer)
        if kind == "attn":
            kv = (("cache_batch", None, "kv_heads", None) if paged
                  else ("cache_batch", "seq", "kv_heads", None))
            c = {"k": kv, "v": kv}
            if cfg.kv_cache_dtype == "int8":
                c["k_scale"] = c["v_scale"] = kv[:-1]
        else:
            c = dict(_CARRY_SPECS[kind])
        caches.append(c)
    return {"caches": caches, "pos": ()}


_CARRY_SPECS = {"mamba": {"h": ("cache_batch", "tp", None),
                          "conv": ("cache_batch", None, "tp")},
                "rwkv": {"h": ("cache_batch", "heads", None, None),
                         "x_prev": ("cache_batch", None),
                         "cm_prev": ("cache_batch", None)}}


def init_layer(cfg: ArchConfig, layer: int, *, seed: int = 0,
               device=None) -> dict:
    """Layer ``layer``'s parameters alone, as ``init_params`` draws them
    (from a generator of its own): a model too large for one card runs a
    layer at a time through ``apply_block`` / ``run_layer``."""
    dev = resolve_device(device)
    return _init_layer(cfg, layer, _draws(cfg, dev, seed), dev)


# ------------------------------------------------------------------ forward
def _layer_plans(cfg: ArchConfig, plans) -> list:
    return [None] * cfg.n_layers if plans is None else plans["layers"]


def _head_plan(plans):
    return None if plans is None else plans["head"]


def apply_block(bp: dict, cfg: ArchConfig, layer: int, x: torch.Tensor,
                positions: torch.Tensor, plan=None,
                part=None) -> torch.Tensor:
    """One layer over a fresh sequence (forward, calibration capture):
    ``run_layer`` from a zero carry, attention over this call's K/V. Under
    a partition (``dist.parallel.Partition``) ``x`` is the rank's sequence
    block, ``bp`` the rank's weights and ``positions`` the whole
    sequence's."""
    kind = block_kind(cfg, layer)
    cache = {} if kind == "attn" else _init_carry(cfg, kind, x.shape[0],
                                                  x.device, part)

    def attend(bp, cache, h, core_plan):
        return L.attention_block(bp["core"], cfg, h, positions,
                                 plans=core_plan, part=part)
    return run_layer(bp, cfg, layer, x, cache, plan, attend, part)


def run_layer(bp: dict, cfg: ArchConfig, layer: int, x: torch.Tensor,
              cache: dict, plan, attend, part=None, ffn=None,
              serve=None) -> torch.Tensor:
    """One layer of a prefill chunk or a decode step, continuing from the
    layer's cache and updating it in place. ``attend(bp, cache, h, plan)``
    runs an attention layer's core on the normed input ``h``; the recurrent
    kinds continue their carries, as the reference's ``_decode_block`` and
    ``_prefill_repeat_body`` do, rwkv's channel-mix from ``cm_prev``. Under
    a partition the norms and residuals act on the rank's sequence block,
    the FFN is tensor-parallel and the recurrent cores run on the rank's
    d_inner block or heads (``models.ssm``). ``ffn(bp, h)``, where given,
    runs an attention or mamba layer's FFN in place of ``ffn_block``, and
    ``serve`` (``dist.parallel.ServeLayer`` of the layer) runs the
    recurrent kinds on the rank's rows of the state: the partitioned
    decode."""
    kind = block_kind(cfg, layer)
    core_plan = L.plan_leaf(plan, "core")
    h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    core = None if serve is None else serve.at("core")
    if kind == "attn":
        h = attend(bp, cache, h, core_plan)
    elif kind == "mamba":
        carry, h = S.mamba_scan(bp["core"], cfg, h, cache, plans=core_plan,
                                part=part, serve=core)
        cache.update(carry)
    else:
        carry, h = S.rwkv_time_mix_scan(bp["core"], cfg, h, cache, part=part,
                                        serve=core)
        cache.update(carry)
    x = x + h
    h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
    if ffn is not None and kind != "rwkv":
        return x + ffn(bp, h)
    if kind != "rwkv":
        return x + ffn_block(bp, cfg, layer, h, plan, part)
    cache["cm_prev"], h = S.rwkv_channel_mix_scan(
        bp["ffn"], cfg, h, cache["cm_prev"], part=part,
        serve=None if serve is None else serve.at("ffn"))
    return x + h


def embed_inputs(params: dict, cfg: ArchConfig, inputs: torch.Tensor,
                 part=None) -> torch.Tensor:
    """Token ids (B, S) through the embedding table, or (embeddings mode)
    frame embeddings (B, S, D) cast to ``cfg.dtype``; under a partition,
    the rank's sequence block of either (``layers.embed``)."""
    if cfg.input_mode == "tokens":
        table = params["embed"]
        if part is not None:
            table = {"embed": part.weight(table["embed"], "embed/embed")}
        return L.embed(table, inputs, part)
    x = inputs.to(getattr(torch, cfg.dtype))
    return x if part is None else part.seq_block(x)


def _records(tree) -> bool:
    """Whether any tensor of a nested dict/list of tensors requires grad."""
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    items = tree.values() if isinstance(tree, dict) else tree
    return any(_records(v) for v in items)


def forward_hidden(params: dict, cfg: ArchConfig, inputs: torch.Tensor,
                   plans=None, part=None) -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D).

    With ``cfg.remat``, while autograd records (grad enabled and some
    parameter requires grad), each layer runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward, as the
    reference's ``jax.checkpoint`` per repeat and per block: only the
    layers' inputs stay alive. Otherwise (serving under ``no_grad``) the
    layers run as they are.

    Under a partition ``params`` are the rank's local blocks and the
    result is the rank's sequence block (B, S / |model|, D); each layer's
    weights are gathered inside the function that ``checkpoint`` wraps,
    so the backward gathers them again (``dist.parallel``)."""
    x = embed_inputs(params, cfg, inputs, part)
    B, S = x.shape[0], inputs.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled() and _records(params)
    with L.suspend_pim_stats():
        for layer, (bp, plan) in enumerate(zip(params["layers"],
                                               _layer_plans(cfg, plans))):
            def layer_fn(bp, x, layer=layer, plan=plan):
                if part is not None:
                    bp = part.weights(bp, f"layers/{layer}")
                return apply_block(bp, cfg, layer, x, positions, plan, part)
            x = (checkpoint(layer_fn, bp, x, use_reentrant=False) if remat
                 else layer_fn(bp, x))
    norm = params["final_norm"]
    if part is not None:
        norm = part.weights(norm, "final_norm")
    return L.rmsnorm(norm, x, cfg.norm_eps)


def forward(params: dict, cfg: ArchConfig, inputs: torch.Tensor,
            plans=None) -> torch.Tensor:
    """Full-sequence forward to logits. inputs: tokens (B, S) or
    embeddings (B, S, D)."""
    with tracing.span("model.forward"):
        return L.lm_head(params["embed"], cfg,
                         forward_hidden(params, cfg, inputs, plans),
                         plan=_head_plan(plans))


# ------------------------------------------------------------------ losses
LOSS_CHUNK = 512  # sequence positions per logits chunk


def _chunk_nll(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Summed masked cross-entropy of one chunk's logits, in float32."""
    logits = torch.einsum("bsd,dv->bsv", x, head).to(torch.float32)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    return ((torch.logsumexp(logits, dim=-1) - picked) * mask).sum()


def _chunk_nll_vocab_parallel(x: torch.Tensor, head: torch.Tensor,
                              labels: torch.Tensor, mask: torch.Tensor,
                              v0: int, group) -> torch.Tensor:
    """``_chunk_nll`` on this rank's vocab block ``[v0, v0 + head
    columns)`` of the logits: an all-reduce of the max, of the sum of
    exps and of the picked logit over ``group`` (Megatron's vocab-parallel
    cross-entropy); every rank of the group returns the same sum."""
    logits = torch.einsum("bsd,dv->bsv", x, head).to(torch.float32)
    top = parallel.all_reduce(logits.detach().amax(dim=-1), group, "max")
    sum_exp = parallel.all_reduce(
        torch.exp(logits - top[..., None]).sum(dim=-1), group)
    ids = labels - v0
    inside = (ids >= 0) & (ids < logits.shape[-1])
    picked = logits.gather(-1, ids.clamp(0, logits.shape[-1] - 1)[..., None])
    picked = parallel.all_reduce(
        torch.where(inside, picked[..., 0], 0.0), group)
    return ((torch.log(sum_exp) + top - picked) * mask).sum()


def lm_loss(params: dict, cfg: ArchConfig, batch: dict,
            part=None) -> torch.Tensor:
    """Mean cross-entropy: the causal LM loss (causal token models:
    position t predicts ``labels[t + 1]``, the last position masked), or
    every position against its own label (non-causal token models and
    embeddings mode, hubert's masked-unit proxy).

    ``batch``: ``inputs`` (tokens or embeddings), ``labels`` (B, S) ids
    and an optional ``mask`` broadcastable to (B, S). As in the reference,
    the hidden states come from ``forward_hidden`` without plans and the
    head is a plain product cast to float32, so the loss is float in every
    ``pim_mode``; the sequence is padded to whole ``LOSS_CHUNK`` chunks
    and each chunk's logits are reduced before the next, so the (B, S,
    vocab) logits never exist at once. While autograd records, each
    chunk runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint(body)``, whatever ``cfg.remat`` says), so the backward
    recomputes one chunk's logits at a time too. Returns a float32
    scalar.

    Under a partition (the rank's local blocks and rows, ``train_loop``):
    with the head's vocab sharded, the hidden states' sequence is
    all-gathered and the cross-entropy is vocab-parallel
    (``_chunk_nll_vocab_parallel``); with it whole, each rank takes its
    sequence block's positions and the sums are all-reduced over the
    model axis. Either way every rank of the model axis returns its rows'
    loss."""
    x = forward_hidden(params, cfg, batch["inputs"], part=part)  # (B, S, D)
    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    mask = batch.get("mask")
    B, S = labels.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    mask = torch.ones((B, S), **f32) if mask is None else torch.as_tensor(
        mask, **f32).expand(B, S)
    if cfg.input_mode == "tokens" and cfg.causal:
        labels = torch.cat([labels[:, 1:], labels.new_zeros((B, 1))], dim=1)
        mask = mask * (torch.arange(S, device=x.device) < S - 1).to(
            torch.float32)[None, :]
    head = params["embed"]["head"]
    nll, extra, across = _chunk_nll, (), None
    if part is not None:
        head = part.weight(head, "embed/head")
        if head.shape[1] < cfg.vocab_size:
            x = part.gather_seq(x)
            nll = _chunk_nll_vocab_parallel
            extra = (part.vocab_start(head.shape[1]), part.model)
        else:
            labels, mask = part.seq_block(labels), part.seq_block(mask)
            S, across = labels.shape[1], part.model
    C = min(LOSS_CHUNK, S)
    pad = -(-S // C) * C - S
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    lp = torch.nn.functional.pad(labels, (0, pad))
    mp = torch.nn.functional.pad(mask, (0, pad))
    recording = torch.is_grad_enabled() and (x.requires_grad
                                             or head.requires_grad)
    tot = torch.zeros((), **f32)
    cnt = torch.zeros((), **f32)
    for c0 in range(0, S + pad, C):
        args = (xp[:, c0:c0 + C], head, lp[:, c0:c0 + C], mp[:, c0:c0 + C],
                *extra)
        tot = tot + (checkpoint(nll, *args, use_reentrant=False)
                     if recording else nll(*args))
        cnt = cnt + mp[:, c0:c0 + C].sum()
    if across is not None:
        tot, cnt = parallel.all_reduce(tot, across), \
            parallel.all_reduce(cnt, across)
    return tot / cnt.clamp_min(1.0)


# ------------------------------------------------------------------ decode
@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Geometry of a paged KV pool (vLLM-style block tables).

    Attention caches become one pool of ``n_blocks`` fixed-size blocks
    shared by every slot, plus one scratch row at index ``n_blocks`` (the
    ``sentinel``). A slot's block table maps block index -> pool row;
    sentinel entries land writes in scratch and gather garbage that the
    attention ``kv_len`` mask turns into exact-zero contributions, so idle
    or mid-prefill slots need no branch in the decode step.
    """
    n_blocks: int
    block_size: int

    @property
    def sentinel(self) -> int:
        return self.n_blocks

    @property
    def pool_rows(self) -> int:
        return self.n_blocks + 1

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      per_slot_pos: bool = False,
                      paged: PagedLayout | None = None, device=None) -> dict:
    """Zeroed per-layer caches and a position: int 0, or a ``(batch,)``
    tensor with ``per_slot_pos`` (the substrate for continuous batching).
    An attention layer gets KV caches ``(batch, max_len, kv_heads,
    head_dim)`` — or, with ``paged``, block pools ``(n_blocks + 1,
    block_size, kv_heads, head_dim)`` that ``decode_step`` addresses
    through per-slot ``block_tables``; an int8 KV cache adds float32
    ``k_scale``/``v_scale`` leaves without the ``head_dim`` axis. A mamba
    or rwkv layer gets its zero carry with a ``batch`` (slot) axis, paged
    or not."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.kv_cache_dtype)
    lead = (batch, max_len) if paged is None else (paged.pool_rows,
                                                   paged.block_size)
    shape = lead + (cfg.n_kv_heads, cfg.resolved_head_dim)
    caches = []
    for layer in range(cfg.n_layers):
        kind = block_kind(cfg, layer)
        if kind != "attn":
            caches.append(_init_carry(cfg, kind, batch, dev))
            continue
        c = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
        if dt == torch.int8:
            c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
            c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        caches.append(c)
    pos = torch.zeros(batch, dtype=torch.int64, device=dev) \
        if per_slot_pos else 0
    return {"caches": caches, "pos": pos}


def _quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 codes and a float32 scale per (token, head):
    ``max |t| / 127`` floored at 1e-8, codes rounded half to even."""
    t32 = t.to(torch.float32)
    scale = (t32.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(t32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _kv_entries(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """New K/V as the cache stores them, leaf by leaf: int8 codes and
    their scales, or K/V in the cache's dtype."""
    if "k_scale" not in cache:
        return {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _kv_read(cache: dict, dtype: torch.dtype, view=None):
    """The cache's K and V in ``dtype`` for attention, int8 codes
    dequantized; ``view`` maps each leaf first (a paged gather)."""
    view = view or (lambda t: t)
    if "k_scale" not in cache:
        return view(cache["k"]).to(dtype), view(cache["v"]).to(dtype)
    return (_dequantize_kv(view(cache["k"]), view(cache["k_scale"]), dtype),
            _dequantize_kv(view(cache["v"]), view(cache["v_scale"]), dtype))


def _write_token(buf: torch.Tensor, new: torch.Tensor, pos,
                 s0: int | None = None) -> None:
    """Write a one-token slice ``new`` (B, 1, ...) into a (B, L, ...) cache
    in place. A scalar ``pos`` writes one column; a (B,) pos writes each
    slot at its own offset, and offsets past the cache write nothing (idle
    slots keep advancing), as the reference's ``mode="drop"`` scatter.
    With ``s0`` the cache is a block holding the global positions ``[s0,
    s0 + L)`` (a partitioned decode's sequence block), and a position
    outside it writes nothing, a scalar one too."""
    lo, n = s0 or 0, buf.shape[1]
    if isinstance(pos, int):
        if s0 is None or lo <= pos < lo + n:
            buf[:, pos - lo] = new[:, 0].to(buf.dtype)
        return
    rows = torch.arange(buf.shape[0], device=buf.device)
    at = pos - lo
    keep = ((at >= 0) & (at < n)).reshape((-1,) + (1,) * (buf.ndim - 2))
    idx = at.clamp(0, n - 1)
    buf[rows, idx] = torch.where(keep, new[:, 0].to(buf.dtype),
                                 buf[rows, idx])


def _paged_write_token(pool: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor, tables: torch.Tensor,
                       paged: PagedLayout) -> None:
    """Write each slot's one-token slice ``new`` (B, 1, ...) into its
    current block of a ``(pool_rows, block_size, ...)`` pool leaf, in
    place. Slots whose table entry is the sentinel (idle, retired or
    mid-prefill) write into the scratch row, which no live gather unmasks."""
    B = new.shape[0]
    bi = (pos // paged.block_size).clamp(0, tables.shape[1] - 1)
    rows = tables[torch.arange(B, device=tables.device), bi]
    pool[rows, pos % paged.block_size] = new[:, 0].to(pool.dtype)


def _paged_gather(pool: torch.Tensor, tables: torch.Tensor,
                  paged: PagedLayout) -> torch.Tensor:
    """(pool_rows, block_size, ...) pool + (B, max_blocks) tables -> a
    (B, max_blocks * block_size, ...) contiguous-cache copy.

    Sentinel entries gather the scratch block; those positions sit at or
    beyond ``kv_len``, so the attention mask turns them into exact-zero
    contributions and the copy attends bit-identically to a contiguous
    ``(B, max_len, ...)`` cache of the same total length."""
    B, max_blocks = tables.shape
    view = pool[tables.clamp(0, paged.sentinel)]
    return view.reshape((B, max_blocks * paged.block_size) + pool.shape[2:])


def _attn_decode(bp: dict, cfg: ArchConfig, cache: dict, x: torch.Tensor,
                 pos, plans=None, tables=None,
                 paged: PagedLayout | None = None) -> torch.Tensor:
    """Single-token attention against the cache (written in place). With
    ``tables``/``paged`` the cache leaves are block pools: the new token
    goes into each slot's current block and attention reads a block-table
    gather of the slot's history."""
    B = x.shape[0]
    if isinstance(pos, int):
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
    else:
        positions = pos[:, None]
    q, k_new, v_new = L.qkv_project(bp["core"], cfg, x, positions, plans)
    for name, new in _kv_entries(cache, k_new, v_new).items():
        if tables is None:
            _write_token(cache[name], new, pos)
        else:
            _paged_write_token(cache[name], new, pos, tables, paged)
    view = None if tables is None else functools.partial(
        _paged_gather, tables=tables, paged=paged)
    k_all, v_all = _kv_read(cache, x.dtype, view)
    out = L.chunked_attention(q, k_all, v_all, q_positions=positions,
                              kv_len=pos + 1, causal=True)
    return L.pim_matmul(out.reshape(B, 1, -1), bp["core"]["wo"],
                        L.plan_leaf(plans, "wo"), cfg)


def decode_step(params: dict, cfg: ArchConfig, state: dict,
                tokens: torch.Tensor, plans=None, *, block_tables=None,
                paged: PagedLayout | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1) ids. Every slot's position advances
    by one and every slot's recurrent carries take a step (the engines
    overwrite an idle or mid-prefill slot's carries when they insert its
    prefill); the caches are updated in place.

    With a paged state pass ``block_tables`` ((B, max_blocks) int64 pool
    rows on the state's device, ``paged.sentinel`` for unmapped entries)
    and the matching ``paged`` layout: each slot writes its token into its
    current block and attends over a block-table gather, bit-identical to
    a contiguous cache when ``max_blocks * block_size == max_len``. Slots
    the caller does not want touched get an all-sentinel row.

    With ``params`` placed as DTensors on the active mesh under
    SERVE_RULES or MULTIPOD_SERVE_RULES the step is partitioned
    (``_decode_partitioned``): ``tokens`` whole, the state placed by
    ``cache_specs``, the logits the rank's vocab block."""
    with tracing.span("model.decode_step"):
        if (block_tables is None) != (paged is None):
            raise ValueError("block_tables and paged must be passed together")
        part = partition(params, cfg, decode=True)
        if part is not None:
            if block_tables is not None or plans is not None:
                raise ValueError(
                    "a partitioned decode takes a contiguous state and no "
                    "plans: the reference's paged pools run only in its "
                    "unmeshed engines")
            return _decode_partitioned(part, params, cfg, state, tokens)
        pos = state["pos"]
        if block_tables is not None and isinstance(pos, int):
            raise ValueError("paged decode needs per-slot positions "
                             "(init_decode_state(..., per_slot_pos=True))")
        x = embed_inputs(params, cfg, tokens)

        def attend(bp, cache, h, core_plan):
            return _attn_decode(bp, cfg, cache, h, pos, plans=core_plan,
                                tables=block_tables, paged=paged)
        for layer, (bp, cache, plan) in enumerate(zip(
                params["layers"], state["caches"], _layer_plans(cfg, plans))):
            x = run_layer(bp, cfg, layer, x, cache, plan, attend)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.lm_head(params["embed"], cfg, x, plan=_head_plan(plans))
        return logits, {"caches": state["caches"], "pos": pos + 1}


# ------------------------------------------------------------------ prefill
def _prefill_layers(params: dict, cfg: ArchConfig, x: torch.Tensor,
                    caches: list, positions: torch.Tensor, plans, attend):
    """Run a prompt chunk at ``positions`` through every layer.
    ``attend(cache, q, k, v)`` stores the chunk's K/V into an attention
    layer's cache in place and returns the attention output (B, C, H,
    hd); recurrent layers continue their carries."""
    B, C = x.shape[0], x.shape[1]

    def attn_core(bp, cache, hn, core_plan):
        q, k, v = L.qkv_project(bp["core"], cfg, hn, positions, core_plan)
        o = attend(cache, q, k, v)
        return L.pim_matmul(o.reshape(B, C, -1), bp["core"]["wo"],
                            L.plan_leaf(core_plan, "wo"), cfg)
    with L.suspend_pim_stats():
        for layer, (bp, cache, plan) in enumerate(zip(
                params["layers"], caches, _layer_plans(cfg, plans))):
            x = run_layer(bp, cfg, layer, x, cache, plan, attn_core)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    # contiguous: the CPU BLAS may round a strided row differently
    return L.lm_head(params["embed"], cfg, x[:, -1:].contiguous(),
                     plan=_head_plan(plans))


def _store_span(cache: dict, k: torch.Tensor, v: torch.Tensor,
                pos0: int) -> None:
    for name, val in _kv_entries(cache, k, v).items():
        cache[name][:, pos0:pos0 + val.shape[1]] = val


def partitioned(cfg: ArchConfig) -> bool:
    """Whether the partitioned train, prefill and decode programs cover
    ``cfg``: every layer one of the kinds they partition, attention (a
    dense MLP or an expert-parallel MoE FFN), mamba over its d_inner
    channels and rwkv6 over whole heads. All eleven configs are."""
    return set(cfg.block_pattern) <= {"attn", "mamba", "rwkv"}


def partition(params: dict, cfg: ArchConfig, *, decode: bool = False):
    """The ``dist.parallel.Partition`` of ``params`` (with ``decode``, the
    ``ServePartition``) when they are DTensors on the active mesh (what
    turns the partitioned programs on), else None. Raises where the
    partitioned program cannot run: a config it does not cover,
    ``pim_mode`` other than ``"off"`` (the reference runs its meshed
    programs in float), or a rule set the program does not take."""
    if not parallel.placed(params):
        return None
    if not partitioned(cfg):
        raise ValueError(
            f"{cfg.name}: the partitioned programs cover attention, mamba "
            f"and rwkv layers, not {cfg.block_pattern}")
    if cfg.pim_mode != "off":
        raise ValueError(
            f"pim_mode={cfg.pim_mode!r} under a partition: the partitioned "
            "programs run in float (pim_mode='off'), as the reference's "
            "meshed programs do")
    if decode:
        return parallel.serve_partition(dsh.active_mesh(), cfg, params,
                                        param_specs(cfg))
    return parallel.Partition(dsh.active_mesh(), cfg, param_specs(cfg),
                              params)


def _attn_decode_partitioned(part, path: str, bp: dict, cfg: ArchConfig,
                             cache: dict, x: torch.Tensor, pos,
                             positions: torch.Tensor, rows,
                             seq) -> torch.Tensor:
    """``_attn_decode`` under the partitioned decode: ``x`` (B, 1, D) whole,
    ``bp`` the rank's weight blocks of the layer at ``path``
    (``layers/3/``), ``cache`` its block of ``rows.local``
    rows by ``seq.local`` positions (``ServePartition.cache_layout``).
    q/k/v from the stored column blocks, gathered into whole heads; the
    rank's rows write where its block holds their positions; split-KV
    attention over the block, combined over the positions' group; the
    output gathered over the rows' group into the row-parallel ``wo``."""
    q, k_new, v_new = L.qkv_project(
        bp["core"], cfg, x, positions,
        cols=lambda t, name: part.gather_cols(t, f"{path}core/{name}"))
    b0, nb, s0 = rows.start, rows.local, seq.start
    q, k_new, v_new = (t[b0:b0 + nb] for t in (q, k_new, v_new))
    mine = pos if isinstance(pos, int) else pos[b0:b0 + nb]
    for name, new in _kv_entries(cache, k_new, v_new).items():
        _write_token(cache[name], new, mine, s0)
    k_blk, v_blk = _kv_read(cache, x.dtype)
    acc, m, l = L.split_kv_attention(q, k_blk, v_blk, kv_len=mine + 1,
                                     k_offset=s0)
    out = parallel.combine_attention(acc, m, l, seq.group).to(x.dtype)
    out = parallel.all_gather(out.reshape(nb, 1, -1), 0, rows.group)
    y = L.pim_matmul(part.block(out, path + "core/wo"), bp["core"]["wo"],
                     None, cfg)
    return part.reduce(y, path + "core/wo")


def _decode_partitioned(part, params: dict, cfg: ArchConfig, state: dict,
                        tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """``decode_step`` under the partitioned decode (``dist.parallel``):
    ``tokens`` whole, ``state`` placed by ``cache_specs`` (DTensor caches,
    written in place through their local blocks; ``pos`` global). Returns
    the rank's vocab block of the logits (B, 1, V / |vocab group|) and the
    state."""
    rows, seq = part.cache_layout(state["caches"])
    pos = state["pos"]
    glob = pos.to_local() if hasattr(pos, "to_local") else pos
    local = part.local
    if cfg.input_mode == "tokens":
        emb = part.leaf["embed/embed"]
        x = L.embed(local["embed"], tokens, v0=emb.start,
                    reduce=None if emb.dim is None
                    else functools.partial(part.reduce, path="embed/embed"))
    else:
        x = embed_inputs(local, cfg, tokens)
    B = x.shape[0]
    if isinstance(glob, int):
        positions = torch.full((B, 1), glob, dtype=torch.int64,
                               device=x.device)
    else:
        positions = glob[:, None]
    for layer, (bp, cache) in enumerate(zip(local["layers"],
                                            state["caches"])):
        path = f"layers/{layer}/"
        blocks = {k: t.to_local() for k, t in cache.items()}
        kind = block_kind(cfg, layer)

        def attend(bp, _, h, core_plan, path=path, blocks=blocks):
            return _attn_decode_partitioned(part, path, bp, cfg, blocks, h,
                                            glob, positions, rows, seq)

        def ffn(bp, h, path=path, layer=layer):
            if L.is_moe_layer(cfg, layer):
                return L.moe_block(
                    bp["ffn"], cfg, h, experts=part.experts(path + "ffn/w1"),
                    reduce=lambda y: part.reduce(y, path + "ffn/w1"))
            return L.mlp_block(
                bp["ffn"], cfg, h,
                rows=lambda t: part.rows_for(t, path + "ffn/w1",
                                             path + "ffn/w2"),
                reduce=lambda y: part.reduce(y, path + "ffn/w2"))
        x = run_layer(bp, cfg, layer, x, blocks, None, attend, ffn=ffn,
                      serve=part.layer(path, rows))
        if kind != "attn":  # the new carries, into the state's blocks
            for k, t in cache.items():
                t.to_local().copy_(blocks[k])
    x = L.rmsnorm(local["final_norm"], x, cfg.norm_eps)
    logits = L.lm_head(local["embed"], cfg, x)
    return logits, {"caches": state["caches"], "pos": pos + 1}


def _prefill_partitioned(part, params: dict, cfg: ArchConfig,
                         inputs: torch.Tensor, max_len, plans):
    """``prefill`` under a partition: ``inputs`` are this rank's rows of
    the prompts; returns this rank's block of the last-position logits
    (its vocab shard) and of the state in the layout that ``cache_specs``
    resolves to under the bound rules (``cache_batch`` over the batch
    axes, ``seq``, ``tp`` and ``heads`` over the model axis), the
    reference's ``out_shardings``: attention caches ``(rows, S / |model|,
    K, hd)``, each rank writing every K/V head of its own positions,
    projected with the whole ``wk``/``wv``; recurrent carries of the
    rank's rows (``_carry_blocks``)."""
    S = inputs.shape[1]
    if max_len not in (None, S) or plans is not None:
        raise ValueError("a partitioned prefill fills caches of the prompt's "
                         "length and takes no plans")
    local = parallel.local(params)
    x = embed_inputs(local, cfg, inputs, part)
    B = x.shape[0]
    positions = torch.arange(S, device=x.device).expand(B, S)
    block = part.seq_block(positions)
    caches = []
    with L.suspend_pim_stats():
        for layer, bp in enumerate(local["layers"]):
            path = f"layers/{layer}"
            kind = block_kind(cfg, layer)
            kv_w = {k: part.whole(t, f"{path}/core/{k}")
                    for k, t in bp["core"].items()
                    if kind == "attn" and k in _KV_LEAVES}
            cache = {} if kind == "attn" else _init_carry(
                cfg, kind, B, x.device, part)

            def attend(bp, cache, h, core_plan, kv_w=kv_w):
                k, v = L.kv_project(kv_w, cfg, h, block)
                cache.update(_cache_entries(cfg, k, v))
                return L.attention_block(bp["core"], cfg, h, positions,
                                         part=part)
            x = run_layer(part.weights(bp, path), cfg, layer, x, cache, None,
                          attend, part)
            caches.append(cache if kind == "attn"
                          else _carry_blocks(part, kind, cache))
    x = L.rmsnorm(part.weights(local["final_norm"], "final_norm"), x,
                  cfg.norm_eps)
    last = parallel.all_gather(x[:, -1:].contiguous(), 1, part.model)[:, -1:]
    head = part.weight(local["embed"]["head"], "embed/head")
    logits = L.lm_head({"head": head}, cfg, last.contiguous())
    return logits, {"caches": caches, "pos": S}


_KV_LEAVES = ("wk", "wv", "bk", "bv", "k_norm")


def _carry_blocks(part, kind: str, carry: dict) -> dict:
    """A partitioned prefill's carry (the rank's d_inner block or heads)
    in the layout of ``cache_specs`` under the bound rules: a ``tp`` or
    ``heads`` dim that the model axis splits evenly keeps the rank's
    block; one that ``fit_spec_to_shape`` leaves replicated (its size
    not a multiple of the axis) is gathered whole."""
    out = {}
    for name, axes in _CARRY_SPECS[kind].items():
        t = carry[name]
        for d, ax in enumerate(axes):
            if ax in ("tp", "heads"):
                n = part.di if ax == "tp" else part.rwkv_n
                spec = dsh.fit_spec_to_shape(dsh.spec_for((ax,), part.mesh),
                                             (n,), part.mesh)
                if not spec or spec[0] is None:
                    t = part.gather_blocks(t, d, n)
        out[name] = t
    return out


def _cache_entries(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor) -> dict:
    """K/V as a cache of ``cfg.kv_cache_dtype`` stores them."""
    dt = getattr(torch, cfg.kv_cache_dtype)
    if dt == torch.int8:
        return _kv_entries({"k_scale": None}, k, v)
    return {"k": k.to(dt), "v": v.to(dt)}


def prefill(params: dict, cfg: ArchConfig, inputs: torch.Tensor,
            max_len: int | None = None,
            plans=None) -> tuple[torch.Tensor, dict]:
    """Process a prompt (tokens (B, S) or embeddings (B, S, D)), returning
    last-position logits and a filled decode state (caches sized to
    ``max_len``, default the prompt). Attention reads this call's raw
    K/V; an int8 cache stores their codes.

    With ``params`` placed as DTensors on the active mesh the prefill is
    partitioned (``_prefill_partitioned``): ``inputs`` are the rank's
    rows, and the logits and state are the rank's blocks."""
    part = partition(params, cfg)
    if part is not None:
        return _prefill_partitioned(part, params, cfg, inputs, max_len,
                                    plans)
    x = embed_inputs(params, cfg, inputs)
    B, S = x.shape[0], x.shape[1]
    state = init_decode_state(cfg, B, max_len or S, device=x.device)
    positions = torch.arange(S, device=x.device).expand(B, S)

    def attend(cache, q, k, v):
        _store_span(cache, k, v, 0)
        return L.chunked_attention(q, k, v, q_positions=positions, kv_len=S,
                                   causal=cfg.causal)
    logits = _prefill_layers(params, cfg, x, state["caches"], positions,
                             plans, attend)
    return logits, {"caches": state["caches"], "pos": S}


def prefill_chunk(params: dict, cfg: ArchConfig, state: dict,
                  tokens: torch.Tensor,
                  plans=None) -> tuple[torch.Tensor, dict]:
    """Process the next prompt chunk of an in-flight (chunked) prefill.

    ``state`` is a scalar-pos decode state whose caches hold positions
    ``[0, state["pos"])``; ``tokens`` (B, C) continue the prompt there and
    attend over the cache, which holds the earlier chunks; recurrent
    carries continue from the state. Over a whole prompt this reproduces
    ``prefill`` for float KV caches; an int8 cache adds one
    quantize/dequantize round trip per chunk boundary.
    """
    with tracing.span("model.prefill_chunk"):
        x = embed_inputs(params, cfg, tokens)
        B, C = x.shape[0], x.shape[1]
        pos0 = state["pos"]
        positions = (pos0 + torch.arange(C, device=x.device)).expand(B, C)

        def attend(cache, q, k, v):
            _store_span(cache, k, v, pos0)
            k_all, v_all = _kv_read(cache, x.dtype)
            return L.chunked_attention(q, k_all, v_all, q_positions=positions,
                                       kv_len=pos0 + C, causal=True)
        logits = _prefill_layers(params, cfg, x, state["caches"], positions,
                                 plans, attend)
        return logits, {"caches": state["caches"], "pos": pos0 + C}


def insert_request(state: dict, one: dict, slot: int) -> dict:
    """Splice a batch-1 scalar-pos state into slot ``slot`` of a per-slot
    state, in place: every cache row of the slot is replaced, scales and
    recurrent carries included."""
    for cache, c1 in zip(state["caches"], one["caches"]):
        for key in cache:
            cache[key][slot] = c1[key][0].to(cache[key].dtype)
    state["pos"][slot] = one["pos"]
    return state


# ------------------------------------------------------------------ paged
def prefill_chunk_paged(params: dict, cfg: ArchConfig, state: dict,
                        tokens: torch.Tensor, *, slot: int,
                        table_row: torch.Tensor, pos0: int,
                        paged: PagedLayout,
                        plans=None) -> tuple[torch.Tensor, dict]:
    """Advance one slot's in-flight prefill inside the shared block pool:
    the prompt streams straight into the slot's claimed blocks.

    ``tokens`` (1, C) is the next prompt chunk of ``slot``, whose earlier
    context — refcount-shared prefix blocks included — is read back
    through ``table_row`` ((max_blocks,) int64 pool rows on the state's
    device). ``pos0`` is the chunk's absolute start, passed by the host
    because the batched ``pos[slot]`` advances with every decode step
    interleaved while the slot is still prefilling (those writes land in
    the scratch row); ``pos[slot]`` is set to ``pos0 + C`` on return, so a
    finished prefill leaves the slot decode-ready.

    Attention-only patterns: recurrent carries cannot be rebuilt from
    paged context, so those archs stage their prefill at B=1 and hand it
    over through ``insert_request_paged``.
    """
    bad = [k for k in cfg.block_pattern if k != "attn"]
    if bad:
        raise ValueError(
            f"prefill_chunk_paged supports attention-only patterns; "
            f"{cfg.name} has {bad} blocks — stage the prefill at B=1 and "
            f"use insert_request_paged")
    x = embed_inputs(params, cfg, tokens)
    B, C = x.shape[0], x.shape[1]
    abs_pos = pos0 + torch.arange(C, device=x.device)
    positions = abs_pos.expand(B, C)
    rows_c = table_row[(abs_pos // paged.block_size).clamp(
        0, table_row.shape[0] - 1)]
    offs_c = abs_pos % paged.block_size
    view = functools.partial(_paged_gather, tables=table_row[None],
                             paged=paged)

    def attend(cache, q, k, v):
        for name, val in _kv_entries(cache, k, v).items():
            cache[name][rows_c, offs_c] = val[0]
        k_all, v_all = _kv_read(cache, x.dtype, view)
        return L.chunked_attention(q, k_all, v_all, q_positions=positions,
                                   kv_len=pos0 + C, causal=True)
    logits = _prefill_layers(params, cfg, x, state["caches"], positions,
                             plans, attend)
    state["pos"][slot] = pos0 + C
    return logits, state


def insert_request_paged(state: dict, one: dict, slot: int,
                         table_row: torch.Tensor,
                         paged: PagedLayout) -> dict:
    """Scatter a contiguous B=1 prefilled state into a slot's pool blocks,
    in place: position ``p`` of every attention cache leaf goes to pool
    row ``table_row[p // block_size]`` at offset ``p % block_size``
    (sentinel rows absorb the unused tail in scratch); recurrent carries
    and ``pos[slot]`` are spliced as ``insert_request`` splices them. The
    staged-admission path of recurrent archs; attention-only engines
    prefill in the pool instead."""
    bs = paged.block_size
    for cache, c1 in zip(state["caches"], one["caches"]):
        if "k" not in cache:  # a recurrent carry: per-slot batch axis
            for key in cache:
                cache[key][slot] = c1[key][0].to(cache[key].dtype)
            continue
        p = torch.arange(c1["k"].shape[1], device=table_row.device)
        rows = table_row[(p // bs).clamp(0, table_row.shape[0] - 1)].clamp(
            0, paged.sentinel)
        for key in cache:
            cache[key][rows, p % bs] = c1[key][0].to(cache[key].dtype)
    state["pos"][slot] = one["pos"]
    return state
