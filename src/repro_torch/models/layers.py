"""Transformer building blocks (attention models), plain PyTorch.

Port of ``repro.models.layers``: the PIM projection dispatcher with its
work-stats collector, RMSNorm, RoPE, QKV projection, chunked online-softmax
attention, the gated MLP, the top-k mixture-of-experts FFN, embedding and
the LM head. Attention is plain
tensor code with the reference's online-softmax math (the reference wrote
it in jnp, not Pallas). Layouts follow the reference: q ``(B, S, H, D)``,
k/v ``(B, S, K, D)``, weights ``(d_in, d_out)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import adc as adc_lib
from repro_torch.core import backends as device_backends
from repro_torch.core import center_offset as co
from repro_torch.core import pim_linear
from repro_torch.obs import tracing
from repro_torch.quant import quantize as quantlib

ATTN_CHUNK = 512

# ------------------------------------------------------------------ pim
# Work-stats collector. ``collect_pim_stats()`` pushes a sink; while one is
# active, every exact-mode ``pim_matmul`` records its per-pass
# SpeculationStats (speculation on) or CrossbarStats (speculation off)
# into the innermost sink. Prefill and full-sequence forwards suspend
# collection around their layer stacks, as the reference does, so a
# collector around a whole serve run sees decode-step work plus the
# prefill LM head. A region wrapped in ``with_pim_stats`` (an engine's
# decode step, when its telemetry asks for PIM stats) collects into a
# sink of its own and re-records its summed ``DeviceTotals`` into the
# enclosing sink, so an outer collector's totals are the same with
# telemetry on or off; the telemetry itself bills the decode step alone,
# as the reference's does.
_PIM_STATS_SINKS: list[list] = []

# total-able work-stat fields; ``conversions_possible`` is the static
# path's name for the no-speculation baseline
PIM_STAT_KEYS = ("adc_converts", "no_spec_converts", "spec_failures",
                 "spec_attempts", "recovery_saturations", "cycles", "macs")
_STAT_ALIASES = {"no_spec_converts": "conversions_possible"}
# the fields a stats object may hold as a device tensor (K2's counters);
# every other field is a shape-static Python int
PIM_DEVICE_KEYS = ("adc_converts", "spec_failures", "recovery_saturations")


@contextlib.contextmanager
def collect_pim_stats():
    """Collect exact-path work stats from every ``pim_matmul`` run in the
    body. Yields the sink list; reduce it with ``pim_stats_totals``."""
    sink: list = []
    _PIM_STATS_SINKS.append(sink)
    try:
        yield sink
    finally:
        _PIM_STATS_SINKS.remove(sink)


@contextlib.contextmanager
def suspend_pim_stats():
    """Mask all active sinks (prefill and full-sequence layer stacks)."""
    saved = _PIM_STATS_SINKS[:]
    _PIM_STATS_SINKS.clear()
    try:
        yield
    finally:
        _PIM_STATS_SINKS.extend(saved)


def pim_stats_active() -> bool:
    return bool(_PIM_STATS_SINKS)


def pim_stats_record(entry) -> None:
    """Append a stats object / totals to the innermost active sink."""
    if _PIM_STATS_SINKS:
        _PIM_STATS_SINKS[-1].append(entry)


@dataclasses.dataclass(frozen=True)
class DeviceTotals:
    """A sink's work totals before any host sync: ``static`` holds every
    ``PIM_STAT_KEYS`` field's Python-int part, ``counts`` the tensor parts
    of ``PIM_DEVICE_KEYS`` summed on the device into one int64 tensor of
    that length (None when no entry held a tensor, as on K1's path)."""
    static: dict
    counts: torch.Tensor | None

    def host(self, counts: torch.Tensor | None = None) -> dict:
        """``{field: int}``. ``counts`` is ``self.counts`` already fetched
        to the host (the engines fetch it right after the logits); without
        it, this fetches ``self.counts`` (one sync)."""
        tot = dict(self.static)
        if self.counts is not None:
            fetched = self.counts if counts is None else counts
            for k, v in zip(PIM_DEVICE_KEYS, fetched.tolist()):
                tot[k] += v
        return tot


def _stat_field(st, k: str):
    """Field ``k`` of a stats object or totals dict; a field a stats type
    lacks counts 0, after its alias (``_STAT_ALIASES``)."""
    if isinstance(st, dict):
        return st.get(k, 0)
    v = getattr(st, k, None)
    return getattr(st, _STAT_ALIASES.get(k, k), 0) if v is None else v


def pim_stats_device_totals(stats) -> DeviceTotals:
    """Sum a sink's entries (SpeculationStats / CrossbarStats objects,
    totals dicts, ``DeviceTotals``) without a host sync: the tensor
    fields with one ``torch.stack(...).sum(0)`` each and one stack of the
    three sums, however many projections the region ran."""
    static = dict.fromkeys(PIM_STAT_KEYS, 0)
    parts: dict = {k: [] for k in PIM_DEVICE_KEYS}
    for st in stats:
        if isinstance(st, DeviceTotals):
            for k in PIM_STAT_KEYS:
                static[k] += st.static[k]
            if st.counts is not None:
                for k, v in zip(PIM_DEVICE_KEYS, st.counts):
                    parts[k].append(v)
            continue
        for k in PIM_STAT_KEYS:
            v = _stat_field(st, k)
            if isinstance(v, torch.Tensor):
                parts[k].append(v)  # only PIM_DEVICE_KEYS may be tensors
            else:
                static[k] += int(v)
    tensors = [v for vs in parts.values() for v in vs]
    if not tensors:
        return DeviceTotals(static, None)
    sums = [torch.stack(vs).sum(0) if vs else tensors[0].new_zeros(())
            for vs in parts.values()]
    return DeviceTotals(static, torch.stack(sums).to(torch.int64))


def pim_stats_totals(stats) -> dict:
    """Sum a sink's entries into one ``{field: int}`` dict (one host sync
    for the data-dependent fields)."""
    return pim_stats_device_totals(stats).host()


def with_pim_stats(fn):
    """Wrap ``fn`` so it also returns its summed work totals.

    ``fn``'s body runs under :func:`collect_pim_stats`; the wrapper
    appends the sink's :class:`DeviceTotals` to ``fn``'s return (tuple
    returns are extended, single returns become a pair) and records them
    into the enclosing sink, if any. Nothing syncs: the serve engines
    fetch ``counts`` right after the logits, so stats collection adds no
    host sync inside a step.
    """
    def wrapped(*args, **kwargs):
        with collect_pim_stats() as acc:
            out = fn(*args, **kwargs)
        totals = pim_stats_device_totals(acc)
        pim_stats_record(totals)
        if isinstance(out, tuple):
            return out + (totals,)
        return out, totals
    return wrapped


class PimTap:
    """Calibration recorder: stands in for a plan leaf during the capture
    forward of ``models.pim_compile``. ``pim_matmul`` records the
    projection's input activations (float32, ``(N, d_in)``) and runs the
    float path; an expert projection records its dispatch buffer
    ``(E, N, d_in)``, zero rows included."""

    def __init__(self):
        self.x: list[torch.Tensor] = []

    def record(self, x: torch.Tensor) -> None:
        self.x.append(x.detach().to(torch.float32))


def _plan_to_pim_plan(plan: dict, cfg: ArchConfig,
                      rows: int) -> pim_linear.PimPlan:
    """Rebuild a ``PimPlan`` from a plan-leaf dict + the static cfg.

    The weight slicing is per site: exact leaves carry ``slice_shifts``.
    ``compile_pim_params`` stores all-zero planes past each instance's
    slice count, so the planes are used as stored (the reference zeroes
    them again on every call, a full copy of the planes per projection).
    """
    lq = quantlib.LayerQuant(
        w_scale=plan["w_scale"], x_scale=plan["x_scale"], x_zero_point=0,
        x_signed=True, out_scale=torch.ones((), dtype=torch.float32),
        out_zero_point=0, bias=None)
    enc = None
    if "planes" in plan:
        enc = co.EncodedWeights(
            planes=plan["planes"], centers=plan["enc_centers"], slicing=None,
            shifts=plan["slice_shifts"], rows=rows,
            rows_per_xbar=co.ROWS_PER_CROSSBAR)
    return pim_linear.PimPlan(
        enc=enc, lq=lq, w_q=plan["w_q"],
        adc=adc_lib.ADCConfig(bits=cfg.pim_adc_bits, signed=True),
        speculation=cfg.pim_speculation,
        device=device_backends.make(cfg.pim_crossbar_backend,
                                    cfg.pim_device_corner,
                                    seed=cfg.pim_device_seed),
        fast_w_off=plan.get("w_off"), fast_centers=plan.get("centers"),
        fast_scale=plan.get("scale"))


def pim_matmul(x: torch.Tensor, w: torch.Tensor, plan,
               cfg: ArchConfig) -> torch.Tensor:
    """One weight-static projection ``x (..., R) @ w (R, C)``, routed
    through ``cfg.pim_mode``:

      off   — the float product (also when ``plan`` is None);
      fast  — centered int8 matmul + center term (kernel K3);
      exact — the bit-exact accelerator datapath (kernel K2, or K1 with
              ``cfg.pim_speculation`` off; on a ``nonideal`` crossbar
              backend the die's loop, no kernel);
      int8  — the ideal 8b-quantized reference ``exact`` equals at a
              non-saturating ADC.

    With a span recorder installed (``repro_torch.obs.tracing``), each
    call through a plan is a ``pim.call`` span (args: rows, R, C, mode);
    the plan's rebuild inside it is a ``pim.plan`` span, the kernels'
    tables and launches ``pim.tables`` and ``pim.launch`` (``kernels.ops``).
    """
    if isinstance(plan, PimTap):
        plan.record(x.reshape(-1, x.shape[-1]))
        plan = None
    if plan is None or cfg.pim_mode == "off":
        return x @ w
    rec = tracing.ACTIVE
    if rec is None:
        return _pim_project(x, w, plan, cfg)
    with rec.region("pim.call", (x.numel() // x.shape[-1], w.shape[0],
                                 w.shape[-1], cfg.pim_mode)):
        return _pim_project(x, w, plan, cfg)


def _pim_project(x: torch.Tensor, w: torch.Tensor, plan,
                 cfg: ArchConfig) -> torch.Tensor:
    """``pim_matmul``'s projection through a plan."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).to(torch.float32)
    with tracing.span("pim.plan"):
        pp = _plan_to_pim_plan(plan, cfg, rows=w.shape[0])
    if cfg.pim_mode == "fast":
        y = pim_linear.forward_fast(xb, pp)
    elif cfg.pim_mode == "exact":
        y, st = pim_linear.forward_exact(xb, pp, return_stats=True)
        if _PIM_STATS_SINKS:
            _PIM_STATS_SINKS[-1].extend(st)
    elif cfg.pim_mode == "int8":
        y = pim_linear.forward_int_reference(xb, pp)
    else:
        raise ValueError(f"unknown pim_mode {cfg.pim_mode!r}")
    return y.reshape(lead + (w.shape[-1],)).to(x.dtype)


def plan_leaf(plans, key: str):
    """``plans[key]`` tolerating an absent plan tree (float path)."""
    return None if plans is None else plans.get(key)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax default
            "relu2": lambda x: torch.square(F.relu(x))}[name]


# ------------------------------------------------------------------ norms
def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Variance accumulated in float32; the apply stays in x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).sum(dim=-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * params["scale"]


# ------------------------------------------------------------------ rope
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) int."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ attention
def _head_proj(params: dict, cfg: ArchConfig, x: torch.Tensor, name: str,
               positions: torch.Tensor, plans=None,
               cols=None) -> torch.Tensor:
    """One of q/k/v (``name``): ``x @ w{name}`` plus its bias, as (B, S,
    heads, hd) with the heads counted from the weight's width; q and k
    also normed (``qk_norm``) and rotated. ``cols(t, "w{name}")`` makes a
    column block whole before the heads are formed (the partitioned
    decode's gather)."""
    B, S, _ = x.shape
    t = pim_matmul(x, params["w" + name], plan_leaf(plans, "w" + name), cfg)
    if cfg.qkv_bias:
        t = t + params["b" + name]
    if cols is not None:
        t = cols(t, "w" + name)
    t = t.reshape(B, S, -1, cfg.resolved_head_dim)
    if name == "v":
        return t
    if cfg.qk_norm:
        t = rmsnorm({"scale": params[name + "_norm"]}, t, cfg.norm_eps)
    return rope(t, positions, cfg.rope_theta)


def qkv_project(params: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, plans=None, cols=None):
    """x (B, S, D) -> q (B,S,H,hd), k/v (B,S,K,hd), RoPE applied. The head
    counts are the weights' widths over ``hd``: a partitioned rank's
    ``wq``/``wk`` hold its own heads (``dist.parallel``); under the
    partitioned decode its column blocks, made whole by ``cols``."""
    return tuple(_head_proj(params, cfg, x, n, positions, plans, cols)
                 for n in "qkv")


def kv_project(params: dict, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor):
    """The K/V half of ``qkv_project`` (a partitioned prefill's cache
    block: every K/V head of the rank's positions)."""
    return tuple(_head_proj(params, cfg, x, n, positions) for n in "kv")


def _kv_limit(kv_len, device):
    """``kv_len`` as something ``positions < limit`` broadcasts against:
    a Python int stays one (no host-to-device copy), a (B,) tensor becomes
    a (B, 1) column."""
    if isinstance(kv_len, int):
        return kv_len
    t = torch.as_tensor(kv_len, device=device)
    return t if t.ndim == 0 else t[:, None]


def _attend_chunk(qg, k, v, m, l, acc, c0: int, chunk: int,
                  q_positions, limit, causal: bool):
    """One KV chunk's step of ``chunked_attention``'s online softmax:
    (m, l, acc) after the chunk at ``c0``."""
    kb = k[:, c0:c0 + chunk].to(torch.float32)
    vb = v[:, c0:c0 + chunk].to(torch.float32)
    kpos = c0 + torch.arange(kb.shape[1], device=qg.device)
    valid = kpos[None, :] < limit  # (B|1, chunk)
    mask = valid[:, None, None, None, :]
    if causal:
        cm = kpos[None, None, :] <= q_positions[:, :, None]
        mask = mask & cm[:, :, None, None, :]
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb) * (qg.shape[-1] ** -0.5)
    s = torch.where(mask, s, -torch.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
    return m_new, l, acc


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_len,
                      causal: bool, chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash-style, exact).

    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H = K * G.
    q_positions: (B, Sq) global positions of the queries (causal mask).
    kv_len: number of valid KV entries (int or (B,)) — masks cache padding.
    While autograd records over more than one chunk, each chunk's step runs
    under ``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint(body)``: the backward recomputes a chunk's scores
    instead of keeping every chunk's.
    """
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    G = H // max(K, 1)  # a partitioned rank may hold no heads
    limit = _kv_limit(kv_len, q.device)
    if Sq == 1:  # decode: one query, one softmax over the whole cache
        qg1 = q.reshape(B, K, G, D).to(torch.float32)
        s = torch.einsum("bkgd,bckd->bkgc", qg1,
                         k.to(torch.float32)) * (D ** -0.5)
        mask = torch.arange(Sk, device=q.device)[None, :] < limit  # (B|1, Sk)
        s = torch.where(mask[:, None, None, :], s, -torch.inf)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgc,bckd->bkgd", p, v.to(torch.float32))
        return out.reshape(B, 1, H, D).to(q.dtype)
    qg = q.reshape(B, Sq, K, G, D).to(torch.float32)
    m = torch.full((B, Sq, K, G), -torch.inf, device=q.device)
    l = torch.zeros((B, Sq, K, G), device=q.device)
    acc = torch.zeros((B, Sq, K, G, D), device=q.device)
    remat = Sk > chunk and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for c0 in range(0, Sk, chunk):
        args = (qg, k, v, m, l, acc, c0, chunk, q_positions, limit, causal)
        m, l, acc = (checkpoint(_attend_chunk, *args, use_reentrant=False)
                     if remat else _attend_chunk(*args))
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.reshape(B, Sq, H, D).to(q.dtype)


def split_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, kv_len, k_offset: int):
    """Decode attention of one query a row over a block of keys at the
    global positions ``[k_offset, k_offset + Sk)``, the valid ones those
    below ``kv_len`` (int or (B,)): ``chunked_attention``'s ``Sq == 1``
    math before its normalisation. q: (B, 1, H, D); k, v: (B, Sk, K, D),
    cast to float32 here, the block alone. Returns float32 ``acc`` (B, 1,
    H, D), the sums of ``exp(s - m) v``, ``m`` (B, 1, H), the max score
    (``-inf`` where no key of the block is valid), and ``l`` (B, 1, H),
    the sums of ``exp(s - m)``: ``dist.parallel.combine_attention`` joins
    the blocks."""
    B, _, H, D = q.shape
    _, Sk, K, _ = k.shape
    G = H // K
    qg = q.reshape(B, K, G, D).to(torch.float32)
    s = torch.einsum("bkgd,bckd->bkgc", qg,
                     k.to(torch.float32)) * (D ** -0.5)
    kpos = k_offset + torch.arange(Sk, device=q.device)
    mask = kpos[None, :] < _kv_limit(kv_len, q.device)  # (B|1, Sk)
    s = torch.where(mask[:, None, None, :], s, -torch.inf)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])  # exactly 0 where masked
    acc = torch.einsum("bkgc,bckd->bkgd", p, v.to(torch.float32))
    return (acc.reshape(B, 1, H, D), m.reshape(B, 1, H),
            p.sum(dim=-1).reshape(B, 1, H))


def attention_block(params: dict, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, plans=None,
                    part=None) -> torch.Tensor:
    """Full-sequence attention (prefill / forward). Under a partition
    (``dist.parallel.Partition``) ``x`` is this rank's sequence block and
    ``params`` its heads' weights: the sequence is all-gathered before the
    column-parallel ``wq``/``wk``/``wv``, and the row-parallel ``wo``'s
    partial sums are reduce-scattered back onto the block."""
    if part is not None:
        x = part.gather_seq(x)
    B, S, _ = x.shape
    q, k, v = qkv_project(params, cfg, x, positions, plans)
    out = chunked_attention(q, k, v, q_positions=positions, kv_len=S,
                            causal=cfg.causal)
    y = pim_matmul(out.reshape(B, S, -1), params["wo"],
                   plan_leaf(plans, "wo"), cfg)
    return y if part is None else part.scatter_seq(y)


# ------------------------------------------------------------------ mlp
def mlp_block(params: dict, cfg: ArchConfig, x: torch.Tensor,
              plans=None, part=None, *, rows=None,
              reduce=None) -> torch.Tensor:
    """The gated MLP; under a partition, column-parallel ``w1``/``w3`` on
    the gathered sequence and a row-parallel ``w2`` reduce-scattered onto
    the rank's block (``attention_block``). The partitioned decode's hooks
    (its activations whole on every rank): ``rows(h)`` hands ``w1``/``w3``'s
    column block to ``w2``'s rows, and ``reduce(y)`` sums ``w2``'s partial
    products (``dist.parallel.ServePartition``)."""
    if part is not None:
        x = part.gather_seq(x)
    a = act_fn(cfg.activation)
    h = a(pim_matmul(x, params["w1"], plan_leaf(plans, "w1"), cfg)) \
        * pim_matmul(x, params["w3"], plan_leaf(plans, "w3"), cfg)
    if rows is not None:
        h = rows(h)
    y = pim_matmul(h, params["w2"], plan_leaf(plans, "w2"), cfg)
    if reduce is not None:
        return reduce(y)
    return y if part is None else part.scatter_seq(y)


# ------------------------------------------------------------------ moe
def _moe_group_size(E: int) -> int:
    """Dispatch-group length (slots), the reference's: large enough that
    per-group expert capacity is not over-quantized."""
    return 1024 if E >= 64 else 512


def is_moe_layer(cfg: ArchConfig, layer: int) -> bool:
    """Does layer ``layer`` (pattern index ``layer % len(pattern)``) have
    a MoE FFN?"""
    return cfg.moe_layer(layer % len(cfg.block_pattern))


def moe_capacity(cfg: ArchConfig, slots: int) -> tuple[int, int, int]:
    """``(group, n_groups, cap)`` for one batch row of ``slots`` (token,
    choice) slots: ``g = min(group size, slots)`` slots a dispatch group
    and ``cap = max(k, ceil(capacity_factor * g / E))`` kept slots per
    expert and group, the reference's rule."""
    E, k = cfg.n_experts, cfg.experts_per_token
    g = min(_moe_group_size(E), slots)
    cap = max(k, int(math.ceil(cfg.capacity_factor * g / E)))
    return g, -(-slots // g), cap


def moe_dispatch_rows(cfg: ArchConfig, B: int, S: int) -> int:
    """Rows of each expert's dispatch buffer (the rows its projections
    get) for ``moe_block`` on x (B, S, D); a decode step (S == 1, B > 1)
    is one dispatch group of B tokens."""
    if S == 1 and B > 1:
        B, S = 1, B
    _, n_groups, cap = moe_capacity(cfg, S * cfg.experts_per_token)
    return B * n_groups * cap


@dataclasses.dataclass
class MoeRoute:
    """One ``moe_block`` call's routing. Slots are ``(token, choice)``
    pairs in token-major order, padded with expert ``E`` ("none") to
    ``n_groups * group`` per batch row. A slot is kept iff its rank among
    the group's earlier slots of the same expert is below ``cap``; a kept
    slot sits at row ``(b * n_groups + n) * cap + pos`` of its expert's
    dispatch buffer."""
    expert: torch.Tensor   # (B, n_groups, group) int64, E for padding
    weight: torch.Tensor   # (B, n_groups, group) gate weight, x.dtype
    pos: torch.Tensor      # (B, n_groups, group) int64 rank in its expert
    keep: torch.Tensor     # (B, n_groups, group) bool
    group: int
    n_groups: int
    cap: int


def moe_route(params: dict, cfg: ArchConfig, x: torch.Tensor) -> MoeRoute:
    """Top-k routing with the reference's capacity rule (``moe_block`` of
    ``repro.models.layers``), for x (B, S, D).

    The router is float32, as in the reference; its logits are contracted
    in float64 and rounded to float32, so a token's logits do not depend
    on how many rows share the product (the engines then route a token
    alike at every batch size); they agree with the reference's float32
    einsum to a few ulp. ``torch.topk`` orders equal logits unlike
    ``jax.lax.top_k`` (which keeps the lower index first): a tie between
    float logits of random inputs does not occur in practice, and the
    parity tests use inputs without ties.
    """
    vals, idx = torch.topk(moe_logits(params, x), cfg.experts_per_token,
                           dim=-1)
    return route_choices(cfg, idx, vals, x.dtype)


def moe_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The router's float32 logits (B, S, E) of x (B, S, D), contracted in
    float64 (``moe_route``)."""
    B, S, _ = x.shape
    return (x.reshape(B * S, -1).to(torch.float64)
            @ params["router"].to(torch.float64)).to(torch.float32
                                                     ).reshape(B, S, -1)


def route_choices(cfg: ArchConfig, idx: torch.Tensor, vals: torch.Tensor,
                  dtype: torch.dtype) -> MoeRoute:
    """``moe_route`` from each token's chosen experts ``idx`` (B, S, k), in
    choice order, and their logits ``vals``: the gate weights (a sigmoid
    for top-1, else a softmax over the k) in ``dtype``, and the capacity
    rule over each dispatch group in slot order."""
    B, S, k = idx.shape
    E = cfg.n_experts
    weights = torch.sigmoid(vals) if k == 1 else torch.softmax(vals, dim=-1)
    slots = S * k
    g, n_groups, cap = moe_capacity(cfg, slots)
    pad = n_groups * g - slots
    fe = F.pad(idx.reshape(B, slots), (0, pad), value=E)
    fw = F.pad(weights.reshape(B, slots).to(dtype), (0, pad))
    fe = fe.reshape(B, n_groups, g)
    # rank within the expert, counted over the group in slot order (the
    # reference's float32 cumsum of one-hots; exact in int64 alike)
    eh = F.one_hot(fe, E + 1)[..., :E]
    pos = ((eh.cumsum(dim=2) - eh) * eh).sum(dim=-1)
    keep = (pos < cap) & (fe < E)
    return MoeRoute(expert=fe, weight=fw.reshape(B, n_groups, g), pos=pos,
                    keep=keep, group=g, n_groups=n_groups, cap=cap)


def _expert_matmul(buf: torch.Tensor, w: torch.Tensor, plan,
                   cfg: ArchConfig, e0: int = 0) -> torch.Tensor:
    """Per-expert projection ``buf (n, N, d_in) @ w (n, d_in, d_out)`` for
    the block of ``n`` experts from expert ``e0`` (every expert, or a
    partitioned rank's own). ``plan`` leaves carry a leading axis of every
    expert; ``pim_matmul`` runs once per expert on ``plan[e0 + e]``, every
    expert of the block, empty buffers included (the reference vmaps it).
    Work stats stay suspended, as in the reference: converts per token
    bill attention and the LM head, not the experts."""
    if isinstance(plan, PimTap):
        plan.record(buf)
        plan = None
    if plan is None or cfg.pim_mode == "off":
        return torch.matmul(buf, w)
    with suspend_pim_stats():
        return torch.stack([
            pim_matmul(buf[e], w[e], {k: v[e0 + e] for k, v in plan.items()},
                       cfg)
            for e in range(buf.shape[0])])


def moe_block(params: dict, cfg: ArchConfig, x: torch.Tensor,
              plans=None, part=None, *, experts=None,
              reduce=None) -> torch.Tensor:
    """Top-k capacity-based MoE FFN, the reference's function.

    The reference dispatches and combines with one-hot einsums; here the
    kept slots are scattered into a zeroed ``(E, B * n_groups * cap, D)``
    buffer and gathered back by row index (dropped and padding slots
    read a zero row), which keeps the same (token, expert, position)
    triples. Each slot's output is its gate weight times its expert row
    in ``x.dtype``, and the k choices of a token are summed in choice
    order, as the reference's combine does. A decode step (S == 1, B > 1)
    routes the whole batch as one dispatch group, so idle and mid-prefill
    slots compete for capacity, as in the reference.

    ``experts=(e0, e1)`` computes those experts alone, ``params``'
    expert leaves holding just them: the buffer holds their kept slots,
    and a slot routed to another expert contributes zero. Under a
    partition (``dist.parallel.Partition``) ``x`` is the rank's sequence
    block: the sequence is all-gathered, routed whole (capacity counts
    over whole dispatch groups), run through the rank's experts
    (``part.experts``) and reduce-scattered back onto the block, which
    sums every rank's experts. The partitioned decode's hook ``reduce(y)``
    sums the outputs of the ranks' expert blocks
    (``dist.parallel.ServePartition``).
    """
    if part is not None:
        return part.scatter_seq(moe_block(
            params, cfg, part.gather_seq(x), plans, experts=part.experts))
    if reduce is not None:
        return reduce(moe_block(params, cfg, x, plans, experts=experts))
    B, S, D = x.shape
    if S == 1 and B > 1:
        return moe_block(params, cfg, x.reshape(1, B, D), plans,
                         experts=experts).reshape(B, 1, D)
    k = cfg.experts_per_token
    e0, e1 = experts or (0, cfg.n_experts)
    n_e = e1 - e0
    rt = moe_route(params, cfg, x)
    n_rows = B * rt.n_groups * rt.cap  # dispatch rows per expert
    b = torch.arange(B, device=x.device)[:, None, None]
    n = torch.arange(rt.n_groups, device=x.device)[None, :, None]
    row = (rt.expert - e0) * n_rows + (b * rt.n_groups + n) * rt.cap + rt.pos
    # dropped and padding slots, and those of other experts, write to (and
    # read) one extra row
    mine = rt.keep & (rt.expert >= e0) & (rt.expert < e1)
    row = torch.where(mine, row, n_e * n_rows).reshape(-1)
    xg = F.pad(x.repeat_interleave(k, dim=1),
               (0, 0, 0, rt.n_groups * rt.group - S * k)).reshape(-1, D)
    buf = x.new_zeros((n_e * n_rows + 1, D))
    buf[row] = xg
    buf = buf[:-1].reshape(n_e, n_rows, D)
    a = act_fn(cfg.activation)
    h = a(_expert_matmul(buf, params["w1"], plan_leaf(plans, "w1"), cfg,
                         e0)) \
        * _expert_matmul(buf, params["w3"], plan_leaf(plans, "w3"), cfg, e0)
    y = _expert_matmul(h, params["w2"], plan_leaf(plans, "w2"), cfg, e0)
    y = torch.cat([y.reshape(n_e * n_rows, D), y.new_zeros((1, D))])
    out = rt.weight.reshape(-1, 1) * y[row]
    out = out.reshape(B, rt.n_groups * rt.group, D)[:, :S * k]
    return out.reshape(B, S, k, D).sum(dim=2)


# ------------------------------------------------------------------ embedding
def embed(params: dict, tokens: torch.Tensor, part=None, *, v0: int = 0,
          reduce=None) -> torch.Tensor:
    """Token ids (B, S) -> (B, S, D). Under a partition, with the table's
    vocab sharded: a masked lookup of this rank's rows over the whole
    sequence, reduce-scattered onto the rank's sequence block; with the
    vocab whole, a lookup of the block's tokens. With ``reduce`` (the
    partitioned decode, its activations whole on every rank) the table is
    the vocab block from id ``v0``: a masked lookup whose rows ``reduce``
    sums over the table's group."""
    table = params["embed"]
    if part is None and reduce is None:
        return table[tokens]
    n = table.shape[0]
    if part is not None:
        v0 = part.vocab_start(n)
        if v0 == 0 and n == part.cfg.vocab_size:
            return table[part.seq_block(tokens)]
    ids = tokens.long() - v0
    inside = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce(rows) if part is None else part.scatter_seq(rows)


def lm_head(params: dict, cfg: ArchConfig, x: torch.Tensor,
            plan=None) -> torch.Tensor:
    """``x @ head``. Under a partition ``params["head"]`` is the rank's
    vocab block, and the result the rank's block of the logits; on the
    partitioned decode's whole activations no collective follows (the
    reference's ``out_shardings`` keep the logits vocab-sharded)."""
    return pim_matmul(x, params["head"], plan, cfg)
