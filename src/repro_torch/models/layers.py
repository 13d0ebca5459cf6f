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

from repro_torch.configs.base import ArchConfig
from repro_torch.core import adc as adc_lib
from repro_torch.core import backends as device_backends
from repro_torch.core import center_offset as co
from repro_torch.core import pim_linear
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
    """
    if isinstance(plan, PimTap):
        plan.record(x.reshape(-1, x.shape[-1]))
        plan = None
    if plan is None or cfg.pim_mode == "off":
        return x @ w
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).to(torch.float32)
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
def qkv_project(params: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, plans=None):
    """x (B, S, D) -> q (B,S,H,hd), k/v (B,S,K,hd), RoPE applied."""
    B, S, _ = x.shape
    nh, nk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = pim_matmul(x, params["wq"], plan_leaf(plans, "wq"), cfg)
    k = pim_matmul(x, params["wk"], plan_leaf(plans, "wk"), cfg)
    v = pim_matmul(x, params["wv"], plan_leaf(plans, "wv"), cfg)
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nk, hd)
    v = v.reshape(B, S, nk, hd)
    if cfg.qk_norm:
        q = rmsnorm({"scale": params["q_norm"]}, q, cfg.norm_eps)
        k = rmsnorm({"scale": params["k_norm"]}, k, cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _kv_limit(kv_len, device):
    """``kv_len`` as something ``positions < limit`` broadcasts against:
    a Python int stays one (no host-to-device copy), a (B,) tensor becomes
    a (B, 1) column."""
    if isinstance(kv_len, int):
        return kv_len
    t = torch.as_tensor(kv_len, device=device)
    return t if t.ndim == 0 else t[:, None]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_len,
                      causal: bool, chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash-style, exact).

    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H = K * G.
    q_positions: (B, Sq) global positions of the queries (causal mask).
    kv_len: number of valid KV entries (int or (B,)) — masks cache padding.
    """
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    G = H // K
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
    scale = D ** -0.5
    m = torch.full((B, Sq, K, G), -torch.inf, device=q.device)
    l = torch.zeros((B, Sq, K, G), device=q.device)
    acc = torch.zeros((B, Sq, K, G, D), device=q.device)
    for c0 in range(0, Sk, chunk):
        kb = k[:, c0:c0 + chunk].to(torch.float32)
        vb = v[:, c0:c0 + chunk].to(torch.float32)
        kpos = c0 + torch.arange(kb.shape[1], device=q.device)
        valid = kpos[None, :] < limit  # (B|1, chunk)
        mask = valid[:, None, None, None, :]
        if causal:
            cm = kpos[None, None, :] <= q_positions[:, :, None]
            mask = mask & cm[:, :, None, None, :]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb) * scale
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention_block(params: dict, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, plans=None) -> torch.Tensor:
    """Full-sequence attention (prefill / forward)."""
    B, S, _ = x.shape
    q, k, v = qkv_project(params, cfg, x, positions, plans)
    out = chunked_attention(q, k, v, q_positions=positions, kv_len=S,
                            causal=cfg.causal)
    return pim_matmul(out.reshape(B, S, -1), params["wo"],
                      plan_leaf(plans, "wo"), cfg)


# ------------------------------------------------------------------ mlp
def mlp_block(params: dict, cfg: ArchConfig, x: torch.Tensor,
              plans=None) -> torch.Tensor:
    a = act_fn(cfg.activation)
    h = a(pim_matmul(x, params["w1"], plan_leaf(plans, "w1"), cfg)) \
        * pim_matmul(x, params["w3"], plan_leaf(plans, "w3"), cfg)
    return pim_matmul(h, params["w2"], plan_leaf(plans, "w2"), cfg)


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
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = (x.reshape(B * S, -1).to(torch.float64)
              @ params["router"].to(torch.float64)).to(torch.float32)
    vals, idx = torch.topk(logits.reshape(B, S, E), k, dim=-1)
    weights = torch.sigmoid(vals) if k == 1 else torch.softmax(vals, dim=-1)
    slots = S * k
    g, n_groups, cap = moe_capacity(cfg, slots)
    pad = n_groups * g - slots
    fe = F.pad(idx.reshape(B, slots), (0, pad), value=E)
    fw = F.pad(weights.reshape(B, slots).to(x.dtype), (0, pad))
    fe = fe.reshape(B, n_groups, g)
    # rank within the expert, counted over the group in slot order (the
    # reference's float32 cumsum of one-hots; exact in int64 alike)
    eh = F.one_hot(fe, E + 1)[..., :E]
    pos = ((eh.cumsum(dim=2) - eh) * eh).sum(dim=-1)
    keep = (pos < cap) & (fe < E)
    return MoeRoute(expert=fe, weight=fw.reshape(B, n_groups, g), pos=pos,
                    keep=keep, group=g, n_groups=n_groups, cap=cap)


def _expert_matmul(buf: torch.Tensor, w: torch.Tensor, plan,
                   cfg: ArchConfig) -> torch.Tensor:
    """Per-expert projection ``buf (E, N, d_in) @ w (E, d_in, d_out)``.
    ``plan`` leaves carry a leading expert axis; ``pim_matmul`` runs once
    per expert on ``plan[e]``, every expert, empty buffers included (the
    reference vmaps it). Work stats stay suspended, as in the reference:
    converts per token bill attention and the LM head, not the experts."""
    if isinstance(plan, PimTap):
        plan.record(buf)
        plan = None
    if plan is None or cfg.pim_mode == "off":
        return torch.matmul(buf, w)
    with suspend_pim_stats():
        return torch.stack([
            pim_matmul(buf[e], w[e], {k: v[e] for k, v in plan.items()}, cfg)
            for e in range(buf.shape[0])])


def moe_block(params: dict, cfg: ArchConfig, x: torch.Tensor,
              plans=None) -> torch.Tensor:
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
    """
    B, S, D = x.shape
    if S == 1 and B > 1:
        return moe_block(params, cfg, x.reshape(1, B, D),
                         plans).reshape(B, 1, D)
    E, k = cfg.n_experts, cfg.experts_per_token
    rt = moe_route(params, cfg, x)
    n_rows = B * rt.n_groups * rt.cap  # dispatch rows per expert
    b = torch.arange(B, device=x.device)[:, None, None]
    n = torch.arange(rt.n_groups, device=x.device)[None, :, None]
    row = rt.expert * n_rows + (b * rt.n_groups + n) * rt.cap + rt.pos
    # dropped and padding slots write to (and read) one extra row
    row = torch.where(rt.keep, row, E * n_rows).reshape(-1)
    xg = F.pad(x.repeat_interleave(k, dim=1),
               (0, 0, 0, rt.n_groups * rt.group - S * k)).reshape(-1, D)
    buf = x.new_zeros((E * n_rows + 1, D))
    buf[row] = xg
    buf = buf[:-1].reshape(E, n_rows, D)
    a = act_fn(cfg.activation)
    h = a(_expert_matmul(buf, params["w1"], plan_leaf(plans, "w1"), cfg)) \
        * _expert_matmul(buf, params["w3"], plan_leaf(plans, "w3"), cfg)
    y = _expert_matmul(h, params["w2"], plan_leaf(plans, "w2"), cfg)
    y = torch.cat([y.reshape(E * n_rows, D), y.new_zeros((1, D))])
    out = rt.weight.reshape(-1, 1) * y[row]
    out = out.reshape(B, rt.n_groups * rt.group, D)[:, :S * k]
    return out.reshape(B, S, k, D).sum(dim=2)


# ------------------------------------------------------------------ embedding
def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def lm_head(params: dict, cfg: ArchConfig, x: torch.Tensor,
            plan=None) -> torch.Tensor:
    return pim_matmul(x, params["head"], plan, cfg)
