"""Transformer building blocks (dense subset), plain PyTorch.

Port of ``repro.models.layers``: the PIM projection dispatcher with its
work-stats collector, RMSNorm, RoPE, QKV projection, chunked online-softmax
attention, the gated MLP, embedding and the LM head. Attention is plain
tensor code with the reference's online-softmax math (the reference wrote
it in jnp, not Pallas). Layouts follow the reference: q ``(B, S, H, D)``,
k/v ``(B, S, K, D)``, weights ``(d_in, d_out)``.
"""

from __future__ import annotations

import contextlib

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
# collection around their layer stacks, as the reference does, so the
# collector reports decode-step work plus the prefill LM head (the
# serve-time converts/token metric).
_PIM_STATS_SINKS: list[list] = []

# total-able work-stat fields; ``conversions_possible`` is the static
# path's name for the no-speculation baseline
PIM_STAT_KEYS = ("adc_converts", "no_spec_converts", "spec_failures",
                 "spec_attempts", "recovery_saturations", "cycles", "macs")
_STAT_ALIASES = {"no_spec_converts": "conversions_possible"}


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


def pim_stats_totals(stats) -> dict:
    """Sum a sink's SpeculationStats / CrossbarStats into one
    ``{field: int}`` dict (one host sync for the data-dependent fields).
    A field a stats type lacks counts 0, after its alias
    (``_STAT_ALIASES``)."""
    tot = dict.fromkeys(PIM_STAT_KEYS, 0)
    for st in stats:
        for k in PIM_STAT_KEYS:
            v = getattr(st, k, None)
            if v is None:
                v = getattr(st, _STAT_ALIASES.get(k, k), 0)
            tot[k] = tot[k] + v
    return {k: int(v) for k, v in tot.items()}


class PimTap:
    """Calibration recorder: stands in for a plan leaf during the capture
    forward of ``models.pim_compile``. ``pim_matmul`` records the
    projection's input activations (float32) and runs the float path."""

    def __init__(self):
        self.x: list[torch.Tensor] = []

    def record(self, x2d: torch.Tensor) -> None:
        self.x.append(x2d.detach().to(torch.float32))


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
              ``cfg.pim_speculation`` off);
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


# ------------------------------------------------------------------ embedding
def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def lm_head(params: dict, cfg: ArchConfig, x: torch.Tensor,
            plan=None) -> torch.Tensor:
    return pim_matmul(x, params["head"], plan, cfg)
