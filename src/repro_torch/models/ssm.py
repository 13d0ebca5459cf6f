"""State-space and linear-attention blocks: Mamba (Jamba) and RWKV6 (Finch),
plain PyTorch.

Port of ``repro.models.ssm``. Both recurrences carry an O(1) state per
sequence. The reference lowers them as a chunked, rematerialized
``lax.scan`` whose padded steps leave the carry alone, so chunking changes
training memory and not values; here a prefill loops over its tokens in
Python and a decode step runs one step. Every ``*_scan`` function continues
from a given state, so a fresh forward (zero state), a prefill chunk and a
decode step are one code path; the model (``transformer.run_layer``) calls
only these. ``mamba_block``, ``mamba_decode_step``, ``rwkv_time_mix`` and
``rwkv_time_mix_decode`` exist only to give the reference's entry points
their names: each is one call of a ``*_scan``.

Float order follows the reference where it decides bf16 values: the causal
depthwise conv is a sequential sum of shifted products in ``cfg.dtype``;
softplus comes before the cast to float32; ``A = -exp(A_log)`` and rwkv's
decay ``exp(-exp(dec))`` are float32; the rsqrt output norm comes before
``ln_x * silu(g)``; the rwkv state is ``S[i, j]``, decayed along i (key
channels) and contracted over i for the output.

A row's value does not depend on how many rows share a call, so greedy
tokens agree across the lockstep (one request), continuous and paged (all
slots) engines, as the attention models' kernels make them agree: float
projections run in tiles of ``ROW_TILE`` rows (the BLAS picks its kernel,
and with it the summation order, by the row count), and the
recurrent contractions and the output norm's mean sum in float64 before
rounding (exact products, an order-free sum but for ties).

RWKV6 follows the Finch formulation with the reference's simplification: a
single learned token-shift lerp per projection and a LoRA decay.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

ROW_TILE = 64
RWKV_LORA = 64  # rank of the decay LoRA


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Float projection ``x (..., K) @ w (K, N)`` in x's dtype, one product
    per tile of ``ROW_TILE`` rows, the last tile padded with zero rows:
    every product has one shape, so a row rounds alike however many rows
    share the call (a decode step runs one tile; a prefill chunk of S
    tokens ceil(S / ROW_TILE))."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    n = x2.shape[0]
    x2 = F.pad(x2, (0, 0, 0, -n % ROW_TILE))
    y = torch.cat([t @ w for t in x2.split(ROW_TILE)])
    return y[:n].reshape(lead + (w.shape[-1],))


def _contract(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``(a * b).sum(dim)`` of float32 operands, summed in float64 and
    rounded to float32: products are exact, so the result does not depend
    on the reduction's order."""
    return (a.to(torch.float64) * b.to(torch.float64)).sum(dim).to(
        torch.float32)


def _rms_scale(y: torch.Tensor, eps: float) -> torch.Tensor:
    """``y * rsqrt(mean(y ** 2) + eps)`` over the last axis: the square in
    y's dtype, its mean summed in float64 and rounded to y's dtype."""
    ms = y.square().to(torch.float64).mean(dim=-1, keepdim=True).to(y.dtype)
    return y * torch.rsqrt(ms + eps)


# ===================================================================== mamba
def mamba_dims(cfg: ArchConfig):
    di = cfg.mamba_expand * cfg.d_model
    dtr = max(1, math.ceil(cfg.d_model / 16))
    return di, dtr, cfg.mamba_d_state, cfg.mamba_conv


def init_mamba(cfg: ArchConfig, normal, device) -> dict:
    """The reference's ``init_mamba`` shapes and scales; ``normal(shape,
    scale)`` draws weights in ``cfg.dtype``."""
    d = cfg.d_model
    di, dtr, ds, conv = mamba_dims(cfg)
    dt = getattr(torch, cfg.dtype)
    return {
        "in_proj": normal((d, 2 * di), d ** -0.5),
        "conv_w": normal((conv, di), conv ** -0.5),
        "conv_b": torch.zeros(di, dtype=dt, device=device),
        "x_proj": normal((di, dtr + 2 * ds), di ** -0.5),
        "dt_proj": normal((dtr, di), dtr ** -0.5),
        "dt_bias": torch.full((di,), -4.6, dtype=dt,
                              device=device),  # softplus^-1(0.01)
        "A_log": torch.log(torch.arange(
            1, ds + 1, dtype=torch.float32, device=device)).expand(
                di, ds).contiguous(),
        "D": torch.ones(di, dtype=torch.float32, device=device),
        "out_proj": normal((di, d), di ** -0.5),
    }


def _mamba_step(params: dict, cfg: ArchConfig, h, xt, bt, ct, dtt):
    """One recurrence step. h (B, di, ds); xt/dtt (B, di); bt/ct (B, ds)."""
    A = -torch.exp(params["A_log"])                    # (di, ds)
    dA = torch.exp(dtt[..., None] * A[None])           # (B, di, ds)
    h = dA * h + (dtt * xt)[..., None] * bt[:, None, :]
    y = _contract(h, ct[:, None, :], -1) + params["D"][None, :] * xt
    return h, y


def _mamba_preprocess(params: dict, cfg: ArchConfig, x: torch.Tensor,
                      conv_state: torch.Tensor | None = None, plans=None):
    """Shared projections. x (B, S, d) -> (xc, z, dt, B, C, conv state).

    ``in_proj`` and ``x_proj`` go through ``pim_matmul`` (the crossbar
    sites); the depthwise conv and the low-rank dt path stay float."""
    di, dtr, ds, conv = mamba_dims(cfg)
    xz = L.pim_matmul(x, params["in_proj"], L.plan_leaf(plans, "in_proj"),
                      cfg)
    xin, z = xz.split(di, dim=-1)
    S = xin.shape[1]
    if conv_state is None:
        conv_state = xin.new_zeros((xin.shape[0], conv - 1, di))
    hist = torch.cat([conv_state.to(xin.dtype), xin], dim=1)
    # causal depthwise conv as shifted adds, in order (the reference's sum)
    xc = sum(params["conv_w"][i][None, None, :] * hist[:, i:i + S]
             for i in range(conv))
    xc = F.silu(xc + params["conv_b"])
    new_conv_state = hist[:, hist.shape[1] - (conv - 1):]
    dbc = L.pim_matmul(xc, params["x_proj"], L.plan_leaf(plans, "x_proj"),
                       cfg)
    dt_lr, bmat, cmat = dbc.split([dtr, ds, ds], dim=-1)
    dt_full = F.softplus(_mm(dt_lr, params["dt_proj"])
                         + params["dt_bias"]).to(torch.float32)
    return (xc.to(torch.float32), z, dt_full, bmat.to(torch.float32),
            cmat.to(torch.float32), new_conv_state)


def init_mamba_state(cfg: ArchConfig, batch: int, device) -> dict:
    di, _, ds, conv = mamba_dims(cfg)
    return {"h": torch.zeros((batch, di, ds), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv - 1, di),
                                dtype=getattr(torch, cfg.dtype),
                                device=device)}


def mamba_scan(params: dict, cfg: ArchConfig, x: torch.Tensor, state: dict,
               plans=None) -> tuple[dict, torch.Tensor]:
    """Mamba over x (B, S, d), continuing from ``state`` ({"h", "conv"}):
    -> (new state, y (B, S, d)). A zero state is a fresh sequence."""
    xc, z, dt_full, bmat, cmat, new_conv = _mamba_preprocess(
        params, cfg, x, conv_state=state["conv"], plans=plans)
    h, ys = state["h"], []
    for t in range(x.shape[1]):
        h, y = _mamba_step(params, cfg, h, xc[:, t], bmat[:, t], cmat[:, t],
                           dt_full[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1).to(x.dtype) * F.silu(z)
    out = L.pim_matmul(y, params["out_proj"],
                       L.plan_leaf(plans, "out_proj"), cfg)
    return {"h": h, "conv": new_conv}, out


def mamba_block(params: dict, cfg: ArchConfig, x: torch.Tensor,
                plans=None) -> torch.Tensor:
    """Full-sequence Mamba (forward / calibration capture). x: (B, S, d)."""
    state = init_mamba_state(cfg, x.shape[0], x.device)
    return mamba_scan(params, cfg, x, state, plans)[1]


def mamba_decode_step(params: dict, cfg: ArchConfig, state: dict,
                      x: torch.Tensor,
                      plans=None) -> tuple[dict, torch.Tensor]:
    """x: (B, 1, d) -> (new_state, y (B, 1, d))."""
    return mamba_scan(params, cfg, x, state, plans)


# ===================================================================== rwkv6
def rwkv_dims(cfg: ArchConfig):
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def init_rwkv(cfg: ArchConfig, normal, uniform, device) -> dict:
    """The reference's ``init_rwkv`` shapes and scales; ``uniform(shape)``
    draws from [0, 1) in ``cfg.dtype``."""
    d = cfg.d_model
    H, hd = rwkv_dims(cfg)
    p = {"mix": uniform((5, d))}   # token-shift lerps for r/k/v/g/w
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = normal((d, d), d ** -0.5)
    p.update(
        decay_base=torch.full((d,), -1.0, dtype=torch.float32, device=device),
        decay_A=normal((d, RWKV_LORA), d ** -0.5),
        decay_B=normal((RWKV_LORA, d), RWKV_LORA ** -0.5),
        bonus=torch.zeros((H, hd), dtype=torch.float32, device=device),
        ln_x=torch.ones(d, dtype=getattr(torch, cfg.dtype), device=device))
    return p


def _rwkv_project(params: dict, cfg: ArchConfig, x: torch.Tensor,
                  x_prev: torch.Tensor):
    """Token shift + projections. x (B, S, d); x_prev (B, S, d) = shift(x)."""
    H, hd = rwkv_dims(cfg)
    B, S, _ = x.shape
    mixed = [x + (x_prev - x) * params["mix"][i] for i in range(5)]
    r, k, v, g = (_mm(m, params[n]) for m, n in zip(
        mixed, ("wr", "wk", "wv", "wg")))
    dec = params["decay_base"] + _mm(_mm(mixed[4], params["decay_A"]),
                                     params["decay_B"])
    w = torch.exp(-torch.exp(dec.to(torch.float32)))  # (B, S, d) in (0, 1)
    return (r.reshape(B, S, H, hd).to(torch.float32),
            k.reshape(B, S, H, hd).to(torch.float32),
            v.reshape(B, S, H, hd).to(torch.float32),
            w.reshape(B, S, H, hd), g)


def _rwkv_step(params: dict, h, rt, kt, vt, wt):
    """h (B, H, hd, hd); rt/kt/vt/wt (B, H, hd) -> (h', y (B, H, hd))."""
    u = params["bonus"][None]                        # (1, H, hd)
    kv = kt[..., :, None] * vt[..., None, :]         # (B, H, hd, hd)
    y = _contract(rt[..., :, None], h + u[..., None] * kv, -2)
    h = wt[..., None] * h + kv
    return h, y


def init_rwkv_state(cfg: ArchConfig, batch: int, device) -> dict:
    H, hd = rwkv_dims(cfg)
    dt = getattr(torch, cfg.dtype)
    return {"h": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, cfg.d_model), dtype=dt,
                                  device=device),
            "cm_prev": torch.zeros((batch, cfg.d_model), dtype=dt,
                                   device=device)}


def rwkv_time_mix_scan(params: dict, cfg: ArchConfig, x: torch.Tensor,
                       state: dict) -> tuple[dict, torch.Tensor]:
    """RWKV6 time-mix over x (B, S, d), continuing from ``state``'s ``h``
    and ``x_prev`` -> (new state, y (B, S, d)); ``cm_prev`` passes
    through."""
    B, S, d = x.shape
    x_prev = torch.cat([state["x_prev"][:, None].to(x.dtype), x[:, :-1]],
                       dim=1)
    rh, kh, vh, wh, g = _rwkv_project(params, cfg, x, x_prev)
    h, ys = state["h"], []
    for t in range(S):
        h, y = _rwkv_step(params, h, rh[:, t], kh[:, t], vh[:, t], wh[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S, d).to(x.dtype)
    # group-norm-like scale, then the silu(g) gate (Finch output path)
    y = _rms_scale(y, cfg.norm_eps) * params["ln_x"] * F.silu(g)
    return dict(state, h=h, x_prev=x[:, -1]), _mm(y, params["wo"])


def rwkv_time_mix(params: dict, cfg: ArchConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    """Full-sequence RWKV6 time-mix. x: (B, S, d)."""
    state = init_rwkv_state(cfg, x.shape[0], x.device)
    return rwkv_time_mix_scan(params, cfg, x, state)[1]


def rwkv_time_mix_decode(params: dict, cfg: ArchConfig, state: dict,
                         x: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """x: (B, 1, d)."""
    return rwkv_time_mix_scan(params, cfg, x, state)


def init_rwkv_channel_mix(cfg: ArchConfig, normal, uniform) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mix": uniform((2, d)),
            "wk": normal((d, f), d ** -0.5),
            "wv": normal((f, d), f ** -0.5),
            "wr": normal((d, d), d ** -0.5)}


def rwkv_channel_mix(params: dict, cfg: ArchConfig, x: torch.Tensor,
                     x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """RWKV's FFN: relu(k)^2 values behind a sigmoid receptance gate, on
    token-shifted inputs (``x_prev`` defaults to x shifted by one, zeros
    first)."""
    if x_prev is None:
        x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * params["mix"][0]
    xr = x + (x_prev - x) * params["mix"][1]
    k = torch.square(F.relu(_mm(xk, params["wk"])))
    kv = _mm(k, params["wv"])
    return torch.sigmoid(_mm(xr, params["wr"])) * kv
