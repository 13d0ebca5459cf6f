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

Partitioned (``part=``, a ``dist.parallel.Partition``: the train step and
the prefill) the mixers gather the sequence over the model axis and run
on the rank's d_inner block or whole heads, the reference's carries
sharded over ``tp`` / ``heads``; ``serve=`` (a ``dist.parallel.ServeLayer``)
is the partitioned decode, which steps the rank's rows of the state
(``dist.parallel``'s docstring). Either keeps the float order above.

Both scans, and ``_mm``'s row tiles, loop through ``_scan``. A cost count
may set ``SCAN_LOOP`` to a loop of its own (``launch.hlo_analysis`` runs a
few trips and counts a middle one once more for every trip it skips, as
the reference's HLO count scales a while body by its trip count); left at
None, every trip runs.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

ROW_TILE = 64
RWKV_LORA = 64  # rank of the decay LoRA

# (step, h, xs) -> (h, ys stacked on dim 1), running h, y_t = step(h,
# *positions(xs, ...)[t]) over the positions t of xs; None runs every trip
# (module docstring)
SCAN_LOOP = None


class _Positions(torch.autograd.Function):
    """``x[:, t]`` for the positions ``ts`` of a cost count's sampled
    trips, whose backward stacks their gradients into ``x``'s in one op,
    as the backward of the plain loop's ``unbind`` does (a select per trip
    would write a zeroed copy of the whole ``x`` for each, quadratic in
    the positions); a position without a gradient (a trip that the count
    skipped) adds a broadcast zero, made once a backward whether any is
    missing or not, so a sampled count equals a count of every trip."""

    @staticmethod
    def forward(ctx, x, ts):
        ctx.set_materialize_grads(False)
        ctx.shape, ctx.n, ctx.ts = x.shape[:1] + x.shape[2:], x.shape[1], ts
        return tuple(x.select(1, t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        known = [g for g in grads if g is not None]
        if not known:
            return None, None
        zero = known[0].new_zeros(()).expand(ctx.shape)
        at = dict(zip(ctx.ts, grads))
        return torch.stack([zero if at.get(t) is None else at[t]
                            for t in range(ctx.n)], dim=1), None


def positions(xs: tuple, ts) -> dict:
    """``{t: tuple(x[:, t] for x in xs)}`` for the positions ``ts`` of
    ``xs`` (each (B, S, ...)), a cost count's sampled trips; a recording
    input's through ``_Positions``."""
    ts = tuple(ts)
    cols = [_Positions.apply(x, ts) if x.requires_grad
            and torch.is_grad_enabled() else [x.select(1, t) for t in ts]
            for x in xs]
    return {t: tuple(c[i] for c in cols) for i, t in enumerate(ts)}


def _scan(step, h, xs: tuple) -> tuple:
    """``h, y_t = step(h, *(x[:, t] for x in xs))`` over the positions of
    ``xs`` (each (B, S, ...)) -> (the last carry, the y_t stacked on dim
    1)."""
    if SCAN_LOOP is not None:
        return SCAN_LOOP(step, h, xs)
    # unbound at once: the backward stacks the positions' gradients in one
    # op (a select per trip would write a zeroed copy of x for each)
    cols = [x.unbind(1) for x in xs]
    ys = []
    for t in range(xs[0].shape[1]):
        h, y = step(h, *(c[t] for c in cols))
        ys.append(y)
    return h, torch.stack(ys, dim=1)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Float projection ``x (..., K) @ w (K, N)`` in x's dtype, one product
    per tile of ``ROW_TILE`` rows, the last tile padded with zero rows:
    every product has one shape, so a row rounds alike however many rows
    share the call (a decode step runs one tile; a prefill chunk of S
    tokens ceil(S / ROW_TILE)). The tiles run as the trips of a ``_scan``
    whose carry is ``w`` (a cost count samples them as it samples a
    recurrence's trips)."""
    lead = x.shape[:-1]
    n = math.prod(lead)
    k, m = x.shape[-1], w.shape[-1]  # 0 on a rank without heads
    nt = -(-n // ROW_TILE)
    x2 = F.pad(x.reshape(n, k), (0, 0, 0, nt * ROW_TILE - n))
    tiles = x2.reshape(1, nt, ROW_TILE, k)
    _, y = _scan(lambda w, t: (w, (t[0] @ w)[None]), w, (tiles,))
    return y.reshape(nt * ROW_TILE, m)[:n].reshape(lead + (m,))


def _contract(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``(a * b).sum(dim)`` of float32 operands, summed in float64 and
    rounded to float32: products are exact, so the result does not depend
    on the reduction's order."""
    return (a.to(torch.float64) * b.to(torch.float64)).sum(dim).to(
        torch.float32)


def _rms_scale(y: torch.Tensor, eps: float, d: int,
               total=None) -> torch.Tensor:
    """``y * rsqrt(mean(y ** 2) + eps)`` over the last axis of ``d``
    channels: the square in y's dtype, summed in float64, divided by ``d``
    and rounded to y's dtype. ``total`` sums the float64 sums of the
    ranks' channel blocks (a partitioned rank holds its heads' channels)."""
    ss = y.square().to(torch.float64).sum(dim=-1, keepdim=True)
    if total is not None:
        ss = total(ss)
    return y * torch.rsqrt((ss / d).to(y.dtype) + eps)


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


def _mamba_conv(conv_w: torch.Tensor, conv_b: torch.Tensor,
                xin: torch.Tensor, conv_state: torch.Tensor):
    """The causal depthwise conv over xin (B, S, channels) continuing from
    ``conv_state`` (B, conv - 1, channels) -> (silu(conv), the new conv
    state)."""
    conv, S = conv_w.shape[0], xin.shape[1]
    hist = torch.cat([conv_state.to(xin.dtype), xin], dim=1)
    # causal depthwise conv as shifted adds, in order (the reference's sum)
    xc = sum(conv_w[i][None, None, :] * hist[:, i:i + S]
             for i in range(conv))
    # the carries are copies: a view would keep the whole sequence alive
    return F.silu(xc + conv_b), hist[:, hist.shape[1] - (conv - 1):].clone()


def _mamba_preprocess(params: dict, cfg: ArchConfig, x: torch.Tensor,
                      conv_state: torch.Tensor | None = None, plans=None,
                      total=None):
    """Shared projections. x (B, S, d) -> (xc, z, dt, B, C, conv state).

    ``in_proj`` and ``x_proj`` go through ``pim_matmul`` (the crossbar
    sites); the depthwise conv and the low-rank dt path stay float. Under
    a partition ``params`` hold the rank's d_inner block (``in_proj``'s
    columns of it in both halves) and ``total`` sums ``x_proj``'s partial
    products over the ranks' blocks."""
    _, dtr, ds, conv = mamba_dims(cfg)
    xz = L.pim_matmul(x, params["in_proj"], L.plan_leaf(plans, "in_proj"),
                      cfg)
    xin, z = xz.split(xz.shape[-1] // 2, dim=-1)
    if conv_state is None:
        conv_state = xin.new_zeros((xin.shape[0], conv - 1, xin.shape[-1]))
    xc, new_conv_state = _mamba_conv(params["conv_w"], params["conv_b"], xin,
                                     conv_state)
    dbc = L.pim_matmul(xc, params["x_proj"], L.plan_leaf(plans, "x_proj"),
                       cfg)
    if total is not None:
        dbc = total(dbc)
    dt_lr, bmat, cmat = dbc.split([dtr, ds, ds], dim=-1)
    dt_full = F.softplus(_mm(dt_lr, params["dt_proj"])
                         + params["dt_bias"]).to(torch.float32)
    return (xc.to(torch.float32), z, dt_full, bmat.to(torch.float32),
            cmat.to(torch.float32), new_conv_state)


def init_mamba_state(cfg: ArchConfig, batch: int, device,
                     part=None) -> dict:
    """The zero carry of ``batch`` slots; under a partition
    (``dist.parallel.Partition``) of the rank's d_inner block."""
    di, _, ds, conv = mamba_dims(cfg)
    if part is not None:
        di = part.inner[1] - part.inner[0]
    return {"h": torch.zeros((batch, di, ds), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv - 1, di),
                                dtype=getattr(torch, cfg.dtype),
                                device=device)}


def mamba_scan(params: dict, cfg: ArchConfig, x: torch.Tensor, state: dict,
               plans=None, part=None,
               serve=None) -> tuple[dict, torch.Tensor]:
    """Mamba over x (B, S, d), continuing from ``state`` ({"h", "conv"}):
    -> (new state, y (B, S, d)). A zero state is a fresh sequence.

    Under a partition (``dist.parallel.Partition``) ``x`` is the rank's
    sequence block and ``params`` and ``state`` hold its d_inner block:
    the sequence is all-gathered (the scan and the conv run along it), the
    column-parallel ``in_proj`` and the conv, dt path and scan run on the
    block, ``x_proj``'s partial sums are summed over the model axis
    (``sum_model``: every rank's block takes the whole dt_lr | B | C), and
    the row-parallel ``out_proj`` is reduce-scattered onto the block.
    ``serve`` (``dist.parallel.ServeLayer``) is the partitioned decode
    (``_mamba_serve``)."""
    if serve is not None:
        return _mamba_serve(params, cfg, x, state, serve)
    if part is not None:
        x = part.gather_seq(x)
    xc, z, dt_full, bmat, cmat, new_conv = _mamba_preprocess(
        params, cfg, x, conv_state=state["conv"], plans=plans,
        total=None if part is None else part.sum_model)
    h, y = _scan(functools.partial(_mamba_step, params, cfg), state["h"],
                 (xc, bmat, cmat, dt_full))
    y = y.to(x.dtype) * F.silu(z)
    out = L.pim_matmul(y, params["out_proj"],
                       L.plan_leaf(plans, "out_proj"), cfg)
    if part is not None:
        out = part.scatter_seq(out)
    return {"h": h, "conv": new_conv}, out


def _mamba_serve(params: dict, cfg: ArchConfig, x: torch.Tensor,
                 state: dict, sv) -> tuple[dict, torch.Tensor]:
    """One decode step of a mamba layer under the partitioned decode:
    ``x`` (B, 1, d) whole on every rank, ``params`` the rank's stored
    blocks, ``state`` its rows with every d_inner channel. ``in_proj``'s
    and ``dt_proj``'s column blocks are gathered whole and the rank takes
    its rows of them; the conv and the scan step run on its rows with the
    whole channel-wise leaves (``sv.whole``); ``x_proj`` and ``out_proj``
    take the whole batch's inputs on their rows' block and sum their
    partial products over their groups."""
    _, dtr, ds, _ = mamba_dims(cfg)
    xz = sv.cols(x @ params["in_proj"], "in_proj")
    xin, z = (sv.mine(t) for t in xz.split(xz.shape[-1] // 2, dim=-1))
    xc, new_conv = _mamba_conv(sv.whole("conv_w"), sv.whole("conv_b"), xin,
                               state["conv"])
    dbc = sv.reduce(sv.block(sv.every(xc), "x_proj") @ params["x_proj"],
                    "x_proj")
    dt_lr, bmat, cmat = dbc.split([dtr, ds, ds], dim=-1)
    dt = sv.cols(F.softplus(_mm(dt_lr, params["dt_proj"])
                            + params["dt_bias"]), "dt_proj")
    whole = {"A_log": sv.whole("A_log"), "D": sv.whole("D")}
    h, y = _mamba_step(whole, cfg, state["h"], xc[:, 0].to(torch.float32),
                       *(sv.mine(t)[:, 0].to(torch.float32)
                         for t in (bmat, cmat, dt)))
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = sv.reduce(sv.block(sv.every(y), "out_proj") @ params["out_proj"],
                    "out_proj")
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
    """Token shift + projections. x (B, S, d); x_prev (B, S, d) = shift(x).
    The heads are counted from the weights' widths (a partitioned rank's
    ``wr``/``wk``/``wv``/``wg`` hold its own heads' columns)."""
    hd = rwkv_dims(cfg)[1]
    B, S, _ = x.shape
    mixed = [x + (x_prev - x) * params["mix"][i] for i in range(5)]
    r, k, v, g = (_mm(m, params[n]) for m, n in zip(
        mixed, ("wr", "wk", "wv", "wg")))
    dec = params["decay_base"] + _mm(_mm(mixed[4], params["decay_A"]),
                                     params["decay_B"])
    w = torch.exp(-torch.exp(dec.to(torch.float32)))  # (B, S, d) in (0, 1)
    return (r.reshape(B, S, -1, hd).to(torch.float32),
            k.reshape(B, S, -1, hd).to(torch.float32),
            v.reshape(B, S, -1, hd).to(torch.float32),
            w.reshape(B, S, -1, hd), g)


def _rwkv_step(params: dict, h, rt, kt, vt, wt):
    """h (B, H, hd, hd); rt/kt/vt/wt (B, H, hd) -> (h', y (B, H, hd))."""
    u = params["bonus"][None]                        # (1, H, hd)
    kv = kt[..., :, None] * vt[..., None, :]         # (B, H, hd, hd)
    y = _contract(rt[..., :, None], h + u[..., None] * kv, -2)
    h = wt[..., None] * h + kv
    return h, y


def init_rwkv_state(cfg: ArchConfig, batch: int, device,
                    part=None) -> dict:
    """The zero carry of ``batch`` slots; under a partition
    (``dist.parallel.Partition``) ``h`` holds the rank's heads."""
    H, hd = rwkv_dims(cfg)
    if part is not None:
        H = part.rwkv_heads[1] - part.rwkv_heads[0]
    dt = getattr(torch, cfg.dtype)
    return {"h": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, cfg.d_model), dtype=dt,
                                  device=device),
            "cm_prev": torch.zeros((batch, cfg.d_model), dtype=dt,
                                   device=device)}


def rwkv_time_mix_scan(params: dict, cfg: ArchConfig, x: torch.Tensor,
                       state: dict, part=None,
                       serve=None) -> tuple[dict, torch.Tensor]:
    """RWKV6 time-mix over x (B, S, d), continuing from ``state``'s ``h``
    and ``x_prev`` -> (new state, y (B, S, d)); ``cm_prev`` passes
    through.

    Under a partition (``dist.parallel.Partition``) ``x`` is the rank's
    sequence block, ``params`` hold its whole heads' columns and ``h`` its
    heads: the sequence is all-gathered (the token shift and the scan run
    along it), r/k/v/g and the decay are column-parallel, the output
    norm's float64 sum of squares is summed over the model axis
    (``sum_model``) before the mean over ``d_model``, and the row-parallel
    ``wo`` is reduce-scattered onto the block. ``serve``
    (``dist.parallel.ServeLayer``) is the partitioned decode
    (``_rwkv_serve``)."""
    if serve is not None:
        return _rwkv_serve(params, cfg, x, state, serve)
    if part is not None:
        x = part.gather_seq(x)
    B, S, d = x.shape
    x_prev = torch.cat([state["x_prev"][:, None].to(x.dtype), x[:, :-1]],
                       dim=1)
    rh, kh, vh, wh, g = _rwkv_project(params, cfg, x, x_prev)
    h, y = _scan(functools.partial(_rwkv_step, params), state["h"],
                 (rh, kh, vh, wh))
    y = y.reshape(B, S, -1).to(x.dtype)
    # group-norm-like scale, then the silu(g) gate (Finch output path)
    y = _rms_scale(y, cfg.norm_eps, d,
                   None if part is None else part.sum_model) \
        * params["ln_x"] * F.silu(g)
    out = _mm(y, params["wo"])
    if part is not None:
        out = part.scatter_seq(out)
    return dict(state, h=h, x_prev=x[:, -1].clone()), out


def _rwkv_serve(params: dict, cfg: ArchConfig, x: torch.Tensor,
                state: dict, sv) -> tuple[dict, torch.Tensor]:
    """One decode step of an rwkv time-mix under the partitioned decode:
    ``x`` (B, 1, d) whole on every rank, ``params`` the rank's stored
    blocks, ``state`` its rows with every head. The token shift takes the
    whole batch's ``x_prev``; r/k/v/g's column blocks are gathered whole
    and the rank takes its rows of them; the decay (its leaves
    replicated), the scan step with the whole ``bonus`` and the output
    norm run on its rows; ``wo`` takes the whole batch's inputs on its
    rows' block and sums its partial products over its group."""
    H, hd = rwkv_dims(cfg)
    d = x.shape[-1]
    x_prev = sv.every(state["x_prev"])[:, None].to(x.dtype)
    mixed = [x + (x_prev - x) * params["mix"][i] for i in range(5)]
    r, k, v, g = (sv.mine(sv.cols(_mm(m, params[n]), n)) for m, n in zip(
        mixed, ("wr", "wk", "wv", "wg")))
    dec = params["decay_base"] + _mm(_mm(sv.mine(mixed[4]),
                                         params["decay_A"]),
                                     params["decay_B"])
    w = torch.exp(-torch.exp(dec.to(torch.float32)))
    nb = r.shape[0]
    rt, kt, vt = (t.reshape(nb, H, hd).to(torch.float32) for t in (r, k, v))
    h, y = _rwkv_step({"bonus": sv.whole("bonus")}, state["h"], rt, kt, vt,
                      w.reshape(nb, H, hd))
    y = y.reshape(nb, 1, d).to(x.dtype)
    y = _rms_scale(y, cfg.norm_eps, d) * params["ln_x"] * F.silu(g)
    out = sv.reduce(_mm(sv.block(sv.every(y), "wo"), params["wo"]), "wo")
    return dict(state, h=h, x_prev=sv.mine(x)[:, 0].clone()), out


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
                     x_prev: torch.Tensor | None = None,
                     part=None) -> torch.Tensor:
    """RWKV's FFN: relu(k)^2 values behind a sigmoid receptance gate, on
    token-shifted inputs (``x_prev`` defaults to x shifted by one, zeros
    first). Under a partition (``dist.parallel.Partition``) ``x`` and
    ``x_prev`` are whole sequences (gathered): the column-parallel ``wk``
    and the row-parallel ``wv`` run on them, reduce-scattered onto the
    rank's sequence block, and the gate's ``wr`` (replicated over the
    model axis) on that block alone."""
    if x_prev is None:
        x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * params["mix"][0]
    if part is not None:
        x, x_prev = part.seq_block(x), part.seq_block(x_prev)
    xr = x + (x_prev - x) * params["mix"][1]
    k = torch.square(F.relu(_mm(xk, params["wk"])))
    kv = _mm(k, params["wv"])
    if part is not None:
        kv = part.scatter_seq(kv)
    return torch.sigmoid(_mm(xr, params["wr"])) * kv


def rwkv_channel_mix_scan(params: dict, cfg: ArchConfig, x: torch.Tensor,
                          prev: torch.Tensor, part=None,
                          serve=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The channel-mix over x (B, S, d) continuing the token shift from
    ``prev`` (B, d), the last input of the previous call: -> (the new
    ``prev``, y (B, S, d)). Under a partition ``x`` is the rank's
    sequence block, gathered for the shift; ``serve`` is the partitioned
    decode: ``x`` (B, 1, d) whole, ``prev`` the rank's rows, the gate's
    ``wr`` replicated, ``wk``'s column block handed to ``wv``'s rows and
    their partial products summed."""
    if serve is not None:
        x_prev = serve.every(prev)[:, None].to(x.dtype)
        xk = x + (x_prev - x) * params["mix"][0]
        xr = x + (x_prev - x) * params["mix"][1]
        k = torch.square(F.relu(_mm(xk, params["wk"])))
        kv = serve.reduce(_mm(serve.rows_for(k, "wk", "wv"), params["wv"]),
                          "wv")
        return serve.mine(x)[:, 0].clone(), \
            torch.sigmoid(_mm(xr, params["wr"])) * kv
    if part is not None:
        x = part.gather_seq(x)
    x_prev = torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return x[:, -1].clone(), rwkv_channel_mix(params, cfg, x, x_prev, part)
