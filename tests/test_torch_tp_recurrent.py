"""The partitioned train step, prefill and decode of the recurrent layers
(``repro_torch.dist.parallel``, ``models.ssm``'s ``part=`` and ``serve=``
paths): mamba over its d_inner channels and rwkv6 over whole heads, on 4
ranks. One spawn of 4 ``gloo`` processes on the CPU
(``_torch_dist_workers.task_tp``, one intra-op thread each, no jax in the
workers); this process computes the one-process port's and the
reference's values.

The configs, reduced float32 from the reference's init: jamba-1.5-large-
398b over its 8-layer pattern (mamba layers, attention at position 3, a
MoE FFN on the even layers); the same with ``d_model`` 66 and
``mamba_expand`` 3 (a d_inner of 198, which 4 ranks split 50, 50, 50 and
48, its leaves replicated and narrowed, ``in_proj`` gathered); rwkv6-3b
at 2 layers (4 heads); and rwkv6 at ``d_model`` 96 (6 heads, which 4
ranks split 2, 2, 2 and 0). Each on ``("data", "model")`` meshes of (2, 2)
and (1, 4) and a (2, 1, 2) pods mesh, as ``test_torch_tp.py`` runs them:

- Train (DEFAULT_RULES / MULTIPOD_RULES): 2 steps; losses within
  ``LOSS_RTOL``, grad norms within ``NORM_RTOL`` and parameters within
  ``PARAM_RTOL`` relative global norm of the one-process step and of the
  reference's jitted step; gradients in their parameters' placements; a
  batch placed along its rows gives the same step bit for bit. A grad norm
  that missed the other ranks' parts of ``x_proj``'s or the output norm's
  all-reduce (``parallel.sum_partials``) falls outside ``NORM_RTOL``.
- Prefill: the ranks' logits (rows x vocab shards) and caches assembled
  (attention by rows and sequence blocks; carries by rows, and by the
  rank's d_inner block or heads where ``cache_specs`` splits them over
  "model") within ``TOL`` of the one-process prefill and of the
  reference's.
- Decode (SERVE_RULES / MULTIPOD_SERVE_RULES) from one one-process state
  placed by ``cache_specs``, ``DECODE_STEPS`` steps, lockstep and per-slot
  positions: logits and caches within ``TOL`` of the one-process
  ``decode_step`` and the reference's; on (2, 2) no collective's result
  has a parameter leaf's shape (the channel-wise leaves that a layer
  applies to its state are gathered once, when the ``ServePartition`` is
  made).
- A one-rank mesh runs the plain programs bit for bit (in this process).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as RT
from repro.train import optimizer as ropt
from repro.train import train_loop as rtl
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import _tree
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl

import _torch_dist_workers as W
from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

LOSS_RTOL, NORM_RTOL, PARAM_RTOL = 1e-5, 1e-4, 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(dtype="float32", kv_cache_dtype="float32")
JAMBA, RWKV = "jamba-1.5-large-398b", "rwkv6-3b"

# key -> (arch, reduced() overrides)
CONFIGS = {
    "jamba": (JAMBA, dict(vocab_size=64)),
    "jamba_di": (JAMBA, dict(vocab_size=64, d_model=66, mamba_expand=3)),
    "rwkv": (RWKV, dict(vocab_size=64, n_layers=2)),
    "rwkv_h6": (RWKV, dict(vocab_size=64, n_layers=2, d_model=96)),
}
# (run name, config key, mesh shape)
RUNS = (("jamba_2x2", "jamba", (2, 2)), ("jamba_1x4", "jamba", (1, 4)),
        ("jamba_pods_2x1x2", "jamba", (2, 1, 2)),
        ("jamba_di_1x4", "jamba_di", (1, 4)),
        ("rwkv_2x2", "rwkv", (2, 2)), ("rwkv_1x4", "rwkv", (1, 4)),
        ("rwkv_pods_2x1x2", "rwkv", (2, 1, 2)),
        ("rwkv_h6_1x4", "rwkv_h6", (1, 4)))
NAMES = [r[0] for r in RUNS]
# 6 prompts: no collective of the decode has a weight's shape by chance
# (jamba's conv_w is (4, d_inner))
SEQ, ROWS, PROMPTS, PROMPT_LEN = 32, 8, 6, 16
# (run name, config key, mesh shape, per-slot positions)
DECODE_RUNS = (("jamba_2x2", "jamba", (2, 2), False),
               ("jamba_slots_1x4", "jamba", (1, 4), True),
               ("jamba_pods_slots_2x1x2", "jamba", (2, 1, 2), True),
               ("jamba_di_1x4", "jamba_di", (1, 4), False),
               ("rwkv_2x2", "rwkv", (2, 2), False),
               ("rwkv_slots_1x4", "rwkv", (1, 4), True),
               ("rwkv_pods_2x1x2", "rwkv", (2, 1, 2), False),
               ("rwkv_h6_2x2", "rwkv_h6", (2, 2), False))
DECODE_NAMES = [r[0] for r in DECODE_RUNS]
DECODE_LEN, DECODE_STEPS = 32, 3
SLOT_POS = (15, 7, 23, 9, 16, 30)
CHECKED = ("jamba_2x2", "rwkv_2x2")
# jamba's router logits: a gap above this between a token's consecutive
# top logits routes alike under the partitioned and the reference's sums
ROUTE_GAP = 1e-5
ROUTE_GAPS: list = []


def _reduced(key) -> dict:
    return {**F32, **CONFIGS[key][1]}


def _cfg(key):
    return configs.get(CONFIGS[key][0]).reduced(**_reduced(key))


@functools.lru_cache(maxsize=None)
def _reference_weights(key):
    rcfg = ref_configs.get(CONFIGS[key][0]).reduced(**_reduced(key))
    rparams = jax.jit(lambda k: RT.init_params(rcfg, k)[0])(
        jax.random.key(0))
    return rcfg, rparams, jax.tree.map(np.array, rparams)


def _port_params(key):
    """The reference's weights as the port's, a copy of its own."""
    return convert.params_from_reference(
        jax.tree.map(np.array, _reference_weights(key)[2]), _cfg(key), "cpu")


@functools.lru_cache(maxsize=None)
def _data(key):
    """Two train batches and the prompts, as numpy arrays."""
    cfg = _cfg(key)
    src = SyntheticLM(cfg.vocab_size, SEQ, ROWS, seed=3)
    batches = [{k: v.numpy() for k, v in src.batch(i).items()}
               for i in range(2)]
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (PROMPTS, PROMPT_LEN)).astype(np.int32)
    return batches, prompts


@functools.lru_cache(maxsize=None)
def _decode_start(key, slots: bool) -> dict:
    """The one-process state that every decode run starts from, as numpy:
    ``PROMPTS`` prompts of ``PROMPT_LEN`` prefilled into caches of
    ``DECODE_LEN``, at that position (lockstep) or at ``SLOT_POS``."""
    cfg = _cfg(key)
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (PROMPTS, PROMPT_LEN)).astype(np.int32)
    with torch.no_grad():
        _, state = T.prefill(_port_params(key), cfg,
                             torch.from_numpy(prompts), max_len=DECODE_LEN)
    return {"caches": [{k: v.numpy() for k, v in c.items()}
                       for c in state["caches"]],
            "pos": np.array(SLOT_POS, np.int64) if slots else state["pos"]}


@functools.lru_cache(maxsize=None)
def _decode_tokens(key) -> np.ndarray:
    return np.random.default_rng(11).integers(
        0, _cfg(key).vocab_size, (DECODE_STEPS, PROMPTS, 1)).astype(np.int32)


def _spec(key):
    return dict(config=key, arch=CONFIGS[key][0], reduced=_reduced(key),
                replace={})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of one spawn of 4 gloo processes."""
    payload = dict(
        runs=[dict(name=n, mesh=m, **_spec(k)) for n, k, m in RUNS],
        decode_runs=[dict(name=n, mesh=m, start=_decode_start(k, slots),
                          tokens=_decode_tokens(k), checks=n in CHECKED,
                          **_spec(k))
                     for n, k, m, slots in DECODE_RUNS],
        np_params={k: _reference_weights(k)[2] for k in CONFIGS},
        batches={k: _data(k)[0] for k in CONFIGS},
        prompts={k: _data(k)[1] for k in CONFIGS})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.spawn("tp", 4, tmp_path_factory.mktemp("tp_rec"), payload)
    finally:
        torch.set_num_threads(n)


def _key(run: str) -> str:
    return {n: k for n, k, _ in RUNS}[run]


def test_ranks_and_blocks(ranks):
    """No jax in the workers; the d_inner blocks and heads each rank
    computes: mamba's 128 channels over "model" of 2 and 4, 198 over 4
    ranks 50, 50, 50 and 48; rwkv's 4 heads over 2 and 4, 6 over 4 ranks
    2, 2, 2 and 0."""
    assert all(r["jax_loaded"] == [] for r in ranks)

    def blocks(run, what):
        return [r[run]["prefill"][what] for r in ranks]
    assert blocks("jamba_2x2", "inner") == [(0, 64), (64, 128)] * 2
    assert blocks("jamba_1x4", "inner") == [(0, 32), (32, 64), (64, 96),
                                            (96, 128)]
    assert blocks("jamba_di_1x4", "inner") == [(0, 50), (50, 100),
                                               (100, 150), (150, 198)]
    assert blocks("rwkv_pods_2x1x2", "rwkv_heads") == [(0, 2), (2, 4)] * 2
    assert blocks("rwkv_h6_1x4", "rwkv_heads") == [(0, 2), (2, 4), (4, 6),
                                                   (6, 6)]
    for r in ranks:
        for run in NAMES:
            assert "pim_mode='exact'" in r[run]["pim_refusal"]
            assert r[run]["placed_flag"] == (True, False)


# ------------------------------------------------------------------ train
@functools.lru_cache(maxsize=None)
def _one_process(key):
    """Two steps of the port's step on the whole batch, one process."""
    cfg = _cfg(key)
    ocfg = opt.AdamWConfig(**W.OPT_KW)
    params = _port_params(key)
    state = opt.init_state(ocfg, params)
    step = tl.make_train_step(cfg, ocfg)
    losses, norms = [], []
    with _gaps():
        for b in _data(key)[0]:
            params, state, m = step(params, state, W._as_torch(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms, dict(zip(*_tree.flatten(params)))


@functools.lru_cache(maxsize=None)
def _reference(key):
    """Two steps of the reference's jitted step."""
    rcfg, rparams, _ = _reference_weights(key)
    ocfg = ropt.AdamWConfig(**W.OPT_KW)
    step = jax.jit(rtl.make_train_step(rcfg, ocfg))
    p, s, losses, norms = rparams, ropt.init_state(ocfg, rparams), [], []
    for b in _data(key)[0]:
        p, s, m = step(p, s, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    port = convert.params_from_reference(jax.tree.map(np.array, p),
                                         _cfg(key), "cpu")
    return losses, norms, dict(zip(*_tree.flatten(port)))


def _rel_norm(got: dict, want: dict) -> float:
    num = sum(float(np.sum((np.asarray(got[k], np.float64)
                            - want[k].double().numpy()) ** 2)) for k in want)
    den = sum(float(torch.sum(want[k].double() ** 2)) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("run", NAMES)
def test_partitioned_train_step(ranks, run):
    key = _key(run)
    res = ranks[0][run]
    assert res["placed"] and res["grad_placements_ok"] and res["step"] == 2
    assert all(r[run]["placed_batch_equal"] for r in ranks)
    for other in ranks[1:]:
        assert other[run]["losses"] == res["losses"]
        assert other[run]["grad_placements_ok"]
    for losses, norms, params in (_one_process(key), _reference(key)):
        np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["grad_norms"], norms, rtol=NORM_RTOL)
        assert _rel_norm(res["params"], params) < PARAM_RTOL


# ------------------------------------------------------------------ prefill
@functools.lru_cache(maxsize=None)
def _one_process_prefill(key):
    with torch.no_grad(), _gaps():
        logits, state = T.prefill(_port_params(key), _cfg(key),
                                  torch.from_numpy(_data(key)[1]))
    return logits.numpy(), [{k: v.numpy() for k, v in c.items()}
                            for c in state["caches"]]


@functools.lru_cache(maxsize=None)
def _reference_prefill(key):
    """The reference's jitted prefill: logits and per-layer caches."""
    rcfg, rparams, _ = _reference_weights(key)
    lg, st = jax.jit(lambda p, t: RT.prefill(p, rcfg, t))(
        rparams, jnp.asarray(_data(key)[1]))
    return np.asarray(lg), _per_layer(rcfg, st["caches"])


def _per_layer(rcfg, caches) -> list:
    """The reference's caches (stacked over the repeats of each pattern
    position) as one dict per layer, numpy."""
    n_pat = len(rcfg.block_pattern)
    return [{k: np.asarray(v)[i // n_pat] for k, v in
             caches[i % n_pat].items()} for i in range(rcfg.n_layers)]


def _assemble_prefill(ranks, run: str, cfg, want_logits, want):
    logits = np.full(want_logits.shape, np.nan, np.float32)
    caches = [{k: np.full(v.shape, np.nan, np.float32) for k, v in c.items()}
              for c in want]
    for r in ranks:
        pf = r[run]["prefill"]
        assert pf["pos"] == PROMPT_LEN
        rows, nv = pf["logits"].shape[0], pf["logits"].shape[-1]
        b0 = pf["batch_index"] * rows
        v0 = 0 if nv == cfg.vocab_size else pf["model_rank"] * nv
        logits[b0:b0 + rows, :, v0:v0 + nv] = pf["logits"]
        for layer, (got, c) in enumerate(zip(caches, pf["caches"])):
            for k, blk in c.items():
                if T.block_kind(cfg, layer) == "attn":
                    s0 = pf["model_rank"] * blk.shape[1]
                    got[k][b0:b0 + rows, s0:s0 + blk.shape[1]] = blk
                    continue
                dim = 2 if k == "conv" else 1
                if k in ("x_prev", "cm_prev"):
                    got[k][b0:b0 + rows] = blk
                    continue
                full = got[k].shape[dim]
                c0 = 0 if blk.shape[dim] == full else pf[
                    "inner" if T.block_kind(cfg, layer) == "mamba"
                    else "rwkv_heads"][0]
                idx = [slice(b0, b0 + rows)] + [slice(None)] * (blk.ndim - 1)
                idx[dim] = slice(c0, c0 + blk.shape[dim])
                got[k][tuple(idx)] = blk
    return logits, caches


@pytest.mark.parametrize("run", NAMES)
def test_partitioned_prefill(ranks, run):
    """The ranks' blocks assemble into the one-process prefill and the
    reference's: logits by rows and vocab shards, attention caches by rows
    and sequence blocks, carries by rows and by the d_inner block or heads
    that ``cache_specs`` splits over "model" (whole where it does not)."""
    key = _key(run)
    cfg = _cfg(key)
    want_logits, want = _one_process_prefill(key)
    logits, caches = _assemble_prefill(ranks, run, cfg, want_logits, want)
    for wl, wc in ((want_logits, want), _reference_prefill(key)):
        np.testing.assert_allclose(logits, wl.reshape(logits.shape), **TOL)
        for layer, (got, c) in enumerate(zip(caches, wc)):
            for k, v in got.items():
                np.testing.assert_allclose(v, c[k], **TOL,
                                           err_msg=f"layer {layer} {k}")


def test_prefill_carry_layout(ranks):
    """The carries' layout under DEFAULT_RULES: d_inner over "model" of 2
    in blocks, 198 channels over 4 whole (``fit_spec_to_shape`` replicates
    them, so the ranks' blocks are gathered); 6 rwkv heads over 4 whole."""
    def shapes(run, layer):
        return {k: v.shape for k, v in
                ranks[1][run]["prefill"]["caches"][layer].items()}
    assert shapes("jamba_2x2", 0) == {"h": (3, 64, 8), "conv": (3, 3, 64)}
    assert shapes("jamba_di_1x4", 0) == {"h": (6, 198, 8),
                                         "conv": (6, 3, 198)}
    assert shapes("rwkv_1x4", 0)["h"] == (6, 1, 16, 16)
    assert shapes("rwkv_h6_1x4", 0)["h"] == (6, 6, 16, 16)


# ------------------------------------------------------------------ decode
def _decode_run(name):
    return {n: (k, m, slots) for n, k, m, slots in DECODE_RUNS}[name]


@functools.lru_cache(maxsize=None)
def _one_process_decode(key, slots: bool):
    """``DECODE_STEPS`` one-process steps from the start state: each
    step's logits and the final caches, numpy."""
    st = _decode_start(key, slots)
    cfg, params = _cfg(key), _port_params(key)
    state = W._state_from_numpy(st)
    logits = []
    with torch.no_grad(), _gaps():
        for t in _decode_tokens(key):
            lg, state = T.decode_step(params, cfg, state, torch.from_numpy(t))
            logits.append(lg.numpy().copy())
    return logits, [{k: v.numpy() for k, v in c.items()}
                    for c in state["caches"]]


@functools.lru_cache(maxsize=None)
def _reference_decode(key, slots: bool):
    """The reference's jitted ``decode_step`` from the same state (its
    caches stacked over the repeats of each pattern position)."""
    rcfg, rparams, _ = _reference_weights(key)
    st = _decode_start(key, slots)
    n_pat = len(rcfg.block_pattern)
    state = {"caches": [{k: jnp.asarray(np.stack([
        c[k] for c in st["caches"][p::n_pat]])) for k in st["caches"][p]}
        for p in range(n_pat)],
        "pos": jnp.asarray(st["pos"], jnp.int32)}
    step = jax.jit(lambda p, s, t: RT.decode_step(p, rcfg, s, t))
    logits = []
    for t in _decode_tokens(key):
        lg, state = step(rparams, state, t)
        logits.append(np.asarray(lg))
    return logits, _per_layer(rcfg, state["caches"])


def _put(out: np.ndarray, idx, blk: np.ndarray) -> None:
    """Write a rank's block; where another rank wrote it, they agree."""
    have = out[idx]
    seen = ~np.isnan(have)
    np.testing.assert_array_equal(have[seen], blk[seen])
    out[idx] = blk


def _assemble_decode(ranks, run: str, cfg):
    """The ranks' logits blocks by vocab; attention caches by rows and
    positions, carries by rows (every channel and head on each rank)."""
    logits = [np.full((PROMPTS, 1, cfg.vocab_size), np.nan)
              for _ in range(DECODE_STEPS)]
    caches = None
    for r in ranks:
        res = r["decode"][run]
        for out, blk in zip(logits, res["logits"]):
            v0 = res["vocab_start"]
            _put(out, np.s_[:, :, v0:v0 + blk.shape[-1]], blk)
        if caches is None:
            caches = [{k: np.full((PROMPTS, DECODE_LEN if "k" in c else
                                   v.shape[1]) + v.shape[2:], np.nan)
                       for k, v in c.items()} for c in res["caches"]]
        b0 = res["rows_start"]
        for got, c in zip(caches, res["caches"]):
            s0 = res["seq_start"] if "k" in c else 0
            for k, blk in c.items():
                _put(got[k], np.s_[b0:b0 + blk.shape[0],
                                   s0:s0 + blk.shape[1]],
                     blk.astype(np.float64))
    return logits, caches


@pytest.mark.parametrize("run", DECODE_NAMES)
def test_partitioned_decode(ranks, run):
    """The ranks' logits and states assembled equal the one-process
    decode's and the reference's within ``TOL``; the positions advance;
    the greedy ids over the vocab shards are the one-process argmax."""
    key, _, slots = _decode_run(run)
    cfg = _cfg(key)
    logits, caches = _assemble_decode(ranks, run, cfg)
    for want_logits, want_caches in (_one_process_decode(key, slots),
                                     _reference_decode(key, slots)):
        for got, want in zip(logits, want_logits, strict=True):
            np.testing.assert_allclose(got, want, **TOL)
        for layer, (got, want) in enumerate(zip(caches, want_caches,
                                                strict=True)):
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, **TOL,
                                           err_msg=f"layer {layer} {k}")
    start = _decode_start(key, slots)["pos"]
    want_pos = (np.asarray(start) + DECODE_STEPS).tolist()
    top = _one_process_decode(key, slots)[0][-1].argmax(-1)
    for r in ranks:
        assert r["decode"][run]["pos"] == want_pos
        np.testing.assert_array_equal(r["decode"][run]["greedy"], top)


# collectives per decode step of one layer on (2, 2): (all-gathers,
# all-reduces). mamba: in_proj's and dt_proj's columns, the conv's and the
# scan's outputs over the rows / x_proj, out_proj and the FFN's; rwkv:
# x_prev and cm_prev over the rows, r/k/v/g's columns, the scan's output
# over the rows / wo and the channel-mix's wv; attention: q, k, v and its
# output / the combine's max and sums, wo and the FFN's
PER_LAYER = {"mamba": (4, 3), "rwkv": (7, 2), "attn": (4, 4)}


@pytest.mark.parametrize("run", CHECKED)
def test_decode_gathers_no_weight(ranks, run):
    """On (2, 2) no collective of the decode steps has a parameter leaf's
    shape, global or local (size-1 dims dropped): only activations move;
    per step one all-reduce for the embedding and ``PER_LAYER`` per
    layer."""
    def squeezed(shape):
        return tuple(d for d in shape if d != 1)
    cfg = _cfg(_decode_run(run)[0])
    kinds = [T.block_kind(cfg, i) for i in range(cfg.n_layers)]
    for r in ranks:
        res = r["decode"][run]
        leaves = {squeezed(s) for s in res["leaf_shapes"]}
        moved = {squeezed(s) for s in res["collective_shapes"]}
        assert moved and not moved & leaves, moved & leaves
        assert res["collectives"] == {
            "all_gather": DECODE_STEPS * sum(PER_LAYER[k][0] for k in kinds),
            "all_reduce": DECODE_STEPS * (1 + sum(PER_LAYER[k][1]
                                                  for k in kinds))}
        assert "SERVE_RULES" in res["refusals"]["default_rules"]
        np.testing.assert_array_equal(
            res["plain_under_mesh"], _one_process_decode(
                _decode_run(run)[0], False)[0][0])


# ------------------------------------------------------------------ routing
class _gaps:
    """Record the smallest gap between a token's consecutive router logits
    among its top k + 1 in each of the port's ``moe_route`` calls made in
    the body (``ROUTE_GAPS``)."""

    def __enter__(self):
        self.orig = orig = L.moe_route

        def rec(params, cfg, x):
            with torch.no_grad():
                top = L.moe_logits(params, x).double().topk(
                    cfg.experts_per_token + 1, dim=-1).values
            ROUTE_GAPS.append(float((top[..., :-1] - top[..., 1:]).min()))
            return orig(params, cfg, x)
        L.moe_route = rec

    def __exit__(self, *exc):
        L.moe_route = self.orig


def test_jamba_routes_without_near_ties():
    """Reduced jamba's MoE layers route the parity inputs without
    near-ties in the one-process train steps, prefill and decode, so the
    partitioned and the reference's sums pick the same experts."""
    for key in ("jamba", "jamba_di"):
        _one_process(key)
        _one_process_prefill(key)
        _one_process_decode(key, False)
    assert ROUTE_GAPS and min(ROUTE_GAPS) > ROUTE_GAP, min(ROUTE_GAPS)


# ------------------------------------------------------------------ one rank
@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_one_rank_mesh_recurrent_is_the_plain_program(arch, tmp_path):
    """On a one-rank group every collective is an identity and every
    compute block is the whole leaf: reduced bf16 jamba's and rwkv6's
    partitioned train steps and prefill (DEFAULT_RULES) and decode
    (SERVE_RULES) equal the plain programs bit for bit, losses,
    parameters, logits and every cache leaf."""
    import torch.distributed as dist
    from repro_torch.dist import compat
    from repro_torch.dist import sharding as dsh
    cfg = configs.get(arch).reduced()
    ocfg = opt.AdamWConfig(**W.OPT_KW)
    data = SyntheticLM(cfg.vocab_size, SEQ, ROWS, seed=0)
    start = T.init_params(cfg, seed=0, device="cpu")
    prompts = data.batch(9)["inputs"][:4, :PROMPT_LEN]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = compat.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        specs = T.param_specs(cfg)
        out = {}
        for run in ("mesh", "plain"):
            on = mesh if run == "mesh" else None

            def placed(tree, sp):
                return dsh.place(tree, sp, mesh) if on else tree
            p = _tree.tree_map(torch.clone, start)  # placing aliases
            s = opt.init_state(ocfg, p)
            step, losses = tl.make_train_step(cfg, ocfg), []
            with dsh.axis_rules(dsh.DEFAULT_RULES), dsh.use_mesh(on):
                p, s = placed(p, specs), placed(s, opt.state_specs(specs))
                for i in range(2):
                    p, s, m = step(p, s, data.batch(i))
                    losses.append(m["loss"])
                with torch.no_grad():
                    logits, state = T.prefill(placed(start, specs), cfg,
                                              prompts)
            with dsh.axis_rules(dsh.SERVE_RULES), dsh.use_mesh(on), \
                    torch.no_grad():
                _, st = T.prefill(start, cfg, prompts, max_len=24)
                pp, st = placed(start, specs), placed(st, T.cache_specs(cfg))
                lgs, tok = [], prompts[:, :1]
                for _ in range(2):
                    lg, st = T.decode_step(pp, cfg, st, tok)
                    lgs.append(lg)
                    tok = lg.argmax(-1)
            out[run] = [[t.full_tensor() if hasattr(t, "full_tensor")
                         else t for t in ts]
                        for ts in (losses, _tree.leaves(p), [logits],
                                   _tree.leaves(state["caches"]), lgs,
                                   _tree.leaves(st["caches"]))]
    finally:
        dist.destroy_process_group()
    for got, want in zip(out["mesh"], out["plain"], strict=True):
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
