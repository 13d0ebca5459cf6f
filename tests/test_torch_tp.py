"""The partitioned train step and prefill (``repro_torch.dist.parallel``):
FSDP, tensor and sequence parallel on 4 ranks; and the partitioned decode
under SERVE_RULES. One spawn of 4 ``gloo`` processes on the CPU
(``_torch_dist_workers.task_tp``, one intra-op thread each, no jax in the
workers); this process computes the one-process port's and the
reference's values.

Each run places reduced float32 weights from the reference's init by
``param_specs`` under ``DEFAULT_RULES`` on a ``("data", "model")`` mesh of
(2, 2) or (1, 4), takes 2 train steps and runs a prefill of the rank's
rows of 4 prompts. The configs: qwen1.5-0.5b (``qkv_bias``; on (1, 4) its
2 K/V heads are fewer than the 4 model ranks), chameleon-34b
(``qk_norm``), hubert-xlarge on frame embeddings (non-causal, a vocab of
66 that 4 does not divide: the head stays replicated on (1, 4) and is
vocab-parallel on (2, 2)), 6 heads over 2 K/V heads on (1, 4) (ranks take
2, 2, 2 and 0 heads), 10 over 2 (3, 3, 3 and 1 heads; a rank's K/V heads
repeated per query head), 2 layers with remat, and 2 micro-batches; and
qwen on a (2, 1, 2) ``("pod", "data", "model")`` mesh under
``MULTIPOD_RULES`` (the batch over pods, FSDP's axis of one rank).

- Train: losses within ``LOSS_RTOL`` relative and grad norms within
  ``NORM_RTOL`` of the one-process step on the whole batch and of the
  reference's jitted step, parameters within ``PARAM_RTOL`` relative
  global norm of both (``test_torch_dist_ranks.py``'s tolerances); every
  rank reports the same losses; gradients are DTensors in their
  parameters' placements; a batch placed along its rows over the batch
  axes gives the step of the whole batch, bit for bit.
- Prefill: the ranks' logits blocks (batch rows x vocab shards) and cache
  blocks (batch rows x sequence blocks, every K/V head) assembled equal
  the one-process prefill's within ``PREFILL_TOL`` (float32: rtol and atol
  1e-5; the partitioned sums over heads and vocab shards round
  differently).
- A partitioned prefill refuses ``pim_mode="exact"``; plain parameters do
  not turn the partitioned program on.
- On a one-rank group (in this process) the partitioned step and prefill
  equal the plain ones bit for bit.
- Decode (``DECODE_RUNS``): weights placed by ``param_specs`` under
  SERVE_RULES on (2, 2) and (1, 4), MULTIPOD_SERVE_RULES on (2, 1, 2),
  from one one-process state (a prompt of ``PROMPT_LEN`` prefilled into
  caches of ``DECODE_LEN``) placed by ``cache_specs``; ``DECODE_STEPS``
  steps on whole tokens. The ranks' logits blocks assembled by vocab and
  their cache blocks by rows and positions equal the one-process
  ``decode_step``'s and the reference's ``decode_step``'s on the same
  weights and state within ``DECODE_TOL`` (float32: rtol and atol 1e-5;
  the partitioned sums over heads, vocab and key blocks round
  differently), int8 cache codes exactly. The configs: qwen
  (``qkv_bias``), chameleon (``qk_norm``), 6 heads over 2 K/V heads (a
  rank's K/V columns below one head, ``K`` below the 4 ranks), a vocab of
  66 that 4 does not divide (the embedding and head peel to "data"), an
  int8 KV cache; lockstep positions and per-slot ones at ``SLOT_POS``,
  where rows write on different "model" ranks in one step and a row at a
  block's last slot writes on the next rank in the next. No collective's
  result has a parameter leaf's shape; the greedy ids over the vocab
  shards are the one-process argmax; other rules, paged tables and
  ``pim_mode`` are refused; plain parameters under the mesh run the
  replicated program, bit for bit.
"""

import contextlib
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as RT
from repro.train import optimizer as ropt
from repro.train import train_loop as rtl
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import parallel
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import _tree
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl

import _torch_dist_workers as W
from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

LOSS_RTOL, NORM_RTOL, PARAM_RTOL = 1e-5, 1e-4, 1e-3
PREFILL_TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(dtype="float32", kv_cache_dtype="float32")

# key -> (arch, reduced() overrides, dataclasses.replace overrides)
CONFIGS = {
    "qwen": ("qwen1.5-0.5b", dict(vocab_size=64), {}),
    "chameleon": ("chameleon-34b", dict(vocab_size=64), {}),
    "hubert": ("hubert-xlarge", dict(vocab_size=66), {}),
    "h6k2": ("qwen1.5-0.5b", dict(vocab_size=64, n_heads=6, n_kv_heads=2),
             {}),
    "h10k2": ("qwen1.5-0.5b", dict(vocab_size=64, n_heads=10,
                                   n_kv_heads=2), {}),
    "remat": ("qwen1.5-0.5b", dict(vocab_size=64, n_layers=2),
              dict(remat=True)),
    "micro2": ("qwen1.5-0.5b", dict(vocab_size=64), dict(micro_batches=2)),
    "v66": ("qwen1.5-0.5b", dict(vocab_size=66), {}),
    "int8": ("qwen1.5-0.5b", dict(vocab_size=64, kv_cache_dtype="int8"), {}),
    # MoE: phi's top-2 softmax gate on 4 experts at a capacity that drops
    # slots; llama4's top-1 sigmoid gate, its MoE and dense FFNs
    # alternating; 6 experts, which 4 ranks split 2, 2, 2 and 0
    "phi": ("phi3.5-moe-42b", dict(vocab_size=64, capacity_factor=1.0), {}),
    "llama4": ("llama4-maverick-400b", dict(vocab_size=64), {}),
    "e6": ("phi3.5-moe-42b", dict(vocab_size=64, n_experts=6), {}),
}
MOE_KEYS = ("phi", "llama4", "e6")
# (run name, config key, mesh shape)
RUNS = (("qwen_2x2", "qwen", (2, 2)), ("qwen_1x4", "qwen", (1, 4)),
        ("chameleon_2x2", "chameleon", (2, 2)),
        ("chameleon_1x4", "chameleon", (1, 4)),
        ("hubert_2x2", "hubert", (2, 2)), ("hubert_1x4", "hubert", (1, 4)),
        ("h6k2_1x4", "h6k2", (1, 4)), ("h10k2_1x4", "h10k2", (1, 4)),
        ("remat_2x2", "remat", (2, 2)), ("micro2_2x2", "micro2", (2, 2)),
        ("qwen_pods_2x1x2", "qwen", (2, 1, 2)),
        ("phi_2x2", "phi", (2, 2)), ("phi_1x4", "phi", (1, 4)),
        ("llama4_2x2", "llama4", (2, 2)), ("llama4_1x4", "llama4", (1, 4)),
        ("e6_1x4", "e6", (1, 4)),
        ("phi_pods_2x1x2", "phi", (2, 1, 2)))
NAMES = [r[0] for r in RUNS]
SEQ, ROWS, PROMPTS, PROMPT_LEN = 32, 8, 4, 16
# decode: (run name, config key, mesh shape, per-slot positions); the
# batch of PROMPTS rows shares no shape with a weight of the configs
DECODE_RUNS = (("qwen_2x2", "qwen", (2, 2), False),
               ("qwen_slots_1x4", "qwen", (1, 4), True),
               ("chameleon_slots_2x2", "chameleon", (2, 2), True),
               ("h6k2_1x4", "h6k2", (1, 4), False),
               ("v66_2x2", "v66", (2, 2), False),
               ("int8_slots_1x4", "int8", (1, 4), True),
               ("int8_2x2", "int8", (2, 2), False),
               ("qwen_pods_slots_2x1x2", "qwen", (2, 1, 2), True),
               ("phi_2x2", "phi", (2, 2), False),
               ("llama4_slots_1x4", "llama4", (1, 4), True),
               ("e6_2x2", "e6", (2, 2), False),
               ("phi_pods_slots_2x1x2", "phi", (2, 1, 2), True))
DECODE_NAMES = [r[0] for r in DECODE_RUNS]
DECODE_LEN, DECODE_STEPS = 32, 3
# per-slot positions: on (1, 4) (blocks of 8) rows 0-3 write on "model"
# ranks 1, 0, 2, 1, and rows 1 and 2 sit at their blocks' last slots; on
# (2, 2) (blocks of 16) row 0 sits at block 0's last slot while row 2, on
# the other "data" rank, writes on "model" rank 1
SLOT_POS = (15, 7, 23, 9)
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
# the decode runs that also report their collectives' shapes, the leaves'
# shapes and the refusals
CHECKED = ("qwen_2x2", "phi_2x2")
# the smallest gap between a token's consecutive router logits among its
# top k + 1 in the one-process runs: the partitioned and the reference's
# sums round differently by ~1e-6, so a gap above this routes alike
ROUTE_GAP = 1e-5
# (program, config key, per-slot positions) -> each moe_route call's
# expert ids (B, n_groups, group), kept slots and smallest logit gap, in
# the one-process runs
ROUTES: dict = {}


@contextlib.contextmanager
def _routing(log: list):
    """Record each of the port's ``moe_route`` calls in this process:
    its expert ids, the dropped slots and the smallest gap between a
    token's consecutive router logits among its top k + 1."""
    orig = L.moe_route

    def rec(params, cfg, x):
        rt = orig(params, cfg, x)
        with torch.no_grad():
            logits = L.moe_logits(params, x).double()
        top = logits.topk(cfg.experts_per_token + 1, dim=-1).values
        log.append(dict(
            expert=rt.expert.numpy().copy(),
            dropped=int((~rt.keep & (rt.expert < cfg.n_experts)).sum()),
            gap=float((top[..., :-1] - top[..., 1:]).min())))
        return rt
    L.moe_route = rec
    try:
        yield log
    finally:
        L.moe_route = orig


def _reduced(key) -> dict:
    return {**F32, **CONFIGS[key][1]}


def _cfg(key):
    arch, _, rep = CONFIGS[key]
    return dataclasses.replace(configs.get(arch).reduced(**_reduced(key)),
                               **rep)


@functools.lru_cache(maxsize=None)
def _reference_weights(key):
    arch, _, rep = CONFIGS[key]
    rcfg = dataclasses.replace(ref_configs.get(arch).reduced(**_reduced(key)),
                               **rep)
    rparams = RT.init_params(rcfg, jax.random.key(0))[0]
    return rcfg, rparams, jax.tree.map(np.array, rparams)


@functools.lru_cache(maxsize=None)
def _data(key):
    """Two train batches and the prompts, as numpy arrays."""
    cfg = _cfg(key)
    rng = np.random.default_rng(5)
    if cfg.input_mode == "tokens":
        src = SyntheticLM(cfg.vocab_size, SEQ, ROWS, seed=3)
        batches = [{k: v.numpy() for k, v in src.batch(i).items()}
                   for i in range(2)]
        prompts = rng.integers(0, cfg.vocab_size, (PROMPTS, PROMPT_LEN)
                               ).astype(np.int32)
    else:
        batches = [dict(
            inputs=rng.standard_normal((ROWS, SEQ, cfg.d_model)
                                       ).astype(np.float32),
            labels=rng.integers(0, cfg.vocab_size, (ROWS, SEQ)
                                ).astype(np.int32)) for _ in range(2)]
        prompts = rng.standard_normal((PROMPTS, PROMPT_LEN, cfg.d_model)
                                      ).astype(np.float32)
    return batches, prompts


RUNS_KEYS = sorted({k for _, k, _ in RUNS})


def _port_params(key):
    """The reference's weights as the port's, a copy of its own."""
    return convert.params_from_reference(
        jax.tree.map(np.array, _reference_weights(key)[2]), _cfg(key), "cpu")


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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of one spawn of 4 gloo processes."""
    keys = sorted({k for _, k, _ in RUNS} | {k for _, k, _, _ in DECODE_RUNS})
    payload = dict(
        runs=[dict(name=n, config=k, arch=CONFIGS[k][0],
                   reduced=_reduced(k), replace=CONFIGS[k][2],
                   mesh=m) for n, k, m in RUNS],
        decode_runs=[dict(name=n, config=k, arch=CONFIGS[k][0],
                          reduced=_reduced(k), replace=CONFIGS[k][2],
                          mesh=m, start=_decode_start(k, slots),
                          tokens=_decode_tokens(k), checks=n in CHECKED)
                     for n, k, m, slots in DECODE_RUNS],
        np_params={k: _reference_weights(k)[2] for k in keys},
        batches={k: _data(k)[0] for k in RUNS_KEYS},
        prompts={k: _data(k)[1] for k in RUNS_KEYS})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.spawn("tp", 4, tmp_path_factory.mktemp("tp"), payload)
    finally:
        torch.set_num_threads(n)


def test_ranks_and_no_jax_in_workers(ranks):
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert all(r["jax_loaded"] == [] for r in ranks)
    assert [r["qwen_2x2"]["coordinate"] for r in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_head_assignment():
    """Whole heads per rank, ceil(H / |model|) in order; the K/V heads a
    rank reads, repeated where they do not group evenly."""
    assert [parallel.head_range(40, 16, r) for r in (0, 12, 13, 14, 15)] \
        == [(0, 3), (36, 39), (39, 40), (40, 40), (40, 40)]
    assert [parallel.head_range(16, 16, r) for r in (0, 15)] == \
        [(0, 1), (15, 16)]
    # qwen2.5-32b: 40 heads over 8 K/V heads (5 a group) on 16 ranks
    assert parallel.kv_heads_for(40, 8, 0, 3) == (0, 1, None)
    assert parallel.kv_heads_for(40, 8, 3, 6) == (0, 2, [0, 0, 1])
    assert parallel.kv_heads_for(40, 8, 40, 40) == (0, 0, None)
    # yi-6b: 32 over 4 on 16 ranks, two heads of one group each
    assert parallel.kv_heads_for(32, 4, 30, 32) == (3, 4, None)
    assert parallel.kv_heads_for(16, 16, 4, 5) == (4, 5, None)


# ------------------------------------------------------------------ train
@functools.lru_cache(maxsize=None)
def _one_process(key):
    """Two steps of the port's step on the whole batch, one process."""
    cfg = _cfg(key)
    ocfg = opt.AdamWConfig(**W.OPT_KW)
    params = convert.params_from_reference(  # a copy: updated in place
        jax.tree.map(np.array, _reference_weights(key)[2]), cfg, "cpu")
    state = opt.init_state(ocfg, params)
    step = tl.make_train_step(cfg, ocfg)
    losses, norms = [], []
    with _routing(ROUTES.setdefault(("train", key, False), [])):
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
    key = dict((n, k) for n, k, _ in RUNS)[run]
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
    cfg = _cfg(key)
    params = convert.params_from_reference(
        jax.tree.map(np.array, _reference_weights(key)[2]), cfg, "cpu")
    with torch.no_grad(), _routing(ROUTES.setdefault(("prefill", key,
                                                       False), [])):
        logits, state = T.prefill(params, cfg,
                                  torch.from_numpy(_data(key)[1]))
    return logits.numpy(), state


@pytest.mark.parametrize("run", NAMES)
def test_partitioned_prefill(ranks, run):
    """The ranks' blocks assemble into the one-process prefill: logits by
    batch rows and vocab shards, caches by batch rows and sequence
    blocks with every K/V head."""
    key = dict((n, k) for n, k, _ in RUNS)[run]
    cfg = _cfg(key)
    want_logits, want = _one_process_prefill(key)
    logits = np.full(want_logits.shape, np.nan, np.float32)
    caches = [{k: np.full(v.shape, np.nan, np.float32) for k, v in c.items()}
              for c in want["caches"]]
    for r in ranks:
        pf = r[run]["prefill"]
        assert pf["pos"] == PROMPT_LEN
        rows, nv = pf["logits"].shape[0], pf["logits"].shape[-1]
        b0 = pf["batch_index"] * rows
        v0 = 0 if nv == cfg.vocab_size else pf["model_rank"] * nv
        logits[b0:b0 + rows, :, v0:v0 + nv] = pf["logits"]
        for got, c in zip(caches, pf["caches"]):
            for k, blk in c.items():
                assert blk.shape[2] == cfg.n_kv_heads
                s0 = pf["model_rank"] * blk.shape[1]
                got[k][b0:b0 + rows, s0:s0 + blk.shape[1]] = blk
    np.testing.assert_allclose(logits, want_logits, **PREFILL_TOL)
    for got, c in zip(caches, want["caches"]):
        for k, v in c.items():
            np.testing.assert_allclose(got[k], v.numpy(), **PREFILL_TOL)


def test_uneven_heads_and_refusals(ranks):
    """(1, 4) ranks of 6 and 10 heads over 2 K/V heads; a partitioned
    prefill refuses pim_mode 'exact'; only placed parameters turn the
    partitioned program on."""
    assert [r["h6k2_1x4"]["prefill"]["heads"] for r in ranks] == \
        [(0, 2), (2, 4), (4, 6), (6, 6)]
    assert [r["h10k2_1x4"]["prefill"]["kv"] for r in ranks] == \
        [(0, 1, None), (0, 2, [0, 0, 1]), (1, 2, None), (1, 2, None)]
    for r in ranks:
        for run in NAMES:
            assert "pim_mode='exact'" in r[run]["pim_refusal"]
            assert r[run]["placed_flag"] == (True, False)


def test_one_rank_mesh_is_the_plain_program(tmp_path):
    """On a one-rank group every collective is an identity and the loss
    takes the plain path (the vocab is whole on one rank): the partitioned
    step and prefill of reduced bf16 qwen equal the plain ones bit for
    bit, as the card's ``dist`` phase holds them at published size."""
    _one_rank_equals_plain(configs.get("qwen1.5-0.5b").reduced(), tmp_path)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b", "llama4-maverick-400b"])
def test_one_rank_mesh_moe_is_the_plain_program(arch, tmp_path):
    """The MoE programs on a one-rank group: the rank holds every expert,
    so the partitioned step and prefill of reduced bf16 phi3.5-moe-42b
    (top-2) and llama4-maverick-400b (top-1, MoE and dense FFNs) equal the
    plain ones bit for bit."""
    _one_rank_equals_plain(configs.get(arch).reduced(), tmp_path)


def _one_rank_equals_plain(cfg, tmp_path) -> None:
    """Two train steps and a prefill under a (1, 1) mesh with placed
    parameters, and without a mesh, in this process: losses, parameters,
    logits and caches equal bit for bit."""
    import torch.distributed as dist
    from repro_torch.dist import compat
    from repro_torch.dist import sharding as dsh
    ocfg = opt.AdamWConfig(**W.OPT_KW)
    data = SyntheticLM(cfg.vocab_size, SEQ, ROWS, seed=0)
    start = T.init_params(cfg, seed=0, device="cpu")
    prompts = data.batch(9)["inputs"][:PROMPTS, :PROMPT_LEN]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = compat.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        specs = T.param_specs(cfg)
        out = {}
        for run in ("mesh", "plain"):
            p = _tree.tree_map(torch.clone, start)  # placing aliases
            s = opt.init_state(ocfg, p)
            step, losses = tl.make_train_step(cfg, ocfg), []
            with dsh.axis_rules(dsh.DEFAULT_RULES), \
                    dsh.use_mesh(mesh if run == "mesh" else None):
                if run == "mesh":
                    p = dsh.place(p, specs, mesh)
                    s = dsh.place(s, opt.state_specs(specs), mesh)
                for i in range(2):
                    p, s, m = step(p, s, data.batch(i))
                    losses.append(m["loss"])
                with torch.no_grad():
                    logits, state = T.prefill(
                        dsh.place(start, specs, mesh) if run == "mesh"
                        else start, cfg, prompts)
            if run == "mesh":
                p = _tree.tree_map(lambda t: t.full_tensor(), p)
            out[run] = (losses, _tree.leaves(p), logits,
                        _tree.leaves(state["caches"]))
    finally:
        dist.destroy_process_group()
    (lm, pm, gm, cm), (lp, pp, gp, cp) = out["mesh"], out["plain"]
    assert all(torch.equal(a, b) for a, b in zip(lm, lp))
    assert all(torch.equal(a, b) for a, b in zip(pm, pp, strict=True))
    assert torch.equal(gm, gp)
    assert all(torch.equal(a, b) for a, b in zip(cm, cp, strict=True))


# ------------------------------------------------------------------ moe
@pytest.mark.parametrize("key", MOE_KEYS)
def test_moe_routes_without_near_ties(key):
    """The parity inputs route without near-ties: in the one-process train
    steps, prefill and decode, a token's consecutive router logits among
    its top k + 1 lie more than ``ROUTE_GAP`` apart, so the partitioned
    and the reference's sums (and ``torch.topk`` against ``lax.top_k``)
    pick and order the same experts; phi's capacity drops slots in each."""
    _one_process(key)
    _one_process_prefill(key)
    for _, k, _, slots in DECODE_RUNS:
        if k == key:
            _one_process_decode(key, slots)
    logs: dict = {}
    for (what, k, _), log in ROUTES.items():
        if k == key:
            logs.setdefault(what, []).extend(log)
    assert sorted(logs) == ["decode", "prefill", "train"]
    for what, log in logs.items():
        assert log, what
        gap = min(r["gap"] for r in log)
        assert gap > ROUTE_GAP, (what, gap)
        if key == "phi":
            assert sum(r["dropped"] for r in log) > 0, what


def _moe_runs(runs) -> list:
    return [r[0] for r in runs if r[1] in MOE_KEYS]


@pytest.mark.parametrize("run", _moe_runs(RUNS))
def test_moe_prefill_ranks_route_alike(ranks, run):
    """Each rank routes the whole sequence of its batch rows: every rank's
    expert ids, assembled by rows, equal the one-process prefill's."""
    key = dict((n, k) for n, k, _ in RUNS)[run]
    _one_process_prefill(key)
    want = [r["expert"] for r in ROUTES[("prefill", key, False)]]
    for r in ranks:
        pf = r[run]["prefill"]
        assert len(pf["routes"]) == len(want)
        for got, w in zip(pf["routes"], want):
            b0 = pf["batch_index"] * got.shape[0]
            np.testing.assert_array_equal(got, w[b0:b0 + got.shape[0]])


@pytest.mark.parametrize("run", _moe_runs(DECODE_RUNS))
def test_moe_decode_ranks_route_alike(ranks, run):
    """Every rank routes the whole batch as one dispatch group, as the
    one-process decode does, step by step."""
    key, _, slots = _decode_run(run)
    _one_process_decode(key, slots)
    want = [r["expert"] for r in ROUTES[("decode", key, slots)]]
    for r in ranks:
        got = r["decode"][run]["routes"]
        assert len(got) == len(want) == DECODE_STEPS * sum(
            L.is_moe_layer(_cfg(key), i) for i in range(_cfg(key).n_layers))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_moe_expert_ranges(ranks):
    """The experts each rank computes. Train and prefill under
    DEFAULT_RULES / MULTIPOD_RULES: 4 experts split 2 and 2 over "model"
    of 2; 6 over 4 ranks 2, 2, 2 and 0 (the leaf replicated). Decode
    under SERVE_RULES: 4 experts over the 4 ranks of ("data", "model");
    6 peel to "data" (3 a data rank, replicated over "model"); under
    MULTIPOD_SERVE_RULES 4 over "model" of 2, alike on both pods."""
    def prefill(run):
        return [r[run]["prefill"]["experts"] for r in ranks]

    def decode(run):
        return [tuple(r["decode"][run]["experts"][0]) for r in ranks]
    for run in ("phi_2x2", "llama4_2x2", "phi_pods_2x1x2"):
        assert prefill(run) == [(0, 2), (2, 4), (0, 2), (2, 4)]
    for run in ("phi_1x4", "llama4_1x4"):
        assert prefill(run) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert prefill("e6_1x4") == [(0, 2), (2, 4), (4, 6), (6, 6)]
    assert decode("phi_2x2") == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert decode("llama4_slots_1x4") == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert decode("e6_2x2") == [(0, 3), (0, 3), (3, 6), (3, 6)]
    assert decode("phi_pods_slots_2x1x2") == [(0, 2), (2, 4), (0, 2),
                                              (2, 4)]


def test_moe_decode_gathers_no_weight(ranks):
    """phi's partitioned decode on (2, 2) moves no weight: no collective's
    result has a parameter leaf's shape, the expert leaves' included,
    global or local (size-1 dims dropped); per step and layer 4
    all-gathers (q, k, v, the attention output) and 5 all-reduces (the
    embedding, the combine's max and sums, ``wo``, the experts'
    outputs)."""
    def squeezed(shape):
        return tuple(d for d in shape if d != 1)
    layers = _cfg("phi").n_layers
    for r in ranks:
        res = r["decode"]["phi_2x2"]
        leaves = {squeezed(s) for s in res["leaf_shapes"]}
        assert (4, 64, 128) in res["leaf_shapes"]  # w1 whole
        moved = {squeezed(s) for s in res["collective_shapes"]}
        assert moved and not moved & leaves, moved & leaves
        assert res["collectives"] == {
            "all_gather": 4 * layers * DECODE_STEPS,
            "all_reduce": (4 * layers + 1) * DECODE_STEPS}


# ------------------------------------------------------------------ decode
def _decode_run(name):
    return {n: (k, m, slots) for n, k, m, slots in DECODE_RUNS}[name]


def _start_torch(key, slots: bool) -> dict:
    st = _decode_start(key, slots)
    pos = st["pos"]
    return {"caches": [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
                       for c in st["caches"]],
            "pos": pos if isinstance(pos, int) else torch.from_numpy(
                pos.copy())}


@functools.lru_cache(maxsize=None)
def _one_process_decode(key, slots: bool):
    """``DECODE_STEPS`` one-process steps from the start state: each
    step's logits and the final caches, numpy."""
    cfg, params, state = _cfg(key), _port_params(key), _start_torch(key,
                                                                    slots)
    logits = []
    with torch.no_grad(), _routing(ROUTES.setdefault(("decode", key, slots),
                                                     [])):
        for t in _decode_tokens(key):
            lg, state = T.decode_step(params, cfg, state, torch.from_numpy(t))
            logits.append(lg.numpy().copy())
    return logits, [{k: v.numpy() for k, v in c.items()}
                    for c in state["caches"]]


@functools.lru_cache(maxsize=None)
def _reference_decode(key, slots: bool):
    """The reference's jitted ``decode_step`` from the same state (its
    caches stacked over the layers, one pattern position): each step's
    logits and the final caches per layer, numpy."""
    import jax.numpy as jnp
    rcfg, rparams, _ = _reference_weights(key)
    st = _decode_start(key, slots)
    n_pat = len(rcfg.block_pattern)
    assert set(rcfg.block_pattern) == {"attn"}
    state = {"caches": [{k: jnp.asarray(np.stack([
        c[k] for c in st["caches"][p::n_pat]])) for k in st["caches"][0]}
        for p in range(n_pat)],
        "pos": jnp.asarray(st["pos"], jnp.int32)}
    step = jax.jit(lambda p, s, t: RT.decode_step(p, rcfg, s, t))
    logits = []
    for t in _decode_tokens(key):
        lg, state = step(rparams, state, t)
        logits.append(np.asarray(lg))
    stacked = [{k: np.asarray(v) for k, v in c.items()}
               for c in state["caches"]]
    return logits, [{k: v[i // n_pat] for k, v in stacked[i % n_pat].items()}
                    for i in range(rcfg.n_layers)]


def _put(out: np.ndarray, idx, blk: np.ndarray) -> None:
    """Write a rank's block; where another rank wrote it, they agree."""
    have = out[idx]
    seen = ~np.isnan(have)
    np.testing.assert_array_equal(have[seen], blk[seen])
    out[idx] = blk


def _assembled(ranks, run: str, cfg):
    """The ranks' logits blocks (every row, the rank's vocab block) by
    vocab, and their cache blocks by rows and positions, in float64."""
    logits = [np.full((PROMPTS, 1, cfg.vocab_size), np.nan)
              for _ in range(DECODE_STEPS)]
    caches = None
    for r in ranks:
        res = r["decode"][run]
        for out, blk in zip(logits, res["logits"]):
            v0 = res["vocab_start"]
            _put(out, np.s_[:, :, v0:v0 + blk.shape[-1]], blk)
        if caches is None:
            caches = [{k: np.full((PROMPTS, DECODE_LEN) + v.shape[2:], np.nan)
                       for k, v in c.items()} for c in res["caches"]]
        b0, s0 = res["rows_start"], res["seq_start"]
        for got, c in zip(caches, res["caches"]):
            for k, blk in c.items():
                _put(got[k], np.s_[b0:b0 + blk.shape[0],
                                   s0:s0 + blk.shape[1]],
                     blk.astype(np.float64))
    return logits, caches


@pytest.mark.parametrize("run", DECODE_NAMES)
def test_partitioned_decode(ranks, run):
    """The ranks' logits and caches assembled equal the one-process
    decode's and the reference's within ``DECODE_TOL`` (int8 codes
    exactly); the positions advance; the greedy ids over the vocab shards
    are the one-process argmax."""
    key, _, slots = _decode_run(run)
    cfg = _cfg(key)
    logits, caches = _assembled(ranks, run, cfg)
    for want_logits, want_caches in (_one_process_decode(key, slots),
                                     _reference_decode(key, slots)):
        for got, want in zip(logits, want_logits, strict=True):
            np.testing.assert_allclose(got, want, **DECODE_TOL)
        for got, want in zip(caches, want_caches, strict=True):
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                if v.dtype == np.int8:
                    np.testing.assert_array_equal(got[k], v)
                else:
                    np.testing.assert_allclose(got[k], v, **DECODE_TOL)
    start = _decode_start(key, slots)["pos"]
    want_pos = (np.asarray(start) + DECODE_STEPS).tolist()
    top = _one_process_decode(key, slots)[0][-1].argmax(-1)
    for r in ranks:
        assert r["decode"][run]["pos"] == want_pos
        np.testing.assert_array_equal(r["decode"][run]["greedy"], top)


def test_decode_gathers_no_weight(ranks):
    """On (2, 2) no collective's result has a parameter leaf's shape,
    global or local (size-1 dims dropped): only activations move, per
    step and layer 4 all-gathers (q, k, v, the attention output) and 5
    all-reduces (the embedding, the combine's max and sums, ``wo``,
    ``w2``)."""
    def squeezed(shape):
        return tuple(d for d in shape if d != 1)
    layers = _cfg("qwen").n_layers
    for r in ranks:
        res = r["decode"]["qwen_2x2"]
        leaves = {squeezed(s) for s in res["leaf_shapes"]}
        moved = {squeezed(s) for s in res["collective_shapes"]}
        assert moved and not moved & leaves, moved & leaves
        assert res["collectives"] == {
            "all_gather": 4 * layers * DECODE_STEPS,
            "all_reduce": (4 * layers + 1) * DECODE_STEPS}


def test_decode_refusals_and_plain_parameters(ranks):
    """A partitioned decode refuses rules other than the SERVE ones, paged
    block tables and ``pim_mode`` other than off; plain parameters under
    the mesh and SERVE_RULES run the replicated program, bit for bit."""
    want = _one_process_decode("qwen", False)[0][0]
    for r in ranks:
        res = r["decode"]["qwen_2x2"]
        ref = res["refusals"]
        assert "SERVE_RULES" in ref["default_rules"]
        assert "paged" in ref["paged"]
        assert "pim_mode='exact'" in ref["pim"]
        np.testing.assert_array_equal(res["plain_under_mesh"], want)


def test_serve_partition_is_made_once_per_tree(ranks, tmp_path):
    """Every rank's decode steps reuse the ``ServePartition`` built for
    their placed tree; in process, on a one-rank group, a second placed
    tree gets its own, and freeing a tree drops its partition from the
    mesh."""
    import gc
    import torch.distributed as dist
    from repro_torch.dist import compat
    from repro_torch.dist import sharding as dsh
    for r in ranks:
        assert all(r["decode"][n]["partition_kept"] for n in DECODE_NAMES)
    cfg = _cfg("qwen")
    start = _port_params("qwen")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = compat.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        with dsh.axis_rules(dsh.SERVE_RULES), dsh.use_mesh(mesh):
            a = dsh.place(_tree.tree_map(torch.clone, start),
                          T.param_specs(cfg), mesh)
            b = dsh.place(_tree.tree_map(torch.clone, start),
                          T.param_specs(cfg), mesh)
            pa = T.partition(a, cfg, decode=True)
            assert T.partition(a, cfg, decode=True) is pa
            assert T.partition(b, cfg, decode=True) is not pa
            assert len(mesh._serve_partitions) == 2
            del a, pa
            gc.collect()
            assert len(mesh._serve_partitions) == 1
    finally:
        dist.destroy_process_group()
