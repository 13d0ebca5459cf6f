"""The partitioned train step and prefill (``repro_torch.dist.parallel``):
FSDP, tensor and sequence parallel on 4 ranks. One spawn of 4 ``gloo``
processes on the CPU (``_torch_dist_workers.task_tp``, one intra-op
thread each, no jax in the workers); this process computes the one-process
port's and the reference's values.

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
"""

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
}
# (run name, config key, mesh shape)
RUNS = (("qwen_2x2", "qwen", (2, 2)), ("qwen_1x4", "qwen", (1, 4)),
        ("chameleon_2x2", "chameleon", (2, 2)),
        ("chameleon_1x4", "chameleon", (1, 4)),
        ("hubert_2x2", "hubert", (2, 2)), ("hubert_1x4", "hubert", (1, 4)),
        ("h6k2_1x4", "h6k2", (1, 4)), ("h10k2_1x4", "h10k2", (1, 4)),
        ("remat_2x2", "remat", (2, 2)), ("micro2_2x2", "micro2", (2, 2)),
        ("qwen_pods_2x1x2", "qwen", (2, 1, 2)))
NAMES = [r[0] for r in RUNS]
SEQ, ROWS, PROMPTS, PROMPT_LEN = 32, 8, 4, 16


def _cfg(key):
    arch, red, rep = CONFIGS[key]
    return dataclasses.replace(configs.get(arch).reduced(**red, **F32), **rep)


@functools.lru_cache(maxsize=None)
def _reference_weights(key):
    arch, red, rep = CONFIGS[key]
    rcfg = dataclasses.replace(ref_configs.get(arch).reduced(**red, **F32),
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of one spawn of 4 gloo processes."""
    keys = sorted({k for _, k, _ in RUNS})
    payload = dict(
        runs=[dict(name=n, config=k, arch=CONFIGS[k][0],
                   reduced=dict(CONFIGS[k][1], **F32), replace=CONFIGS[k][2],
                   mesh=m) for n, k, m in RUNS],
        np_params={k: _reference_weights(k)[2] for k in keys},
        batches={k: _data(k)[0] for k in keys},
        prompts={k: _data(k)[1] for k in keys})
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
    with torch.no_grad():
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
    import torch.distributed as dist
    from repro_torch.dist import compat
    from repro_torch.dist import sharding as dsh
    cfg = configs.get("qwen1.5-0.5b").reduced()
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
