"""The port's distribution layer on 4 ranks: one spawn of 4 ``gloo``
processes on the CPU (``_torch_dist_workers.task_dist``, through a
``file://`` store, one intra-op thread each, no jax in the workers); this
process computes the reference's values.

- Placements of reduced qwen1.5-0.5b's params and AdamW state on a 2x2
  ``("data", "model")`` mesh under ``DEFAULT_RULES`` and ``SERVE_RULES``:
  each leaf's placements are those of the reference's resolved and fitted
  spec, its local block is the slice of the source that the rank's
  coordinate names, and ``full_tensor()`` equals the source bit for bit.
- ``shard`` redistributes a DTensor to ``P("data", "model")``, and a batch
  dim of 3 degrades to ``P(None, "model")`` (``tests/test_dist_shard.py``'s
  ``TestShardApplies``, which fails on the reference under jax 0.9).
- The data-parallel train step, 2 steps of reduced float32 qwen from the
  reference's weights: on the 2x2 mesh with 1 and 2 micro-batches, and
  under ``MULTIPOD_RULES`` on a (2, 2, 1) pod mesh (the batch over 4
  ranks). Losses within 1e-5 relative and grad norms within 1e-4 of the
  one-process step on the whole batch and of the reference's jitted step;
  parameters within 1e-3 relative global norm of both — the tolerances of
  ``tests/test_torch_train.py`` (a data-parallel gradient is a mean of
  per-rank means, which rounds differently; at step 1 AdamW moves a weight
  by about ``lr * sign(g)``, so a gradient within rounding of 0 may move
  one weight by 2 lr).
- A checkpoint saved from the 2x2 placement, restored onto a 4x1 mesh and
  onto no mesh, bit for bit.
- ``make_disaggregated_meshes`` on 4 ranks and its too-few-devices error
  (``tests/test_serve_paged.py::test_disaggregated_mesh_validation``),
  ``make_production_mesh`` and ``make_mesh`` refusing a group of 4.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefLM
from repro.dist import sharding as rsh
from repro.models import transformer as RT
from repro.train import optimizer as ropt
from repro.train import train_loop as rtl
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import _tree
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl

import _torch_dist_workers as W
from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

F32 = dict(vocab_size=64, dtype="float32")
LOSS_RTOL, NORM_RTOL, PARAM_RTOL = 1e-5, 1e-4, 1e-3


@functools.lru_cache(maxsize=None)
def _reference_weights():
    rcfg = ref_configs.get(W.ARCH).reduced(**F32)
    rparams, _ = RT.init_params(rcfg, jax.random.key(0))
    return rcfg, rparams, jax.tree.map(np.array, rparams)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of one spawn of 4 gloo processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.spawn("dist", 4, tmp_path_factory.mktemp("dist"),
                       {"np_params": _reference_weights()[2]})
    finally:
        torch.set_num_threads(n)


def test_mesh_coordinates_and_no_jax_in_workers(ranks):
    assert [r["coordinate"] for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    assert all(r["jax_loaded"] == [] for r in ranks)


# ------------------------------------------------------------ placements
def _ref_leaf_specs(cfg) -> dict:
    """path -> the reference's logical axes, per layer (its stacked specs
    without the repeat axis), params and AdamW state."""
    rps = RT.param_specs(ref_configs.get(W.ARCH).reduced())
    unstack = jax.tree.map(lambda ax: tuple(ax)[1:], rps["blocks"][0],
                           is_leaf=lambda x: isinstance(x, tuple))
    tree = {"embed": rps["embed"], "final_norm": rps["final_norm"],
            "layers": [unstack] * cfg.n_layers}
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))
    paths = _tree.flatten(T.init_params(cfg, seed=0, device="cpu"))[0]
    flat = dict(zip(paths, leaves, strict=True))
    state = ropt.state_specs(flat)
    return dict(flat, **{f"{k}/{p}": a for k in ("m", "v")
                         for p, a in state[k].items()}, step=())


def _want(axes, shape, rules) -> tuple:
    """(placements as DTensor prints them, local shape) of the reference's
    resolved and fitted spec on a 2x2 mesh."""
    mesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    spec = rsh.fit_spec_to_shape(rsh.spec_for(axes, mesh, rules), shape,
                                 mesh)
    names, out, local = ("data", "model"), ["R", "R"], list(shape)
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else e or ()):
            out[names.index(a)] = f"S({d})"
            local[d] //= 2
    return tuple(out), tuple(local)


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "SERVE_RULES"])
def test_placements_follow_the_reference_s_specs(ranks, rules):
    cfg = configs.get(W.ARCH).reduced()
    specs = _ref_leaf_specs(cfg)
    params = T.init_params(cfg, seed=0, device="cpu")
    shapes = dict(zip(*_tree.flatten(params)))
    shapes = {p: tuple(t.shape) for p, t in shapes.items()}
    shapes.update({f"{k}/{p}": s for k in ("m", "v")
                   for p, s in list(shapes.items())}, step=())
    key = "place_" + ("default" if rules == "DEFAULT_RULES" else "serve")
    sharded = 0
    for r in ranks:
        assert sorted(row["path"] for row in r[key]) == sorted(specs)
        for row in r[key]:
            want = _want(specs[row["path"]], shapes[row["path"]],
                         getattr(rsh, rules))
            assert (row["placements"], row["local_shape"]) == want, row
            assert row["block_ok"] and row["full_ok"], row
            sharded += "S" in "".join(row["placements"])
    assert sharded > 0


def test_serve_rules_keep_weights_stationary(ranks):
    """Under SERVE_RULES no weight is sharded on its fsdp (input) dim, and
    output dims shard over the whole mesh."""
    rows = {r["path"]: r for r in ranks[0]["place_serve"]}
    assert rows["layers/0/core/wq"]["placements"] == ("S(1)", "S(1)")
    assert rows["layers/0/ffn/w2"]["placements"] == ("S(0)", "S(0)")
    rows = {r["path"]: r for r in ranks[0]["place_default"]}
    assert rows["layers/0/core/wq"]["placements"] == ("S(0)", "S(1)")


# ------------------------------------------------------------------ shard
def test_shard_redistributes_under_mesh(ranks):
    for r in ranks:
        s = r["shard"]
        assert s["placements_4"] == ("S(0)", "S(1)")   # P("data", "model")
        assert s["placements_3"] == ("R", "S(1)")      # P(None, "model")
        assert s["values_4"] and s["values_3"]
        assert s["no_mesh_identity"] and s["plain_identity"]
        assert s["empty_rules_identity"]
        assert "rank" in s["rank_error"]


# ------------------------------------------------------------------ step
@functools.lru_cache(maxsize=None)
def _one_process(micro: int):
    """Two steps of the port's step on the whole batch, one process."""
    cfg = dataclasses.replace(configs.get(W.ARCH).reduced(**F32),
                              micro_batches=micro)
    ocfg = opt.AdamWConfig(**W.OPT_KW)
    params = convert.params_from_reference(  # a copy: updated in place
        jax.tree.map(np.array, _reference_weights()[2]), cfg, "cpu")
    state = opt.init_state(ocfg, params)
    step, data = tl.make_train_step(cfg, ocfg), SyntheticLM(64, 32, 8, seed=3)
    losses, norms = [], []
    for i in range(2):
        params, state, m = step(params, state, data.batch(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, dict(zip(*_tree.flatten(params)))


@functools.lru_cache(maxsize=None)
def _reference(micro: int):
    """Two steps of the reference's jitted step."""
    rcfg, rparams, _ = _reference_weights()
    rcfg = dataclasses.replace(rcfg, micro_batches=micro)
    ocfg = ropt.AdamWConfig(**W.OPT_KW)
    step = jax.jit(rtl.make_train_step(rcfg, ocfg))
    p, s = rparams, ropt.init_state(ocfg, rparams)
    data, losses, norms = RefLM(64, 32, 8, seed=3), [], []
    for i in range(2):
        p, s, m = step(p, s, data.batch(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    cfg = configs.get(W.ARCH).reduced(**F32)
    port = convert.params_from_reference(jax.tree.map(np.array, p), cfg,
                                         "cpu")
    return losses, norms, dict(zip(*_tree.flatten(port)))


def _rel_norm(got: dict, want: dict) -> float:
    num = sum(float(np.sum((np.asarray(got[k], np.float64)
                            - want[k].double().numpy()) ** 2)) for k in want)
    den = sum(float(torch.sum(want[k].double() ** 2)) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("run", [r[0] for r in W.DP_RUNS])
def test_data_parallel_step(ranks, run):
    micro = dict((r[0], r[4]) for r in W.DP_RUNS)[run]
    res = ranks[0]["step"][run]
    assert res["placed"] and res["step"] == 2
    for other in ranks[1:]:   # every rank gathers the same parameters
        o = other["step"][run]
        assert o["losses"] == res["losses"]
        assert all(np.array_equal(o["params"][k], v)
                   for k, v in res["params"].items())
    for losses, norms, params in (_one_process(micro), _reference(micro)):
        np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["grad_norms"], norms, rtol=NORM_RTOL)
        assert _rel_norm(res["params"], params) < PARAM_RTOL


# ------------------------------------------------------------ checkpoint
def test_checkpoint_restores_onto_another_mesh(ranks):
    for r in ranks:
        c = r["ckpt"]
        assert c["step"] == c["plain_step"] == 3
        assert c["extra"] == {"mesh": "2x2"}
        assert c["files"] == ["step_000000003"]
        assert c["plain_equal"]
        for row in c["rows"]:
            assert row["block_ok"] and row["full_ok"], row
        rows = {row["path"]: row for row in c["rows"]}
        # fsdp -> "data", now 4 ranks long; "model" has one rank
        assert rows["0/layers/0/core/wq"]["placements"] == ("S(0)", "S(1)")
        assert rows["0/layers/0/core/wq"]["local_shape"][0] * 4 == \
            configs.get(W.ARCH).reduced().d_model
        assert rows["1/m/layers/0/core/wq"]["placements"] == ("S(0)", "S(1)")


# ------------------------------------------------------------ meshes
def test_disaggregated_meshes(ranks):
    for rank, r in enumerate(ranks):
        m = r["meshes"]
        d = m["disagg"]
        assert d["prefill"] == [[[0, 1]]] and d["decode"] == [[[2, 3]]]
        assert d["names"] == (("pod", "data", "model"),) * 2
        mine = (0, 0, rank % 2)
        assert d["coord"] == ((mine, None) if rank < 2 else (None, mine))
        assert "512+512 devices, have 4" in m["disagg_too_few"]
        assert "4+4 devices, have 4" in m["disagg_4_4"]
        assert m["pod_mesh"] == (0, rank // 2, rank % 2)


def test_production_and_mismatched_meshes_raise(ranks):
    m = ranks[0]["meshes"]
    assert "(16, 16)" in m["production"] and "4" in m["production"]
    assert "(2, 16, 16)" in m["production_pods"]
    assert "(2, 3)" in m["make_mesh"] and "has 4" in m["make_mesh"]
