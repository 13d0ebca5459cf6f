"""The port's sharding rules and spec functions against the reference's,
on the CPU, with ``==`` (no process group: rules resolve against
device-free meshes).

- ``dist.sharding``: the four rule sets; ``spec_for`` over every rule set
  on abstract 2x2, 1x4 and 2x2x2 (pod) meshes against the reference's on
  jax's ``AbstractMesh``; ``fit_spec_to_shape`` and ``sanitize_shardings``
  on those results; ``PartitionSpec``'s equality; the reference's own
  checks (``tests/test_dist_shard.py`` and
  ``tests/test_hlo_and_dist.py::TestShardingRules``) mirrored class for
  class. ``shard``'s redistribution under a mesh is held on 4 ranks in
  ``test_torch_dist_ranks.py``.
- Spec functions: ``param_specs``, ``cache_specs`` (contiguous, paged,
  int8 KV), ``plan_specs`` (exact, fast, int8) and ``state_specs`` for
  all 11 archs against the reference's, layer ``l`` against the
  reference's pattern position ``l % len(block_pattern)`` without its
  leading repeat axis; their tree paths equal those of the port's
  reduced ``init_params``, ``init_decode_state`` and compiled plans, each
  spec as long as its leaf's rank; the full-size 400B configs resolve in
  well under a second.
"""

import dataclasses
import functools
import itertools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as RefNamedSharding
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.dist import sharding as rsh
from repro.models import pim_compile as ref_pc
from repro.models import transformer as RT
from repro.train import optimizer as ropt
from repro_torch import configs
from repro_torch.dist import compat
from repro_torch.dist import sharding as dsh
from repro_torch.models import pim_compile as pc
from repro_torch.models import transformer as T
from repro_torch.train import _tree
from repro_torch.train import optimizer as opt

from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

RULES = ("DEFAULT_RULES", "SERVE_RULES", "MULTIPOD_RULES",
         "MULTIPOD_SERVE_RULES")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "pod": ((2, 2, 2), ("pod", "data", "model"))}
LOGICAL = ("batch", "cache_batch", "fsdp", "seq", "tp", "heads", "kv_heads",
           "experts", "vocab", "unknown", None)
ARCHS = sorted(configs.REGISTRY)


def meshes(name):
    sizes, names = MESHES[name]
    return (compat.AbstractMesh(sizes, names),
            jax.sharding.AbstractMesh(sizes, names))


def axes_cases():
    """Logical-axis tuples of rank 1-3 over every name (and None), plus
    every spec tuple the spec functions produce."""
    out = [c for n in (1, 2, 3) for c in itertools.product(LOGICAL, repeat=n)]
    out += [("cache_batch", "seq", "kv_heads", None),
            ("cache_batch", None, "kv_heads", None),
            ("cache_batch", "heads", None, None),
            ("experts", "fsdp", "tp"), ("experts", None, None, None, "tp")]
    return out


# ------------------------------------------------------------------ rules
def test_rule_sets_equal_reference():
    for name in RULES:
        assert getattr(dsh, name) == getattr(rsh, name)
    assert dsh.current_rules() == rsh.current_rules() == rsh.DEFAULT_RULES


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", RULES)
def test_spec_for_and_fit_match_reference(rules, mesh):
    """Every logical-axis tuple of rank <= 3 resolves as the reference
    resolves it, explicitly and under ``axis_rules``; every result fits
    the same shapes the same way (divisible, indivisible, size-1 dims)."""
    ours, ref = meshes(mesh)
    rs = getattr(dsh, rules)
    shapes = [(8, 4, 6), (3, 2, 10), (1, 12, 16), (6, 8, 1)]
    with dsh.axis_rules(rs), rsh.axis_rules(rs):
        for axes in axes_cases():
            got, want = dsh.spec_for(axes, ours, rs), rsh.spec_for(axes, ref, rs)
            assert got == want and dsh.spec_for(axes, ours) == want, axes
            assert isinstance(got, dsh.PartitionSpec)
            for shape in shapes:
                shape = (shape * 2)[:max(len(axes), 1)]
                assert dsh.fit_spec_to_shape(got, shape, ours) == \
                    rsh.fit_spec_to_shape(want, shape, ref), (axes, shape)


def test_partition_spec_equality_is_jax_s():
    for entries in [("x", None), ("x",), (("x",), None), ((), "y"),
                    (("a", "b"),), (["a", "b"], None), ()]:
        assert dsh.PartitionSpec(*entries) == P(*entries)
        assert tuple(dsh.PartitionSpec(*entries)) == tuple(P(*entries))
    assert dsh.PartitionSpec("x", None) != dsh.PartitionSpec("x")
    assert dsh.PartitionSpec(None, None) != dsh.PartitionSpec()
    assert repr(dsh.PartitionSpec("x", None)) == "PartitionSpec('x', None)"


def test_placements_of_specs():
    """Mesh axis at tensor dim d -> Shard(d) on its mesh dim; a tuple
    entry shards on each of its mesh dims in mesh order; out of order
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, _ = meshes("pod")
    cases = {P("data", "model"): (Replicate(), Shard(0), Shard(1)),
             P(None, ("data", "model")): (Replicate(), Shard(1), Shard(1)),
             P(("pod", "data"), None, "model"): (Shard(0), Shard(0),
                                                 Shard(2)),
             P(): (Replicate(),) * 3}
    for spec, want in cases.items():
        assert dsh.NamedSharding(mesh, spec).placements == want
    with pytest.raises(ValueError, match="order"):
        dsh.NamedSharding(mesh, P(("model", "data"))).placements


# ------------------------- mirror of tests/test_dist_shard.py, on the port
class TestShardNoOp:
    def test_identity_without_mesh(self):
        x = torch.ones(4, 8)
        assert dsh.shard(x, "batch", "tp") is x

    def test_identity_with_empty_rules(self):
        x = torch.ones(4, 8)
        with dsh.axis_rules(()), dsh.use_mesh(meshes("2x2")[0]):
            assert dsh.shard(x, "batch", "tp") is x

    def test_rank_mismatch_raises(self):
        with dsh.axis_rules(dsh.DEFAULT_RULES), \
                dsh.use_mesh(meshes("2x2")[0]):
            with pytest.raises(ValueError, match="rank"):
                dsh.shard(torch.ones(4, 8), "batch", "seq", "tp")

    def test_plain_tensor_under_mesh_is_this_rank_s_value(self):
        x = torch.ones(4, 8)
        with dsh.axis_rules(dsh.DEFAULT_RULES), \
                dsh.use_mesh(meshes("2x2")[0]):
            assert dsh.active_mesh() is not None
            assert dsh.shard(x, "batch", "tp") is x
        assert dsh.active_mesh() is None


class TestFitSpecRagged:
    @pytest.fixture
    def abstract_mesh(self):
        return meshes("2x2")[0]

    def test_both_axes_indivisible(self, abstract_mesh):
        spec = dsh.fit_spec_to_shape(P("data", "model"), (3, 5), abstract_mesh)
        assert spec == P(None, None)

    def test_tuple_prefix_kept(self, abstract_mesh):
        spec = dsh.fit_spec_to_shape(P(("data", "model"), None), (10, 7),
                                     abstract_mesh)
        assert spec == P("data", None)

    def test_rank_pad_not_required(self, abstract_mesh):
        spec = dsh.fit_spec_to_shape(P("data"), (4, 9, 2), abstract_mesh)
        assert spec == P("data")

    def test_overlong_spec_rejected(self, abstract_mesh):
        with pytest.raises(ValueError, match="rank"):
            dsh.fit_spec_to_shape(P("data", "model"), (4,), abstract_mesh)

    def test_zero_dim_replicates(self, abstract_mesh):
        spec = dsh.fit_spec_to_shape(P("data", "model"), (1, 4), abstract_mesh)
        assert spec == P(None, "model")


class TestSanitizeShardings:
    """The reference's cases, with ``meta`` tensors for its
    ``ShapeDtypeStruct`` leaves; each result against the reference's on
    the conftest's concrete 2x2 mesh."""

    def _both(self, small_mesh, sh_axes, shapes):
        mesh = meshes("2x2")[0]
        ours = {k: None if a is None else dsh.NamedSharding(mesh, P(*a))
                for k, a in sh_axes.items()}
        ref = {k: None if a is None else RefNamedSharding(small_mesh, P(*a))
               for k, a in sh_axes.items()}
        meta = {k: None if s is None else torch.empty(s, device="meta")
                for k, s in shapes.items()}
        abstract = {k: None if s is None else
                    jax.ShapeDtypeStruct(s, jnp.float32)
                    for k, s in shapes.items()}
        return (lambda: dsh.sanitize_shardings(ours, meta),
                lambda: rsh.sanitize_shardings(ref, abstract))

    def test_refits_indivisible(self, small_mesh):
        ours, ref = self._both(small_mesh, {"a": ("data", "model")},
                               {"a": (3, 8)})
        assert ours()["a"].spec == ref()["a"].spec == P(None, "model")

    def test_mismatched_structure_rejected(self, small_mesh):
        mesh = meshes("2x2")[0]
        sh = {"a": dsh.NamedSharding(mesh, P("data"))}
        meta = {"a": torch.empty(4, device="meta"),
                "b": torch.empty(4, device="meta")}
        with pytest.raises((ValueError, KeyError)):
            dsh.sanitize_shardings(sh, meta)

    def test_overlong_spec_rejected(self, small_mesh):
        ours, ref = self._both(small_mesh, {"a": ("data", "model")},
                               {"a": (8,)})
        with pytest.raises(ValueError):
            ref()
        with pytest.raises(ValueError):
            ours()

    def test_non_sharding_leaves_pass_through(self, small_mesh):
        ours, ref = self._both(small_mesh, {"a": ("data",), "n": None},
                               {"a": (4,), "n": None})
        assert ours()["n"] is None and ref()["n"] is None
        assert ours()["a"].spec == ref()["a"].spec == P("data")


class TestRulePrecedence:
    @pytest.fixture
    def abstract_mesh(self):
        return meshes("2x2")[0]

    def test_default_vs_serve_weights(self, abstract_mesh):
        with dsh.axis_rules(dsh.DEFAULT_RULES):
            assert dsh.spec_for(("fsdp", "tp"), abstract_mesh) == \
                P("data", "model")
        with dsh.axis_rules(dsh.SERVE_RULES):
            assert dsh.spec_for(("fsdp", "tp"), abstract_mesh) == \
                P(None, ("data", "model"))

    def test_innermost_context_wins_and_restores(self, abstract_mesh):
        with dsh.axis_rules(dsh.DEFAULT_RULES):
            with dsh.axis_rules(dsh.SERVE_RULES):
                assert dsh.spec_for(("batch",), abstract_mesh) == P()
            assert dsh.spec_for(("batch",), abstract_mesh) == P("data")

    def test_default_outside_any_context(self, abstract_mesh):
        assert dsh.current_rules() == dsh.DEFAULT_RULES
        assert dsh.spec_for(("batch",), abstract_mesh) == P("data")

    def test_multipod_rules_span_pod_axis(self):
        mesh = meshes("pod")[0]
        with dsh.axis_rules(dsh.MULTIPOD_RULES):
            assert dsh.spec_for(("batch", "seq"), mesh) == \
                P(("pod", "data"), "model")
        with dsh.axis_rules(dsh.MULTIPOD_SERVE_RULES):
            assert dsh.spec_for(("cache_batch", "seq", "kv_heads", None),
                                mesh) == P(("pod", "data"), "model")

    def test_multipod_rules_degrade_on_single_pod_mesh(self, abstract_mesh):
        with dsh.axis_rules(dsh.MULTIPOD_RULES):
            assert dsh.spec_for(("batch",), abstract_mesh) == P("data")

    def test_first_match_wins_for_overrides(self, abstract_mesh):
        rules = (("batch", "model"),) + dsh.DEFAULT_RULES
        with dsh.axis_rules(rules):
            assert dsh.spec_for(("batch",), abstract_mesh) == P("model")


# -------- mirror of tests/test_hlo_and_dist.py::TestShardingRules, on the port
class TestShardingRules:
    def test_spec_for_resolves_axes(self):
        mesh = compat.AbstractMesh((2, 2), ("data", "model"))
        with dsh.axis_rules(dsh.DEFAULT_RULES):
            assert dsh.spec_for(("batch", "seq"), mesh) == P("data", "model")
            assert dsh.spec_for(("seq", "vocab"), mesh) == P("model")

    def test_fit_spec_drops_indivisible(self):
        mesh = compat.AbstractMesh((2, 2), ("data", "model"))
        spec = dsh.fit_spec_to_shape(P("data", "model"), (3, 8), mesh)
        assert spec == P(None, "model")
        spec = dsh.fit_spec_to_shape(P(("data", "model")), (6,), mesh)
        assert spec == P("data")

    def test_serve_rules_weights_stationary(self):
        mesh = compat.AbstractMesh((2, 2), ("data", "model"))
        with dsh.axis_rules(dsh.SERVE_RULES):
            assert dsh.spec_for(("fsdp", "tp"), mesh) == \
                P(None, ("data", "model"))
            assert dsh.spec_for(("batch", None), mesh) == P()


def test_abstract_mesh_and_make_mesh_without_a_group():
    m = compat.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert m == compat.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert [t.name for t in compat.AxisType] == [
        t.name for t in jax.sharding.AxisType]
    assert compat.world_size() == 1
    with pytest.raises(RuntimeError, match="process group"):
        compat.make_mesh((1, 1), ("data", "model"), device_type="cpu")


# ------------------------------------------------------------------ specs
def _unstack(ref_blocks: list, cfg) -> list:
    """Reference per-pattern-position spec trees (leading repeat axis) ->
    one per layer, without it."""
    n_pat = len(cfg.block_pattern)
    return [None if ref_blocks[l % n_pat] is None else jax.tree.map(
        lambda ax: tuple(ax)[1:], ref_blocks[l % n_pat],
        is_leaf=lambda x: isinstance(x, tuple))
        for l in range(cfg.n_layers)]


@functools.lru_cache(maxsize=None)
def ref_specs(arch: str) -> dict:
    """The reference's spec functions on ``arch``, once per arch."""
    rcfg = ref_configs.get(arch)
    out = {"params": RT.param_specs(rcfg),
           "cache": RT.cache_specs(rcfg),
           "paged": RT.cache_specs(rcfg, paged=True),
           "int8": RT.cache_specs(
               dataclasses.replace(rcfg, kv_cache_dtype="int8"), paged=True)}
    for mode in ("exact", "fast", "int8"):
        out[f"plan_{mode}"] = ref_pc.plan_specs(
            dataclasses.replace(rcfg, pim_mode=mode))
    out["state"] = ropt.state_specs(out["params"])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_functions_match_reference(arch):
    cfg, ref = configs.get(arch), ref_specs(arch)
    ps = T.param_specs(cfg)
    assert ps["embed"] == ref["params"]["embed"]
    assert ps["final_norm"] == ref["params"]["final_norm"]
    assert ps["layers"] == _unstack(ref["params"]["blocks"], cfg)
    for key, kw, over in (("cache", {}, {}), ("paged", {"paged": True}, {}),
                          ("int8", {"paged": True},
                           {"kv_cache_dtype": "int8"})):
        got = T.cache_specs(dataclasses.replace(cfg, **over), **kw)
        assert got["pos"] == ref[key]["pos"] == ()
        assert got["caches"] == _unstack(ref[key]["caches"], cfg), key
    for mode in ("exact", "fast", "int8"):
        got = pc.plan_specs(dataclasses.replace(cfg, pim_mode=mode))
        want = ref[f"plan_{mode}"]
        assert got["head"] == want["embed"]["head"]
        assert got["layers"] == _unstack(want["blocks"], cfg), mode
    assert pc.plan_specs(dataclasses.replace(cfg, pim_mode="off")) is None
    st = opt.state_specs(ps)
    assert st["step"] == ref["state"]["step"] == ()
    assert st["m"] is ps and st["v"] is ps


def _check_tree(specs, tree):
    """Paths of the spec tree equal the tree's; every spec as long as its
    tensor leaf's rank (a per-slot ``pos`` is replicated by ``()``, as in
    the reference)."""
    assert _tree.flatten(dsh.map_specs(lambda s: 0, specs))[0] == \
        _tree.flatten(tree)[0]

    def rank(spec, leaf):
        if isinstance(leaf, torch.Tensor):
            assert len(spec) == leaf.ndim or spec == (), (spec, leaf.shape)
    dsh.map_specs(rank, specs, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_mirror_the_port_s_trees(arch):
    """At ``reduced()`` sizes: params and AdamW state, contiguous, paged
    and int8-KV decode states (per-slot pos too), compiled plans in every
    PIM mode and one layer's ``compile_layer`` plans (``CompiledPim.specs``)."""
    cfg = configs.get(arch).reduced()
    params = T.init_params(cfg, seed=0, device="cpu")
    _check_tree(T.param_specs(cfg), params)
    state = opt.init_state(opt.AdamWConfig(), params)
    _check_tree(opt.state_specs(T.param_specs(cfg)), state)
    for over, kw in (({}, {}), ({}, {"per_slot_pos": True}),
                     ({}, {"paged": T.PagedLayout(3, 4)}),
                     ({"kv_cache_dtype": "int8"},
                      {"paged": T.PagedLayout(3, 4)}),
                     ({"kv_cache_dtype": "int8"}, {})):
        c = dataclasses.replace(cfg, **over)
        st = T.init_decode_state(c, 2, 8, device="cpu", **kw)
        _check_tree(T.cache_specs(c, paged="paged" in kw), st)
    rng = np.random.default_rng(0)
    calib = (rng.integers(0, cfg.vocab_size, (2, 4))
             if cfg.input_mode == "tokens"
             else rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32))
    for mode in ("exact", "fast", "int8"):
        c = dataclasses.replace(cfg, pim_mode=mode)
        compiled = pc.compile_pim_params(params, c, calib)
        assert compiled.specs == pc.plan_specs(c)
        _check_tree(compiled.specs, compiled.plans)
    layer = next((l for l in range(cfg.n_layers)
                  if T.block_kind(cfg, l) != "rwkv"), None)
    if layer is not None:
        c = dataclasses.replace(cfg, pim_mode="exact")
        x = torch.from_numpy(rng.normal(size=(1, 4, cfg.d_model))
                             .astype(np.float32)).to(getattr(torch, c.dtype))
        one = pc.compile_layer(params["layers"][layer], c, layer, x)
        assert one.specs == pc.plan_specs(c)["layers"][layer]
        _check_tree(one.specs, one.plans)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "llama4-maverick-400b"])
def test_full_size_specs_resolve_fast(arch):
    """The published 400B-class configs: every spec function, and every
    leaf's spec resolved on a 16x16 mesh, with no array built."""
    cfg = configs.get(arch)
    mesh = compat.AbstractMesh((16, 16), ("data", "model"))
    t0 = time.perf_counter()
    trees = [T.param_specs(cfg), T.cache_specs(cfg, paged=True),
             pc.plan_specs(dataclasses.replace(cfg, pim_mode="exact")),
             opt.state_specs(T.param_specs(cfg))]
    n = [0]

    def resolve(axes):
        if axes is not None:
            dsh.spec_for(axes, mesh)
            n[0] += 1
    with dsh.axis_rules(dsh.DEFAULT_RULES):
        for t in trees:
            dsh.map_specs(resolve, t)
    took = time.perf_counter() - t0
    assert n[0] > 1000 and took < 1.0, (n[0], took)
