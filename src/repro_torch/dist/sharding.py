"""Logical-axis sharding rules (GShard / t5x style) on ``DeviceMesh`` and
``DTensor``.

Port of ``repro.dist.sharding``. Model code names array axes *logically*
("batch", "fsdp", "tp", ...). A rule set maps each logical axis to zero or
more *physical* mesh axes; ``spec_for`` resolves a tuple of logical axes
against the rules and a mesh into a ``PartitionSpec``, dropping any mesh
axis already used by an earlier dimension (a mesh axis shards at most one
dimension of an array: duplicates degrade to replication, never an
error). The same annotation therefore resolves on a train mesh, a serve
mesh, or no mesh at all.

Rule sets are ordered ``(logical_axis, physical_axes)`` pairs; first
match wins, so a more specific rule set is built by prepending overrides.
Physical axes may be ``None`` (always replicate), one mesh-axis name, or a
tuple of names (shard over their product).

The reference is single-controller: one process sees every device and
GSPMD partitions under ``with mesh:``. Torch is multi-controller, one
process per rank, so the port resolves the same specs into DTensor
placements (``NamedSharding.placements``): mesh axis ``a`` named at tensor
dim ``d`` is ``Shard(d)`` on ``a``'s mesh dim, every other mesh dim
``Replicate()``; a tuple entry shards its dim on each of its mesh dims,
major first in mesh order, which is jax's order for ``P(("data",
"model"))``. ``use_mesh`` stands for ``with mesh:``; ``shard`` is the
counterpart of ``with_sharding_constraint`` on a DTensor (a plain tensor
is this rank's own value in eager SPMD and passes unchanged), and
``place`` puts a tree's leaves on a mesh by their specs.

Spec trees (``transformer.param_specs`` and the like) are nested dicts and
lists whose leaves are tuples of logical axes (``map_specs`` walks them);
a ``None`` leaf stands for an absent subtree (an rwkv layer's plans).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Sequence

import torch

from repro_torch.dist.compat import AbstractMesh
from repro_torch.train import _tree

# one logical axis -> physical mesh axes (None | str | tuple of str)
Rules = tuple[tuple[str, None | str | tuple[str, ...]], ...]

# Train / prefill, single pod ("data", "model"): FSDP over data, tensor
# parallelism (and sequence parallelism for activations) over model.
DEFAULT_RULES: Rules = (
    ("batch", "data"),
    ("cache_batch", "data"),
    ("fsdp", "data"),
    ("seq", "model"),
    ("tp", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("experts", "model"),
    ("vocab", "model"),
)

# Decode, single pod: weights are stationary and shard their output dims
# over the *whole* mesh (no fsdp — no gathers on the latency path); the
# per-request batch rides on the KV cache's cache_batch axis while the
# activation "batch" annotation replicates.
SERVE_RULES: Rules = (
    ("batch", None),
    ("cache_batch", "data"),
    ("fsdp", None),
    ("seq", "model"),
    ("tp", ("data", "model")),
    ("heads", ("data", "model")),
    ("kv_heads", ("data", "model")),
    ("experts", ("data", "model")),
    ("vocab", ("data", "model")),
)

# Train / prefill across pods ("pod", "data", "model"): pure data
# parallelism over the pod axis (gradients all-reduce across pods once
# per step), FSDP kept intra-pod where the links are fast.
MULTIPOD_RULES: Rules = (
    ("batch", ("pod", "data")),
    ("cache_batch", ("pod", "data")),
    ("fsdp", "data"),
    ("seq", "model"),
    ("tp", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("experts", "model"),
    ("vocab", "model"),
)

# Decode across pods: each pod holds a full weight replica (tp spans one
# pod's mesh), requests split across pods via cache_batch.
MULTIPOD_SERVE_RULES: Rules = (
    ("batch", None),
    ("cache_batch", ("pod", "data")),
    ("fsdp", None),
    ("seq", "model"),
    ("tp", ("data", "model")),
    ("heads", ("data", "model")),
    ("kv_heads", ("data", "model")),
    ("experts", ("data", "model")),
    ("vocab", ("data", "model")),
)


class PartitionSpec(tuple):
    """One entry per array dim: None (replicated), a mesh-axis name, or a
    tuple of names. Compares as a tuple, as jax's does (no trailing-None
    trimming in ``==``: ``spec_for`` trims); a one-name tuple entry is
    stored as the name and an empty one as None, as in jax."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class _Stack(threading.local):
    def __init__(self):
        self.rules: list[Rules] = []
        self.meshes: list = []


_ctx = _Stack()


@contextlib.contextmanager
def axis_rules(rules: Rules):
    """Bind a rule set for the dynamic extent of the context (re-entrant;
    the innermost binding wins)."""
    _ctx.rules.append(tuple(rules))
    try:
        yield
    finally:
        _ctx.rules.pop()


def current_rules() -> Rules:
    """The innermost bound rule set, or DEFAULT_RULES outside any
    ``axis_rules`` context."""
    return _ctx.rules[-1] if _ctx.rules else DEFAULT_RULES


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh for the dynamic
    extent of the context: the counterpart of the reference's ``with
    mesh:``. Re-entrant; the innermost wins."""
    _ctx.meshes.append(mesh)
    try:
        yield mesh
    finally:
        _ctx.meshes.pop()


def active_mesh():
    """The mesh bound by the innermost ``use_mesh``, or None."""
    return _ctx.meshes[-1] if _ctx.meshes else None


def _lookup(rules: Rules, logical: str):
    for name, phys in rules:
        if name == logical:
            return phys
    return None


def _axis_names(mesh) -> tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def _mesh_sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(logical_axes: Sequence[str | None], mesh,
             rules: Rules | None = None) -> PartitionSpec:
    """Resolve logical axes to a ``PartitionSpec`` for ``mesh``.

    Unknown logical axes, mesh axes the mesh doesn't have, and mesh axes
    already claimed by an earlier dimension all resolve to replication.
    Trailing replicated dims are trimmed (``P("x", None)`` -> ``P("x")``)
    so specs compare cleanly.
    """
    rules = current_rules() if rules is None else rules
    sizes = _mesh_sizes(mesh)
    used: set[str] = set()
    entries: list[None | str | tuple[str, ...]] = []
    for ax in logical_axes:
        if ax is None:
            entries.append(None)
            continue
        phys = _lookup(rules, ax)
        if phys is None:
            entries.append(None)
            continue
        tup = (phys,) if isinstance(phys, str) else tuple(phys)
        tup = tuple(p for p in tup if p in sizes)
        if not tup or any(p in used for p in tup):
            entries.append(None)
            continue
        used.update(tup)
        entries.append(tup[0] if len(tup) == 1 else tup)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def fit_spec_to_shape(spec: PartitionSpec, shape: Sequence[int],
                      mesh) -> PartitionSpec:
    """Drop sharded axes that do not evenly divide their dimension.

    For a tuple entry, trailing sub-axes are peeled off until the product
    of the remaining axis sizes divides the dim (a prefix of a product
    sharding is still a valid sharding); a fully peeled entry replicates.
    """
    entries = tuple(spec)
    if len(entries) > len(shape):
        if any(e is not None for e in entries[len(shape):]):
            raise ValueError(
                f"spec {spec} has rank {len(entries)} but shape {tuple(shape)} "
                f"has rank {len(shape)}")
        entries = entries[:len(shape)]
    sizes = _mesh_sizes(mesh)
    out: list[None | str | tuple[str, ...]] = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        tup = (e,) if isinstance(e, str) else tuple(e)
        while tup:
            n = 1
            for p in tup:
                n *= sizes[p]
            if dim % n == 0:
                break
            tup = tup[:-1]
        if not tup:
            out.append(None)
        else:
            out.append(tup[0] if len(tup) == 1 else tup)
    return PartitionSpec(*out)


class NamedSharding:
    """A mesh and a ``PartitionSpec`` over its axis names; ``placements``
    are the spec's DTensor placements, one per mesh dim."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = _axis_names(self.mesh)
        out: list = [Replicate()] * len(names)
        for d, e in enumerate(self.spec):
            if e is None:
                continue
            axes = (e,) if isinstance(e, str) else e
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(
                    f"spec entry {e} at dim {d} lists mesh axes out of mesh "
                    f"order {names}: DTensor shards a dim major-first in "
                    "mesh order")
            for m in dims:
                out[m] = Shard(d)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _paths(tree: Any) -> list[str]:
    return _tree.flatten(tree)[0]


def sanitize_shardings(shardings, abstract_tree):
    """Validate a sharding tree against the matching tree of arrays (or
    ``meta`` tensors: anything with a ``.shape``).

    Every ``NamedSharding`` leaf is re-fit to its array's concrete shape
    (indivisible axes degrade to replication instead of failing at
    placement); a spec whose rank exceeds the array's, or a tree whose
    structure does not match ``abstract_tree``, raises ``ValueError``.
    """
    if _paths(shardings) != _paths(abstract_tree):
        raise ValueError(
            f"sharding pytree does not match abstract tree: "
            f"{_paths(shardings)} != {_paths(abstract_tree)}")

    def _fix(sh, ab):
        if not isinstance(sh, NamedSharding):
            return sh
        return NamedSharding(sh.mesh,
                             fit_spec_to_shape(sh.spec, tuple(ab.shape),
                                               sh.mesh))

    return _tree.tree_map(_fix, shardings, abstract_tree)


def shard(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axis names.

    Under an active mesh (``use_mesh``) and a non-empty rule set a
    ``DTensor`` is redistributed to the resolved and fitted placements. A
    no-op otherwise, and for a plain tensor, which is this rank's own
    value in eager SPMD. The rank check runs in every case, so annotation
    bugs surface in CPU tests rather than on the first production mesh.
    """
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"shard() got {len(logical_axes)} logical axes "
            f"{logical_axes} for an array of rank {x.ndim}")
    mesh = active_mesh()
    if mesh is None:
        return x
    rules = current_rules()
    if not rules:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = fit_spec_to_shape(spec_for(logical_axes, mesh, rules), x.shape,
                             mesh)
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements)


def map_specs(fn: Callable, specs: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree (dicts and lists whose leaves
    are logical-axis tuples, or None) and trees of its structure."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, list):
        if any(len(t) != len(specs) for t in trees):
            raise ValueError(f"a list of {len(specs)} specs against lists "
                             f"of {[len(t) for t in trees]}")
        return [map_specs(fn, s, *(t[i] for t in trees))
                for i, s in enumerate(specs)]
    return fn(specs, *trees)


def named_shardings(specs: Any, tree: Any, mesh) -> Any:
    """A ``NamedSharding`` for each tensor leaf of ``tree``: its logical
    axes in ``specs`` resolved under the bound rules and fitted to its
    shape. Non-tensor leaves (an int ``pos``, an absent subtree) give
    None."""
    def one(axes, leaf):
        if isinstance(leaf, (dict, list, tuple)):
            raise ValueError(f"spec {axes} stands where the tree has a "
                             f"{type(leaf).__name__}")
        if not isinstance(leaf, torch.Tensor):
            return None
        spec = spec_for(axes, mesh)
        return NamedSharding(mesh, fit_spec_to_shape(spec, leaf.shape, mesh))
    return map_specs(one, specs, tree)


def distribute(leaf: torch.Tensor, sharding: NamedSharding):
    """``leaf`` (the same values on every rank) as a DTensor placed by
    ``sharding``, on the mesh's device type. Each rank cuts its own block
    from its copy (``src_data_rank=None``): nothing is sent, so a group
    whose backend lacks a device scatter (``gloo`` on the card) places as
    NCCL does. A replicated local block shares ``leaf``'s storage, so an
    in-place update of one can show in the other."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    return distribute_tensor(leaf.detach().to(mesh.device_type), mesh,
                             sharding.placements, src_data_rank=None)


def place(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s tensor leaves as DTensors on ``mesh``, each placed by its
    logical axes in ``specs`` (resolved under the bound rules and fitted to
    its shape); other leaves pass unchanged. Placed
    leaves may share storage with ``tree``'s (``distribute``): clone a tree
    that must outlive an in-place step on its placement."""
    shardings = named_shardings(specs, tree, mesh)
    return map_specs(lambda _, leaf, sh: leaf if sh is None
                     else distribute(leaf, sh), specs, tree, shardings)
