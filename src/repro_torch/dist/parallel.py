"""Partitioned compute: what GSPMD derives from the reference's
``in_shardings``, written out for one rank.

The reference runs its train step and prefill under ``jax.jit(...,
in_shardings=params_sh)`` on the production meshes, so GSPMD partitions
the compute: FSDP over the axis that ``"fsdp"`` resolves to, tensor
parallelism over the axis of ``"tp"``/``"heads"``/``"kv_heads"``/
``"vocab"``, sequence parallelism over the axis of ``"seq"`` (all
``"model"`` under ``DEFAULT_RULES`` and ``MULTIPOD_RULES``). Torch is
multi-controller and has no partitioner, so this module holds the pieces
of that program, and ``models.layers``/``models.transformer`` call them
(Megatron's pattern):

- activations between blocks are ``(batch, seq / |model|, D)``, the
  reference's ``shard(x, "batch", "seq", None)``;
- before a column-parallel projection (``wq``/``wk``/``wv``/``w1``/``w3``)
  the sequence is all-gathered over ``"model"``; a row-parallel projection
  (``wo``/``w2``) ends in a reduce-scatter onto the sequence shard;
- each layer's FSDP shards are all-gathered inside the function that
  ``checkpoint`` wraps, so only one layer's gathered weights live at a time
  and the backward gathers them again (the reference's remat);
- the embedding and the LM head are vocab-parallel.

A rank computes whole heads (``head_range``): ``H / |model|`` each where
``|model|`` divides ``H``, otherwise ``ceil(H / |model|)`` in order, the
last ranks fewer or none (qwen2.5-32b: 40 heads on 16 ranks). Where the
stored split of a leaf is not the compute split (uneven heads, or K/V
heads that a rank needs but does not hold, ``K < |model|``), the leaf is
all-gathered over ``"model"`` and sliced; a leaf that ``fit_spec_to_shape``
left replicated is sliced as it is. K/V heads that do not group evenly
under a rank's query heads are repeated, one per query head.

Gradients. The collectives are ``torch.autograd.Function`` s over
``torch.distributed._functional_collectives``: an all-gather's backward is
a reduce-scatter (sum) and the reverse; ``all_reduce`` (the loss's sums
over the vocab shards) passes its gradient through unchanged, since every
rank of the group holds the same loss. After the backward, a leaf's
gradient is summed over every mesh dim on which the leaf is replicated
(``reduce_grad``): the batch ranks computed different rows, and the
``"model"`` ranks applied a replicated leaf (a norm, a replicated head)
to different positions or heads; a sharded dim was summed by the
gather's backward already.

Transport. On NCCL every collective takes device tensors. A ``gloo``
group takes a CUDA tensor only for the ops in ``GLOO_DEVICE_OPS`` (the
table that ``tools/gloo_cuda_probe.py`` printed on the H100); any other
op's payload is copied to the host and back, decided from the group's
backend and the tensor's device, never by catching an error, and counted
in ``STATS.staged_bytes`` (``STATS`` counts every collective of the
process).

Nothing here opens a process group or touches a device at import.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.dist import sharding as dsh
from repro_torch.train import _tree

# the logical axes that this partitioned program splits over one mesh axis
MODEL_AXES = ("seq", "tp", "heads", "kv_heads", "vocab")
# per-head leaf dims: the compute split follows ``head_range``
_HEAD_AXES = ("heads", "kv_heads")

# ops a gloo group runs on CUDA tensors: tools/gloo_cuda_probe.py on the
# H100 (torch 2.11.0+cu128) found reduce-scatter and all-reduce (sum, max)
# right on cuda:0, and an all-gather whose processes died of SIGSEGV. The
# all-gather is staged through host memory.
GLOO_DEVICE_OPS = frozenset(("reduce_scatter", "all_reduce"))


@dataclasses.dataclass
class CollectiveStats:
    """Collectives this process issued, their result bytes, and the bytes
    staged through host memory (each direction counted)."""
    calls: int = 0
    bytes: int = 0
    staged_bytes: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls = self.bytes = self.staged_bytes = 0
        self.by_op = {}


# every partitioned collective of this process counts here
STATS = CollectiveStats()


class Group:
    """One mesh dim's process group: its size, this rank's index in it,
    and the transport of each op."""

    def __init__(self, mesh, dim: int):
        import torch.distributed as dist
        self.size = mesh.size(dim)
        self.rank = mesh.get_local_rank(dim)
        self.pg = mesh.get_group(dim)
        self.backend = str(dist.get_backend(self.pg))

    def stages(self, op: str, t: torch.Tensor) -> bool:
        return (self.backend == "gloo" and t.device.type != "cpu"
                and op not in GLOO_DEVICE_OPS)

    def run(self, op: str, t: torch.Tensor, *, dim: int = 0,
            reduce: str = "sum") -> torch.Tensor:
        """One collective, no autograd: ``all_gather`` or
        ``reduce_scatter`` (a sum) along ``dim``, or ``all_reduce`` by
        ``reduce``; the ``_c10d_functional`` ops, waited on."""
        c10d = torch.ops._c10d_functional
        staged = self.stages(op, t)
        x = t.detach()
        if staged:
            x = x.cpu()
        n, name = self.size, self.pg.group_name
        if op == "all_gather":
            # blocks gathered along dim 0, rank-major, then moved back
            # into a contiguous tensor (one copy, where every matmul on a
            # strided view would make its own)
            y = c10d.wait_tensor(c10d.all_gather_into_tensor(
                x.movedim(dim, 0).contiguous(), n, name))
            if dim:
                y = y.movedim(0, dim).contiguous()
        elif op == "reduce_scatter":
            if dim:  # the n blocks of ``dim`` stacked along dim 0
                x = torch.cat(torch.chunk(x, n, dim=dim))
            y = c10d.wait_tensor(c10d.reduce_scatter_tensor(
                x.contiguous(), "sum", n, name))
        else:
            y = c10d.wait_tensor(c10d.all_reduce(x.contiguous(), reduce,
                                                 name))
        nbytes = y.numel() * y.element_size()
        st = STATS
        st.calls += 1
        st.bytes += nbytes
        st.by_op[op] = st.by_op.get(op, 0) + 1
        if staged:
            st.staged_bytes += x.numel() * x.element_size() + nbytes
            y = y.to(t.device)
        return y


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return group.run("all_gather", x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.run("reduce_scatter", g, dim=ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return group.run("reduce_scatter", x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.run("all_gather", g, dim=ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.run("all_reduce", x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """Concatenate the group's blocks along ``dim``; backward: a
    reduce-scatter (sum). Identity on a group of one."""
    return x if group.size == 1 else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """Sum over the group and keep this rank's block of ``dim``; backward:
    an all-gather. Identity on a group of one."""
    return x if group.size == 1 else _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group: Group, op: str = "sum"
               ) -> torch.Tensor:
    """Reduce over the group; a sum passes its gradient through unchanged
    (every rank holds the same loss), a max takes none. Identity on a
    group of one."""
    if group.size == 1:
        return x
    if op == "sum":
        return _AllReduce.apply(x, group)
    return group.run("all_reduce", x, reduce=op)


def _one_axis(mesh, logical: str) -> str | None:
    """The one mesh axis that ``logical`` resolves to under the bound rules
    (None: replicated)."""
    spec = dsh.spec_for((logical,), mesh)
    if not spec or spec[0] is None:
        return None
    if not isinstance(spec[0], str):
        raise ValueError(
            f"{logical!r} resolves to the mesh axes {spec[0]}: the "
            "partitioned train and prefill programs split it over one "
            "axis (DEFAULT_RULES, MULTIPOD_RULES)")
    return spec[0]


def head_range(n_heads: int, size: int, rank: int) -> tuple[int, int]:
    """The query heads ``[h0, h1)`` that rank ``rank`` of ``size`` computes:
    ``ceil(n_heads / size)`` in order, the last ranks fewer or none."""
    per = -(-n_heads // size)
    h0 = min(n_heads, rank * per)
    return h0, min(n_heads, h0 + per)


def kv_heads_for(n_heads: int, n_kv: int, h0: int, h1: int
                 ) -> tuple[int, int, list | None]:
    """The K/V heads that query heads ``[h0, h1)`` read: ``(k0, k1, None)``
    where each of ``[k0, k1)`` serves the same number of them (grouped
    attention as it stands), else ``(k0, k1, index)`` with one K/V head
    index per query head."""
    if h1 <= h0:
        return 0, 0, None
    g = n_heads // n_kv
    ids = [h // g for h in range(h0, h1)]
    k0, k1 = ids[0], ids[-1] + 1
    if len({ids.count(k) for k in range(k0, k1)}) == 1:
        return k0, k1, None
    return k0, k1, ids


class Partition:
    """One rank's view of the partitioned program on ``mesh`` under the
    bound rules: its groups, and each parameter leaf's placements and
    logical axes (by ``_tree`` path).

    ``specs`` is ``transformer.param_specs(cfg)``; ``params`` the placed
    parameters (DTensors) whose placements it records.
    """

    def __init__(self, mesh, cfg, specs, params):
        self.mesh = mesh
        self.cfg = cfg
        names = list(mesh.mesh_dim_names)
        model = {a: _one_axis(mesh, a) for a in MODEL_AXES}
        axes = {v for v in model.values() if v is not None}
        if len(axes) > 1:
            raise ValueError(
                f"{model}: the partitioned program splits "
                f"{'/'.join(MODEL_AXES)} over one mesh axis")
        fsdp = _one_axis(mesh, "fsdp")
        bspec = dsh.spec_for(("batch",), mesh)
        batch = () if not bspec or bspec[0] is None else (
            (bspec[0],) if isinstance(bspec[0], str) else tuple(bspec[0]))
        self.model_dim = names.index(axes.pop()) if axes else None
        self.fsdp_dim = None if fsdp is None else names.index(fsdp)
        if self.fsdp_dim is not None and self.fsdp_dim == self.model_dim:
            raise ValueError("fsdp and the model axes resolve to one mesh "
                             f"axis {fsdp!r}")
        self.batch_dims = [names.index(a) for a in batch]
        self.groups = [Group(mesh, d) for d in range(mesh.ndim)]
        self.model = (self.groups[self.model_dim]
                      if self.model_dim is not None else _Solo())
        self.n_batch = math.prod(mesh.size(d) for d in self.batch_dims)
        coord = mesh.get_coordinate()
        idx = 0
        for d in self.batch_dims:  # major first, as the batch dim is sharded
            idx = idx * mesh.size(d) + coord[d]
        self.batch_index = idx
        paths, leaves = _tree.flatten(params)
        self.placements = {p: tuple(t.placements) for p, t in
                           zip(paths, leaves)}
        self.axes = {}
        self._index_specs(specs, "")
        h0, h1 = head_range(cfg.n_heads, self.model.size, self.model.rank)
        self.heads = (h0, h1)
        self.kv = kv_heads_for(cfg.n_heads, cfg.n_kv_heads, h0, h1)
        m = self.model.size
        # per-head axes whose even stored split is the compute split on
        # every rank (a choice that must not differ between ranks)
        self.even = {"heads": cfg.n_heads % m == 0,
                     "kv_heads": cfg.n_heads % m == 0
                     and cfg.n_kv_heads % m == 0}

    def _index_specs(self, specs, prefix: str) -> None:
        if isinstance(specs, dict):
            for k, v in specs.items():
                self._index_specs(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(specs, list):
            for i, v in enumerate(specs):
                self._index_specs(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            self.axes[prefix] = specs

    # ----------------------------------------------------------- leaves
    def _shard_dim(self, pl: tuple, mesh_dim: int | None) -> int | None:
        from torch.distributed.tensor import Shard
        if mesh_dim is None:
            return None
        p = pl[mesh_dim]
        return p.dim if isinstance(p, Shard) else None

    def weight(self, local: torch.Tensor, path: str) -> torch.Tensor:
        """Leaf ``path``'s tensor as this rank computes with it, from its
        local block: gathered over the FSDP axis, and on a per-head or
        ``tp`` dim narrowed to this rank's heads or columns (gathered over
        ``"model"`` first where the stored split is another)."""
        from torch.distributed.tensor import Replicate
        pl, axes = self.placements[path], self.axes[path]
        for d, p in enumerate(pl):
            if d not in (self.fsdp_dim, self.model_dim) and \
                    not isinstance(p, Replicate):
                raise ValueError(f"{path}: placements {pl} shard mesh dim "
                                 f"{d}, which neither fsdp nor the model "
                                 "axes resolve to")
        t = local
        fd = self._shard_dim(pl, self.fsdp_dim)
        if fd is not None:
            t = all_gather(t, fd, self.groups[self.fsdp_dim])
        md = self._shard_dim(pl, self.model_dim)
        for d, ax in enumerate(axes):
            if ax == "tp" and md != d:  # stored evenly, it is the split
                lo, hi = head_range(t.shape[d], self.model.size,
                                    self.model.rank)
                t = t.narrow(d, lo, hi - lo)
            elif ax in _HEAD_AXES and not (md == d and self.even[ax]):
                if md == d:
                    t = all_gather(t, d, self.model)
                t = self._heads(t, d, ax)
        return t

    def whole(self, local: torch.Tensor, path: str) -> torch.Tensor:
        """Leaf ``path`` whole, from its local block: gathered over the
        FSDP and the model axes where they shard it."""
        pl, t = self.placements[path], local
        for d in (self.fsdp_dim, self.model_dim):
            sd = self._shard_dim(pl, d)
            if sd is not None:
                t = all_gather(t, sd, self.groups[d])
        return t

    def _heads(self, t: torch.Tensor, d: int, ax: str) -> torch.Tensor:
        hd = self.cfg.resolved_head_dim
        if ax == "heads":
            h0, h1 = self.heads
            return t.narrow(d, h0 * hd, (h1 - h0) * hd)
        k0, k1, ids = self.kv
        if ids is None:
            return t.narrow(d, k0 * hd, (k1 - k0) * hd)
        cols = torch.tensor([k * hd + j for k in ids for j in range(hd)],
                            device=t.device)
        return t.index_select(d, cols)

    def weights(self, tree, prefix: str):
        """``weight`` over a sub-tree of the parameters whose paths start
        with ``prefix`` (``layers/3``, ``embed``)."""
        paths, leaves = _tree.flatten(tree)
        return _tree.unflatten(tree, [
            self.weight(t, f"{prefix}/{p}" if p else prefix)
            for p, t in zip(paths, leaves)])

    def vocab_start(self, local_vocab: int) -> int:
        """The first vocab row of this rank's block of ``local_vocab``
        rows (0 where the vocab is whole)."""
        if local_vocab == self.cfg.vocab_size:
            return 0
        return self.model.rank * local_vocab

    # ------------------------------------------------------- activations
    def seq_block(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of a whole-sequence tensor along ``dim``."""
        n, m = t.shape[dim], self.model.size
        if n % m:
            raise ValueError(
                f"a sequence of {n} positions does not split over "
                f"{m} ranks of the model axis")
        return t.narrow(dim, self.model.rank * (n // m), n // m)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, 1, self.model)

    def scatter_seq(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % self.model.size:
            raise ValueError(
                f"a sequence of {x.shape[1]} positions does not split over "
                f"{self.model.size} ranks of the model axis")
        return reduce_scatter(x, 1, self.model)

    # ---------------------------------------------------------- gradients
    def reduce_grad(self, g: torch.Tensor, path: str) -> torch.Tensor:
        """Sum ``g`` over every mesh dim on which leaf ``path`` is
        replicated (module docstring)."""
        from torch.distributed.tensor import Replicate
        for d, p in enumerate(self.placements[path]):
            if isinstance(p, Replicate):
                g = all_reduce(g, self.groups[d])
        return g


class _Solo:
    """The model axis where no logical axis resolves to one: one rank."""
    size, rank = 1, 0


def placed(params) -> bool:
    """Whether ``params``' leaves are DTensors on the active mesh: what
    turns the partitioned programs on (an active mesh alone does not)."""
    from torch.distributed.tensor import DTensor
    mesh = dsh.active_mesh()
    if mesh is None:
        return False
    leaves = _tree.leaves(params)
    return bool(leaves) and all(isinstance(t, DTensor) and t.device_mesh
                                == mesh for t in leaves)


def local(params):
    """``params``' local blocks, detached (they alias the DTensors')."""
    return _tree.tree_map(lambda t: t.to_local().detach(), params)
