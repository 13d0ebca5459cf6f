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

A MoE FFN is expert-sliced tensor parallelism over ``"model"``, with the
collectives above and no all-to-all: ``"experts"`` claims the model axis
(so an expert leaf's ``tp`` dim stays whole), and a rank computes the
experts ``Partition.experts``, split as heads are (taken from the
replicated leaf where ``|model|`` does not divide their count). It
routes the gathered sequence of its rows with the replicated router
(capacity is counted over whole dispatch groups), dispatches only the
slots of its own experts, and the reduce-scatter onto its sequence block
sums every rank's experts (``layers.moe_block``).

The recurrent layers run over the gathered sequence (the scans and the
token shifts run along it), on the rank's compute block, split as heads
are (``head_range``): a mamba layer on its d_inner channels ``[c0, c1)``
(``Partition.inner``; ``in_proj``'s columns of that block in both halves
``[xin | z]``), its ``x_proj`` partial sums summed over "model"
(``sum_partials``: every rank's channels take the whole dt | B | C), its
``out_proj`` reduce-scattered; an rwkv6 layer on its whole heads
(``Partition.rwkv_heads``, ``H = d_model / rwkv_head_dim``; ``ln_x``,
``decay_base`` and ``decay_B``'s columns narrowed alike), its output
norm's float64 sum of squares summed over "model", ``wo`` and the
channel-mix's ``wv`` reduce-scattered, the gate's replicated ``wr`` on the
rank's sequence block. A prefill returns the carries as ``cache_specs``
places them: the rank's block where the model axis splits the channels
or heads evenly, else gathered whole.

Gradients. The collectives are ``torch.autograd.Function`` s over
``torch.distributed._functional_collectives``: an all-gather's backward is
a reduce-scatter (sum) and the reverse; ``all_reduce`` (the loss's sums
over the vocab shards) passes its gradient through unchanged, since every
rank of the group holds the same loss, and ``sum_partials`` (a sum that
feeds per-rank work) sums it over the group. After the backward, a leaf's
gradient is summed over every mesh dim on which the leaf is replicated
(``reduce_grad``): the batch ranks computed different rows, and the
``"model"`` ranks applied a replicated leaf (a norm, a replicated head)
to different positions or heads; a sharded dim was summed by the
gather's backward already.

Decode (``ServePartition``) is the program that SERVE_RULES and
MULTIPOD_SERVE_RULES imply: ``tp``/``heads``/``kv_heads``/``vocab``/
``experts`` over
the whole ``("data", "model")`` mesh as ``fit_spec_to_shape`` leaves them
(a leaf's group is the product of the mesh dims its placements shard,
``mesh_group``), no FSDP, the activations ``(B, 1, D)`` replicated on
every rank, and the KV cache ``(rows, max_len / |model|, K, hd)`` a rank
(``cache_batch`` over ``"data"``, or ``("pod", "data")``, ``seq`` over
``"model"``). Per layer: the column-parallel projections use the rank's
stored columns as they are and their outputs are all-gathered into whole
heads (rope and ``qk_norm`` act on a whole head); the rank writes the new
K/V of its rows where its sequence block holds the position; attention is
split-KV over the block, its ``(acc, m, l)`` combined over ``"model"`` by
log-sum-exp (``combine_attention``); the attention output is gathered
over the cache's rows for the row-parallel ``wo``, whose partial sums,
like ``w2``'s, are all-reduced over the leaf's group; a MoE FFN routes
the batch as one dispatch group, runs the experts of its expert leaves'
local blocks and all-reduces their outputs over the group of the mesh
dims that shard the expert dim (``ServePartition.experts``); the
embedding is a masked lookup all-reduced over its vocab group, and the
head returns the rank's vocab block of the logits. A mamba or rwkv layer
(``ServeLayer``) steps the state's rows that the rank holds, every
channel and head (``cache_specs`` leaves them whole under these rules):
its column-parallel projections are gathered whole and the rank takes
its rows, a row-parallel projection takes the whole batch's inputs
(gathered over the state's rows) on its rows' block, and the leaves that
the state meets channel by channel (``STATE_LEAVES``: mamba's ``conv_w``,
``conv_b``, ``A_log`` and ``D``, rwkv's ``bonus``; 1.2 MB a mamba layer
at jamba's widths) are gathered once, when the ``ServePartition`` is
made. No decode step gathers a weight. Under
MULTIPOD_SERVE_RULES the weights are replicated over ``"pod"`` and every
pod runs the same program.

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
import weakref

import torch

from repro_torch.dist import sharding as dsh
from repro_torch.train import _tree

# the logical axes that this partitioned program splits over one mesh axis
MODEL_AXES = ("seq", "tp", "heads", "kv_heads", "vocab", "experts")
# per-head leaf dims: the compute split follows ``head_range``
_HEAD_AXES = ("heads", "kv_heads")

# the core leaves that each recurrent kind applies to its state channel by
# channel or head by head (the partitioned decode holds them whole)
STATE_LEAVES = {"mamba": ("conv_w", "conv_b", "A_log", "D"),
                "rwkv": ("bonus",)}

# ops a gloo group runs on CUDA tensors: tools/gloo_cuda_probe.py on the
# H100 (torch 2.11.0+cu128) found reduce-scatter and all-reduce (sum, max)
# right on cuda:0, and an all-gather whose processes died of SIGSEGV. The
# all-gather is staged through host memory.
GLOO_DEVICE_OPS = frozenset(("reduce_scatter", "all_reduce"))


@dataclasses.dataclass
class CollectiveStats:
    """Collectives this process issued, their result bytes, the bytes
    staged through host memory (each direction counted), and the shapes of
    their results."""
    calls: int = 0
    bytes: int = 0
    staged_bytes: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)
    shapes: set = dataclasses.field(default_factory=set)

    def reset(self) -> None:
        self.calls = self.bytes = self.staged_bytes = 0
        self.by_op = {}
        self.shapes = set()


# every partitioned collective of this process counts here
STATS = CollectiveStats()


class Group:
    """One mesh dim's process group (or a group over several, ``of``):
    its size, this rank's index in it, and the transport of each op."""

    def __init__(self, mesh, dim: int):
        self._set(mesh.get_group(dim), mesh.size(dim),
                  mesh.get_local_rank(dim))

    @classmethod
    def of(cls, pg, rank: int) -> "Group":
        """The group of process group ``pg``, this rank at ``rank``."""
        g = cls.__new__(cls)
        g._set(pg, pg.size(), rank)
        return g

    def _set(self, pg, size: int, rank: int) -> None:
        import torch.distributed as dist
        self.size, self.rank, self.pg = size, rank, pg
        self.backend = str(dist.get_backend(pg))

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
        st.shapes.add(tuple(y.shape))
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


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.run("all_reduce", x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.run("all_reduce", g), None


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


def sum_partials(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the group of the ranks' partial values (a row-parallel
    product's partial sums) where the sum then feeds work that differs
    between the ranks (their own channels or heads): each rank's gradient
    of the sum is then its part of the whole gradient, so the backward
    sums it over the group too (Megatron's conjugate pair of
    ``all_reduce``). Identity on a group of one."""
    return x if group.size == 1 else _SumPartials.apply(x, group)


def _core_leaf(cfg, path: str) -> tuple:
    """(the layer's kind, the leaf's name) of a core leaf's path
    (``layers/3/core/in_proj``), else (None, None)."""
    bits = path.split("/")
    if len(bits) != 4 or bits[0] != "layers" or bits[2] != "core":
        return None, None
    pat = cfg.block_pattern
    return pat[int(bits[1]) % len(pat)], bits[3]


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
        self.axes = spec_paths(specs)
        m, r = self.model.size, self.model.rank
        h0, h1 = head_range(cfg.n_heads, m, r)
        self.heads = (h0, h1)
        self.kv = kv_heads_for(cfg.n_heads, cfg.n_kv_heads, h0, h1)
        # the experts whose FFN this rank computes, as heads are split
        self.experts = head_range(cfg.n_experts, m, r)
        # per-head axes whose even stored split is the compute split on
        # every rank (a choice that must not differ between ranks)
        self.even = {"heads": cfg.n_heads % m == 0,
                     "kv_heads": cfg.n_heads % m == 0
                     and cfg.n_kv_heads % m == 0}
        # the recurrent layers' compute blocks, split as heads are: mamba's
        # d_inner channels [c0, c1), rwkv's whole heads [h0, h1) of hd
        from repro_torch.models import ssm
        self.di = ssm.mamba_dims(cfg)[0]
        self.inner = head_range(self.di, m, r)
        self.rwkv_n, self.rwkv_hd = ssm.rwkv_dims(cfg)
        self.rwkv_heads = head_range(self.rwkv_n, m, r)

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
        ``"model"`` first where the stored split is another). An expert
        leaf is narrowed to this rank's experts where it is replicated
        (an expert count that the model axis does not divide); its
        ``tp`` dim stays whole, since ``"experts"`` claims the model axis
        before it (``sharding.spec_for``)."""
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
        rec = self._recurrent(path, axes)
        for d, ax in enumerate(axes):
            if d in rec:
                spans, stored = rec[d]
                if md == d and stored:  # the stored block is the split
                    continue
                if md == d:
                    t = all_gather(t, d, self.model)
                parts = [t.narrow(d, lo, hi - lo) for lo, hi in spans]
                t = parts[0] if len(parts) == 1 else torch.cat(parts, d)
            elif ax == "experts":
                if md != d:  # stored evenly, the block is the split
                    e0, e1 = self.experts
                    t = t.narrow(d, e0, e1 - e0)
            elif ax == "tp" and md != d and "experts" not in axes:
                lo, hi = head_range(t.shape[d], self.model.size,
                                    self.model.rank)
                t = t.narrow(d, lo, hi - lo)
            elif ax in _HEAD_AXES and not (md == d and self.even[ax]):
                if md == d:
                    t = all_gather(t, d, self.model)
                t = self._heads(t, d, ax)
        return t

    def _recurrent(self, path: str, axes: tuple) -> dict:
        """``{dim: (spans, stored)}`` for a mamba or rwkv core leaf: the
        index spans of ``dim`` that this rank computes with, and whether
        an even stored split of ``dim`` over the model axis is that
        compute split. Mamba's ``"tp"`` dims take the rank's d_inner
        block, ``in_proj``'s of both its halves ``[xin | z]``; rwkv's take
        the rank's whole heads: the columns (or ``wo``'s rows) of ``hd``
        each, ``bonus``'s rows, and the per-channel ``ln_x``,
        ``decay_base`` and ``decay_B``'s columns, which are replicated.
        Empty for any other leaf."""
        kind, name = _core_leaf(self.cfg, path)
        m = self.model.size
        if kind == "mamba":
            c0, c1 = self.inner
            if name == "in_proj":
                di = self.di
                return {1: ([(c0, c1), (di + c0, di + c1)], m == 1)}
            return {d: ([(c0, c1)], self.di % m == 0)
                    for d, ax in enumerate(axes) if ax == "tp"}
        if kind != "rwkv":
            return {}
        (h0, h1), hd = self.rwkv_heads, self.rwkv_hd
        even = self.rwkv_n % m == 0
        if name == "bonus":
            return {0: ([(h0, h1)], even)}
        cols = [(h0 * hd, h1 * hd)]
        if name in ("ln_x", "decay_base"):
            return {0: (cols, False)}
        if name == "decay_B":
            return {1: (cols, False)}
        return {d: (cols, even) for d, ax in enumerate(axes) if ax == "tp"}

    def gather_blocks(self, t: torch.Tensor, dim: int, n: int
                      ) -> torch.Tensor:
        """The ranks' ``head_range`` blocks of a dim of ``n`` (heads or
        channels), this rank's ``t``, gathered whole over the model axis:
        each padded to ``ceil(n / |model|)``, the padding cut after."""
        per = -(-n // self.model.size)
        pad = [0, 0] * (t.ndim - dim - 1) + [0, per - t.shape[dim]]
        y = all_gather(torch.nn.functional.pad(t, pad), dim, self.model)
        return y.narrow(dim, 0, n)

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

    def sum_model(self, x: torch.Tensor) -> torch.Tensor:
        """``sum_partials`` over the model axis."""
        return sum_partials(x, self.model)

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


def spec_paths(specs, prefix: str = "", out: dict | None = None) -> dict:
    """``{path: logical axes}`` of a spec tree (``param_specs``), by the
    ``_tree`` paths of the tree it describes (its tuples are leaves)."""
    out = {} if out is None else out
    if isinstance(specs, (dict, list)):
        items = specs.items() if isinstance(specs, dict) else enumerate(specs)
        for k, v in items:
            spec_paths(v, f"{prefix}/{k}" if prefix else str(k), out)
    else:
        out[prefix] = specs
    return out


class _Solo:
    """The model axis where no logical axis resolves to one, or a leaf
    replicated on every mesh dim: one rank."""
    size, rank = 1, 0


def mesh_group(mesh, dims) -> "Group | _Solo":
    """The group over the product of mesh dims ``dims`` that holds this
    rank: the ranks sharing its coordinates on every other dim, indexed
    major first in mesh order (the block index of a dim that DTensor
    shards on those mesh dims). One dim is the mesh's own group; several
    make one ``new_group`` per set of ranks, called on every rank in one
    order, so every rank holds the same groups; they are kept on the mesh
    object, made once."""
    dims = tuple(sorted(dims))
    if not dims:
        return _Solo()
    if len(dims) == 1:
        return Group(mesh, dims[0])
    made = mesh.__dict__.setdefault("_flattened_groups", {})
    if dims in made:
        return made[dims]
    import torch.distributed as dist
    from torch.utils._python_dispatch import _disable_current_modes
    rest = [d for d in range(mesh.ndim) if d not in dims]
    with _disable_current_modes():  # the mesh's rank tensor is a real one
        sets = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(mesh.size(d) for d in dims)).tolist()
    me, mine = dist.get_rank(), None
    for ranks in sets:
        pg = dist.new_group(ranks)
        if me in ranks:
            mine = Group.of(pg, ranks.index(me))
    made[dims] = mine
    return mine


def combine_attention(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                      group) -> torch.Tensor:
    """Split-KV attention's partials combined over ``group`` by
    log-sum-exp: ``acc`` (..., D) the unnormalised sums of ``exp(s - m) v``
    over the rank's block of keys, ``m`` (...) its max score (``-inf``
    where the block holds no valid key) and ``l`` (...) its sum of
    ``exp(s - m)``, float32 (``layers.split_kv_attention``). The max over
    the group, then one sum of the rescaled ``acc`` and ``l``; a rank with
    no valid key adds exact zeros. Needs no gradient."""
    if group.size > 1:
        top = group.run("all_reduce", m, reduce="max")
        corr = torch.where(torch.isfinite(m), torch.exp(m - top), 0.0)
        both = group.run("all_reduce", torch.cat(
            [acc * corr[..., None], (l * corr)[..., None]], dim=-1))
        acc, l = both[..., :-1], both[..., -1]
    return acc / l[..., None]


@dataclasses.dataclass(frozen=True)
class Split:
    """How a leaf (or a cache dim) is split: the tensor dim its placements
    shard (None: replicated), the group over the mesh dims that shard it,
    and the local length of that dim."""
    dim: int | None
    group: object
    local: int

    @property
    def start(self) -> int:
        """The first index of this rank's block along ``dim``."""
        return self.group.rank * self.local


def _split(mesh, placements, shape, what: str) -> Split:
    """``placements`` of a tensor of local ``shape`` as a ``Split``."""
    from torch.distributed.tensor import Replicate, Shard
    dims, tdim = [], None
    for d, p in enumerate(placements):
        if isinstance(p, Shard):
            if tdim is not None and p.dim != tdim:
                raise ValueError(f"{what}: placements {placements} shard "
                                 "two tensor dims")
            tdim = p.dim
            dims.append(d)
        elif not isinstance(p, Replicate):
            raise ValueError(f"{what}: placement {p} is neither Shard nor "
                             "Replicate")
    return Split(tdim, mesh_group(mesh, dims),
                 0 if tdim is None else shape[tdim])


class ServePartition:
    """One rank's view of the partitioned decode (module docstring) on
    ``mesh`` under SERVE_RULES or MULTIPOD_SERVE_RULES: each parameter
    leaf's ``Split`` (by ``_tree`` path) from its placements, the
    collectives over each leaf's group, and the cache's layout from the
    state's placements (``cache_layout``), and ``local``, the leaves'
    local blocks. Other rule sets raise: no reference path decodes under
    them. Made once for each placed tree: ``serve_partition``.

    A leaf may split only the dim of its first logical axis among
    ``MODEL_AXES`` (``specs``, ``param_specs``): a column-parallel output
    dim, a row-parallel input dim, the vocab of the embedding or head, the
    experts of an expert leaf."""

    def __init__(self, mesh, cfg, params, specs):
        rules = dsh.current_rules()
        if rules not in (dsh.SERVE_RULES, dsh.MULTIPOD_SERVE_RULES):
            raise ValueError(
                "the partitioned decode runs under SERVE_RULES or "
                "MULTIPOD_SERVE_RULES (weights stationary over the mesh, "
                "the batch replicated, the cache sharded by sequence); the "
                "bound rules are another set, under which no reference "
                "path decodes")
        self.mesh, self.cfg = mesh, cfg
        self.leaf = {}
        axes = spec_paths(specs)
        paths, leaves = _tree.flatten(params)
        for path, t in zip(paths, leaves):
            sp = _split(mesh, tuple(t.placements), t.to_local().shape, path)
            want = next((d for d, a in enumerate(axes[path])
                         if a in MODEL_AXES), None)
            if sp.dim is not None and sp.dim != want:
                raise ValueError(
                    f"{path}: placements {tuple(t.placements)} shard dim "
                    f"{sp.dim}, which the partitioned decode does not split")
            self.leaf[path] = sp
        self.local = local(params)
        # the leaves that a mamba or rwkv layer applies to its state
        # channel by channel (``STATE_LEAVES``), whole: the state's rows
        # step every channel on the rank that holds them (``cache_specs``
        # leaves d_inner and the heads whole under these rules), so these
        # are gathered once, here, and no decode step moves a weight
        self.state_leaf = {}
        for path, t in zip(paths, leaves):
            kind, name = _core_leaf(cfg, path)
            if name in STATE_LEAVES.get(kind, ()):
                sp = self.leaf[path]
                blk = t.to_local().detach()
                self.state_leaf[path] = blk if sp.dim is None else \
                    all_gather(blk, sp.dim, sp.group)

    # ------------------------------------------------------- activations
    def gather_cols(self, t: torch.Tensor, path: str) -> torch.Tensor:
        """A column-parallel output (..., local columns of leaf ``path``)
        all-gathered into every column."""
        sp = self.leaf[path]
        return all_gather(t, t.ndim - 1, sp.group)

    def block(self, t: torch.Tensor, path: str) -> torch.Tensor:
        """A whole last dim narrowed to the block that the rows of leaf
        ``path`` (row-parallel) multiply."""
        sp = self.leaf[path]
        return t if sp.dim is None else t.narrow(-1, sp.start, sp.local)

    def rows_for(self, t: torch.Tensor, src: str, dst: str) -> torch.Tensor:
        """``t``, leaf ``src``'s column block, as the block that leaf
        ``dst``'s rows multiply: as it is where both split alike, else
        gathered and narrowed."""
        a, b = self.leaf[src], self.leaf[dst]
        if a.dim is not None and b.dim is not None and a.local == b.local \
                and a.group.size == b.group.size \
                and a.group.rank == b.group.rank:
            return t
        return self.block(self.gather_cols(t, src), dst)

    def reduce(self, y: torch.Tensor, path: str) -> torch.Tensor:
        """A row-parallel product's partial sums (or the embedding's masked
        rows, or the outputs of the rank's experts) all-reduced over leaf
        ``path``'s group."""
        return all_reduce(y, self.leaf[path].group)

    def layer(self, prefix: str, rows: Split) -> "ServeLayer":
        """The view of the leaves under ``prefix`` (``layers/3/``) that a
        recurrent layer's decode takes, its state's rows split by
        ``rows``."""
        return ServeLayer(self, prefix, rows)

    def experts(self, path: str) -> tuple[int, int]:
        """The experts ``[e0, e1)`` that expert leaf ``path``'s local block
        holds (every expert where the leaf is replicated)."""
        sp = self.leaf[path]
        if sp.dim is None:
            return 0, self.cfg.n_experts
        return sp.start, sp.start + sp.local

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """Whole greedy ids (B, 1) from the rank's vocab block of the
        logits (B, 1, V / |group|): the largest logit over the head's
        group, the lowest id among equal ones (``torch.argmax`` keeps the
        first)."""
        sp = self.leaf["embed/head"]
        idx = logits.argmax(-1)
        ids = idx + sp.start
        if sp.dim is None or sp.group.size == 1:
            return ids
        val = logits.gather(-1, idx[..., None])[..., 0].double()
        both = all_gather(torch.stack([val, ids.double()])[None], 0,
                          sp.group)
        vals, cand = both[:, 0], both[:, 1]
        best = vals.amax(dim=0)
        return torch.where(vals == best, cand, torch.inf).amin(
            dim=0).long()

    # ------------------------------------------------------------- cache
    def cache_layout(self, caches: list) -> tuple[Split, Split]:
        """The rows' and positions' ``Split`` of the decode state (placed
        by ``cache_specs``): dim 0 of every leaf holds its rows, split
        alike in every layer; dim 1 of the attention caches' ``(rows,
        positions, K, hd)`` leaves their positions (whole where no layer
        attends). A recurrent carry splits its rows alone."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        leaves = [t for c in caches for t in c.values()]
        if not leaves or not all(isinstance(t, DTensor) and t.device_mesh
                                 == self.mesh for t in leaves):
            raise ValueError(
                "a partitioned decode takes its state placed on the mesh "
                "by cache_specs (DTensor caches)")

        def split_dims(t, dim):
            return tuple(d for d, p in enumerate(t.placements)
                         if isinstance(p, Shard) and p.dim == dim)
        for c in caches:
            top = 1 if "k" in c else 0
            for t in c.values():
                if any(not isinstance(p, (Shard, Replicate)) or isinstance(
                        p, Shard) and p.dim > top for p in t.placements):
                    raise ValueError(
                        f"cache placements {tuple(t.placements)}: the "
                        "partitioned decode splits the attention caches' "
                        "rows and positions and the carries' rows only")
        rdims = {split_dims(t, 0) for t in leaves}
        kv = [t for c in caches if "k" in c for t in c.values()]
        if len(rdims) > 1 or len({tuple(t.placements) for t in kv}) > 1:
            raise ValueError("the decode state's leaves are placed unalike")
        (rdims,) = rdims
        rows = Split(0 if rdims else None, mesh_group(self.mesh, rdims),
                     leaves[0].to_local().shape[0])
        if not kv:
            return rows, Split(None, _Solo(), 0)
        sdims = split_dims(kv[0], 1)
        return rows, Split(1 if sdims else None, mesh_group(self.mesh, sdims),
                           kv[0].to_local().shape[1])


class ServeLayer:
    """A mamba or rwkv layer's view of the partitioned decode: the
    leaves under ``prefix`` (``layers/3/core/``) by name, the whole
    activations ``(B, 1, ...)`` that every rank holds, and the rank's
    rows of the state (``rows``, ``ServePartition.cache_layout``). A
    column-parallel output is gathered whole (``cols``); a row-parallel
    product takes the whole batch's inputs (``every``) narrowed to its
    rows' block and sums its partial products (``reduce``); the state's
    channel-wise leaves come whole (``whole``)."""

    def __init__(self, part: ServePartition, prefix: str, rows: Split):
        self.part, self.prefix, self.rows = part, prefix, rows

    def at(self, sub: str) -> "ServeLayer":
        return ServeLayer(self.part, f"{self.prefix}{sub}/", self.rows)

    def cols(self, t: torch.Tensor, name: str) -> torch.Tensor:
        return self.part.gather_cols(t, self.prefix + name)

    def block(self, t: torch.Tensor, name: str) -> torch.Tensor:
        return self.part.block(t, self.prefix + name)

    def rows_for(self, t: torch.Tensor, src: str, dst: str) -> torch.Tensor:
        return self.part.rows_for(t, self.prefix + src, self.prefix + dst)

    def reduce(self, y: torch.Tensor, name: str) -> torch.Tensor:
        return self.part.reduce(y, self.prefix + name)

    def whole(self, name: str) -> torch.Tensor:
        return self.part.state_leaf[self.prefix + name]

    def mine(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a whole-batch tensor."""
        return t.narrow(0, self.rows.start, self.rows.local)

    def every(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's rows gathered into the whole batch."""
        return all_gather(t, 0, self.rows.group)


def serve_partition(mesh, cfg, params, specs) -> ServePartition:
    """``ServePartition(mesh, cfg, params, specs)`` under the bound rules,
    made once for each placed tree: kept on the mesh object, keyed by the
    config, the rules and the leaves' identities, and dropped when any of
    those leaves is freed (so an identity is never matched twice)."""
    leaves = _tree.leaves(params)
    rules = dsh.current_rules()
    made = mesh.__dict__.setdefault("_serve_partitions", {})
    key = (cfg, id(rules), tuple(map(id, leaves)))
    if key not in made:
        made[key] = ServePartition(mesh, cfg, params, specs)
        for t in leaves:
            weakref.finalize(t, made.pop, key, None)
    return made[key]


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
