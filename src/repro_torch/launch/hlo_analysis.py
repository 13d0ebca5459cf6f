"""Per-rank roofline costs of an eager step, counted as its ops dispatch.

Port of ``repro.launch.hlo_analysis``. The reference parses the compiled
SPMD HLO, recovers each while loop's trip count and scales the loop body
by it. The port has no HLO: ``analyze(step, *args)`` runs ``step`` under
one ``TorchDispatchMode`` and counts the aten ops as they dispatch. An
eager run executes every loop trip, so the reference's parser
(``parse_computations``, ``_trip_count``, ``_comp_costs``) has no
counterpart here. Everything is counted at the rank's local shapes: an op
on a ``DTensor`` is left to DTensor, and the ops it issues on the local
tensors are counted (``FlopCounterMode`` on a DTensor product counts the
global product). Per op:

  - flops: ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
    baddbmm, convolution, SDPA and their backwards); an op that the
    formulas lack is decomposed first, as ``FlopCounterMode`` does, so the
    count equals ``FlopCounterMode``'s on the same plain program. The
    reference counts ``dot`` and ``convolution``.
  - hbm bytes: the input plus output bytes of every op that is not a view.
    An upper estimate: eager PyTorch writes every op's result to memory
    where the reference counts fusion boundaries. ``copy_`` and
    ``index_put_`` count the window they write (the reference's
    dynamic-update-slice rule), ``fill_``/``zero_`` their output.
  - collectives: the ``_c10d_functional`` ops as ``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all`` and
    ``collective-permute`` (a broadcast), with the reference's ring factors
    (``_collective_link_bytes``) over the op's group size, resolved from
    the op's group name (a group that ``dist.parallel.mesh_group`` makes
    over several mesh dims as a mesh dim's); the payload is the result's
    bytes. The autograd variants
    (``all_gather_tensor_autograd`` and the like, and
    ``dist.parallel``'s collectives) dispatch these same ops in the
    forward and in the backward, so each is counted once in each (torch
    2.11 and 2.13 dispatch nothing else: ``tools/gloo_cuda_probe.py``); a
    ``_c10d_functional_autograd`` op, where a torch dispatches one, counts
    as its kind, and the ops it runs beneath it are not seen (a dispatch
    mode is off inside its own handler). ``_wrap_tensor_autograd`` moves
    no bytes.
  - peak live bytes: the storages alive on the device, the arguments'
    included, from entry to exit (rounded up to 512 bytes on CUDA, as the
    caching allocator rounds).

Two loops are not run trip by trip. ``models.ssm``'s per-position scans
run millions of ops at 32k positions (and its projections' row tiles,
which run through the same loop, thousands), so while ``analyze`` runs
it sets ``ssm.SCAN_LOOP``: a longer scan runs ``SCAN_TRIPS`` trips (the
first two, one in the middle, the last two; only their positions are
viewed, ``ssm.positions``, whose backward stacks every position's
gradient as a run of every trip does) and counts the middle one once more
for every trip it skips, as the reference scales a while body. The
middle trip's backward nodes count as many times (matched by autograd
sequence number), and the live bytes it added stay counted as many
times, for as long as its storages live. The stacked output holds the
five rows run and the middle one, detached, for every skipped trip (no
caller reads values under fake tensors); it is built uncounted and
counted as the one stack of every row. Flops and bytes then equal a run
of every trip (``tests/test_torch_dryrun.py`` holds them); the peak is
an estimate.
The train step's micro-batch loop (``train_loop.MICRO_LOOP``) runs
``MICRO_STEPS`` micro-batches and counts the last once more for each one
it skips: micro-batches are alike in shape and free what they hold
before the next, so flops, bytes and the peak equal a run of every one.

``roofline_terms`` turns the counts into the reference's three terms with
the H100 SXM's constants in place of TPU v5e's.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")
# _c10d_functional op name prefix -> reference collective kind
_C10D_KINDS = (("all_reduce", "all-reduce"),
               ("all_gather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"),
               ("all_to_all", "all-to-all"),
               ("broadcast", "collective-permute"))
SCAN_TRIPS = 5  # trips a sampled scan runs (models.ssm.SCAN_LOOP)
MICRO_STEPS = 2  # micro-batches a train step runs (train_loop.MICRO_LOOP)
_CUDA_ROUND = 512  # the caching allocator's smallest block


def _collective_link_bytes(kind: str, payload: float, s: int) -> float:
    """Bytes one device sends over its links for a collective whose result
    is ``payload`` bytes over a group of ``s`` (the reference's ring
    factors)."""
    if kind == "all-reduce":
        return 2 * payload * (s - 1) / s
    if kind == "all-gather":
        return payload * (s - 1) / s
    if kind == "reduce-scatter":
        return payload * (s - 1)
    if kind == "all-to-all":
        return payload * (s - 1) / s
    return payload


@dataclasses.dataclass
class HloCosts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)

    def scaled(self, k: float) -> "HloCosts":
        return HloCosts(
            self.flops * k, self.hbm_bytes * k,
            {a: b * k for a, b in self.coll_bytes.items()},
            {a: b * k for a, b in self.coll_counts.items()})

    def add(self, other: "HloCosts") -> None:
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def _since(now: HloCosts, before: HloCosts) -> HloCosts:
    """The costs counted between the snapshot ``before`` and ``now``."""
    return HloCosts(
        now.flops - before.flops, now.hbm_bytes - before.hbm_bytes,
        {k: v - before.coll_bytes.get(k, 0.0)
         for k, v in now.coll_bytes.items()},
        {k: v - before.coll_counts.get(k, 0)
         for k, v in now.coll_counts.items()})


def _snapshot(c: HloCosts) -> HloCosts:
    return HloCosts(c.flops, c.hbm_bytes, dict(c.coll_bytes),
                    dict(c.coll_counts))


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _arg(func, args, kwargs, name):
    """The argument ``name`` of an op call, by its schema."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return args[i] if i < len(args) else kwargs.get(name)
    return None


def _group_size(func, args, kwargs) -> int:
    s = _arg(func, args, kwargs, "group_size")
    if s is not None:
        return int(s)
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(
        _arg(func, args, kwargs, "group_name")).size()


def _in_sharding_prop() -> bool:
    """Whether the op runs inside DTensor's sharding propagation, which
    runs each op once more at global shapes to learn its output's."""
    f = sys._getframe(2)
    while f is not None:
        if "sharding_prop" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def _last_node(*ts) -> int | None:
    """The largest autograd sequence number among the ``grad_fn`` of
    ``ts`` (None when none records)."""
    seqs = [t.grad_fn._sequence_nr() for t in ts
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    return max(seqs) if seqs else None


class _Alloc:
    """One storage's bytes in the live count, and what to do when it
    dies."""
    __slots__ = ("nbytes", "on_free", "ref")

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.on_free: list = []
        self.ref = None


_SKIP = frozenset((
    "aten.sym_is_contiguous.default", "aten.is_contiguous.default",
    "aten.is_contiguous.memory_format", "aten.is_strides_like_format.default",
    "aten.is_non_overlapping_and_dense.default", "aten.size.default",
    "aten.sym_size.default", "aten.stride.default", "aten.sym_stride.default",
    "aten.storage_offset.default", "aten.sym_storage_offset.default",
    "aten.numel.default", "aten.sym_numel.default", "aten.dim.default",
    "prim.layout.default", "prim.device.default"))  # metadata queries
_NO_BYTES = frozenset(("_c10d_functional.wait_tensor",
                       "_c10d_functional._wrap_tensor_autograd",
                       "aten._unsafe_view", "aten.lift_fresh"))


@dataclasses.dataclass(frozen=True)
class _Op:
    """What the counter needs of one op overload, looked up once."""
    skip: bool
    decomposes: bool        # not in the flop formulas, CompositeImplicit
    flops: object           # the flop formula or None
    kind: str | None        # collective kind
    rule: str  # bytes: "none" "view" "copy" "put" "fill" "inplace" "rw"

    @staticmethod
    def of(func, registry) -> "_Op":
        name, packet = str(func), str(func._overloadpacket)
        if name in _SKIP:
            return _Op(True, False, None, None, "none")
        dk = torch._C.DispatchKey.CompositeImplicitAutograd
        decomposes = (func._overloadpacket not in registry
                      and (dk in func.py_kernels
                           or torch._C._dispatch_has_kernel_for_dispatch_key(
                               func.name(), dk)))
        kind = None
        if packet.startswith("_c10d_functional"):
            kind = next((k for p, k in _C10D_KINDS
                         if packet.split(".")[1].startswith(p)), None)
        rets = func._schema.returns
        alias = bool(rets) and rets[0].alias_info is not None
        if packet in _NO_BYTES:
            rule = "none"
        elif alias and not rets[0].alias_info.is_write:
            rule = "view"
        elif packet == "aten.copy_":
            rule = "copy"
        elif packet in ("aten.index_put_", "aten.index_put"):
            rule = "put"
        elif packet in ("aten.fill_", "aten.zero_"):
            rule = "fill"
        elif alias:
            rule = "inplace"  # reads and writes an argument's storage
        else:
            rule = "rw"
        return _Op(False, decomposes, registry.get(func._overloadpacket),
                   kind, rule)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self.costs = HloCosts()
        self.live = 0
        self.peak = 0
        self._dtensor_cls = DTensor
        self._registry = flop_registry
        self._ops: dict = {}
        self._allocs: dict[int, _Alloc] = {}
        self._dtensor_seen = False
        self._weights: list[tuple[int, int, int]] = []  # (lo, hi], weight
        self._recording: list | None = None
        self._paused = False

    # ------------------------------------------------------------ live bytes
    def _bump(self, n: int) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it dies (once)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._allocs:
            return
        n = st.nbytes()
        if t.device.type == "cuda":
            n = -(-n // _CUDA_ROUND) * _CUDA_ROUND
        a = _Alloc(n)

        def freed(_, a=a, key=key, allocs=self._allocs, counter=self):
            if allocs.get(key) is a:
                del allocs[key]
            counter.live -= a.nbytes
            for cb in a.on_free:
                cb()
        a.ref = weakref.ref(st, freed)
        self._allocs[key] = a
        if self._recording is not None:
            self._recording.append(a)
        self._bump(n)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = self._ops.get(func)
        if op is None:
            op = self._ops[func] = _Op.of(func, self._registry)
        if op.skip:
            return NotImplemented
        if self._paused:
            return func(*args, **kwargs)
        if any(issubclass(t, self._dtensor_cls) for t in types):
            self._dtensor_seen = True
            return NotImplemented  # DTensor issues the local ops we count
        if op.decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if self._dtensor_seen and _in_sharding_prop():
            return out
        self._count(op, func, args, kwargs, out)
        return out

    def _weight(self) -> int:
        if not self._weights:
            return 1
        node = torch._C._current_autograd_node()
        if node is None:
            return 1
        seq = node._sequence_nr()
        for lo, hi, w in self._weights:
            if lo < seq <= hi:
                return w
        return 1

    def _count(self, op: _Op, func, args, kwargs, out) -> None:
        w = self._weight()
        c = self.costs
        if op.flops is not None:
            c.flops += w * op.flops(*args, **kwargs, out_val=out)
        if op.rule in ("none", "view") and op.kind is None:
            return
        outs = [out] if isinstance(out, torch.Tensor) else _tensors(out)
        if op.kind is not None:
            payload = sum(_nbytes(t) for t in outs)
            link = _collective_link_bytes(op.kind, payload,
                                          _group_size(func, args, kwargs))
            if link > 0:
                c.coll_bytes[op.kind] = c.coll_bytes.get(op.kind, 0.0) \
                    + w * link
                c.coll_counts[op.kind] = c.coll_counts.get(op.kind, 0) + w
        if op.rule in ("none", "view"):
            return
        if op.rule == "copy":
            c.hbm_bytes += w * 2 * _nbytes(args[1])
        elif op.rule == "put":
            c.hbm_bytes += w * (2 * _nbytes(args[2]) + sum(
                _nbytes(t) for t in _tensors(args[1])))
        elif op.rule == "fill":
            c.hbm_bytes += w * sum(_nbytes(t) for t in outs)
        else:
            c.hbm_bytes += w * (sum(_nbytes(t) for t in _tensors((args,
                                                                  kwargs)))
                                + sum(_nbytes(t) for t in outs))
        if op.rule == "rw":  # a fresh result
            for t in outs:
                self.track(t)

    # ------------------------------------------------------------ scans
    def scan(self, step, h, xs: tuple):
        """``models.ssm.SCAN_LOOP`` while counting (module docstring): the
        first two trips, one middle trip that stands for ``n - 5`` more,
        and the last two, whose backward differs from a middle trip's (the
        last takes no gradient from a later trip, so the one before it
        starts every gradient sum that the middle trips add to). Only the
        positions run are viewed (``ssm.positions``)."""
        from repro_torch.models import ssm
        n = xs[0].shape[1]
        run = range(n) if n <= SCAN_TRIPS else (0, 1, 2, n - 2, n - 1)
        at = ssm.positions(xs, run)

        def trip(h, t):
            return step(h, *at[t])
        ys = []
        if n <= SCAN_TRIPS:
            for t in range(n):
                h, y = trip(h, t)
                ys.append(y)
            return h, torch.stack(ys, dim=1)
        for t in range(2):
            h, y = trip(h, t)
            ys.append(y)
        lo = _last_node(h, y)
        before, live0 = _snapshot(self.costs), self.live
        self._recording = []
        h, y = trip(h, 2)
        made, self._recording = self._recording, None
        skip = n - SCAN_TRIPS
        self.costs.add(_since(self.costs, before).scaled(skip))
        hi = _last_node(h, y)
        if (lo is not None and hi is not None
                and torch._C._current_autograd_node() is None):
            # a forward (not a recompute in the backward): the middle
            # trip's backward nodes stand for the skipped trips' too
            self._weights.append((lo, hi, skip + 1))
        grown = self.live - live0
        carry = h.untyped_storage()._cdata
        held = [a for a in made
                if a.ref() is not None and a.ref()._cdata != carry]
        if grown > 0 and held:
            extra = skip * grown
            self._bump(extra)
            left = [len(held)]

            def one_freed(left=left, extra=extra, counter=self):
                left[0] -= 1
                if left[0] == 0:
                    counter.live -= extra
            for a in held:
                a.on_free.append(one_freed)
        ys.append(y)
        mid = y.detach().unsqueeze(1)
        for t in (n - 2, n - 1):
            h, y = trip(h, t)
            ys.append(y)
        # the stacked output, counted as the one stack of n rows that a run
        # of every trip makes; built uncounted from the 5 rows run and the
        # middle one repeated, so that autograd unbinds 5 rows, not n
        self._paused = True
        try:
            out = torch.cat([torch.stack(ys[:3], dim=1),
                             mid.expand(-1, skip, *mid.shape[2:]),
                             torch.stack(ys[3:], dim=1)], dim=1)
        finally:
            self._paused = False
        self.costs.hbm_bytes += 2 * _nbytes(out)
        self.track(out)
        return h, out

    def micro(self, micro_step, n: int) -> None:
        """``train_loop.MICRO_LOOP`` while counting (module docstring):
        the first ``MICRO_STEPS`` micro-batches run, the last of them
        counted once more for each one skipped."""
        for i in range(min(n, MICRO_STEPS) - 1):
            micro_step(i)
        before = _snapshot(self.costs)
        micro_step(min(n, MICRO_STEPS) - 1)
        self.costs.add(_since(self.costs, before).scaled(
            max(0, n - MICRO_STEPS)))


def analyze(step, *args, **kwargs):
    """Run ``step(*args, **kwargs)`` and count its per-rank costs (module
    docstring) -> (its output, ``HloCosts``, peak live bytes). Where a loop
    was sampled the output is not the step's value (under fake tensors no
    one reads it)."""
    from repro_torch.models import ssm
    from repro_torch.train import train_loop
    counter = _Counter()
    for t in _tensors((args, kwargs)):
        local = getattr(t, "_local_tensor", None)
        counter.track(t if local is None else local)
    prev = ssm.SCAN_LOOP, train_loop.MICRO_LOOP
    ssm.SCAN_LOOP, train_loop.MICRO_LOOP = counter.scan, counter.micro
    try:
        with counter:
            out = step(*args, **kwargs)
    finally:
        ssm.SCAN_LOOP, train_loop.MICRO_LOOP = prev
    return out, counter.costs, counter.peak


# ------------------------------------------------- legacy simple interface
@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def collective_stats(step, *args, **kwargs) -> CollectiveStats:
    """The collectives of one run of ``step`` (kept for API
    compatibility)."""
    c = analyze(step, *args, **kwargs)[1]
    return CollectiveStats(c.coll_bytes, c.coll_counts)


# NVIDIA H100 SXM constants (the roofline denominators), per GPU
PEAK_FLOPS_BF16 = 989e12     # dense bf16 tensor-core flop/s
HBM_BW = 3.35e12             # HBM3 bytes/s
# NVLink 4, bytes/s per direction per GPU: the counterpart of the
# reference's ICI_BW. A mesh of 256 or 512 GPUs spans hosts, whose links
# are slower, so collective_s is a lower bound.
LINK_BW = 450e9


def roofline_terms(flops: float, hbm_bytes: float,
                   coll_bytes: float) -> dict:
    """All inputs per-device. Returns the three terms in seconds."""
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = hbm_bytes / HBM_BW
    t_collective = coll_bytes / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    bound = max(t_compute, t_memory, t_collective)
    terms["roofline_fraction"] = t_compute / bound if bound > 0 else 0.0
    return terms
