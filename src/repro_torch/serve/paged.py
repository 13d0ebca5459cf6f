"""Paged-KV continuous batching and disaggregated prefill/decode.

Port of ``repro.serve.paged``. The contiguous
``ContinuousServeEngine`` reserves one ``max_len`` KV region per slot, so
its capacity is ``n_slots * max_len`` tokens of cache whether or not the
requests use them. This engine keeps the KV cache in one pool of
fixed-size blocks (``models.transformer.PagedLayout``) and gives each slot
a block table:

- **Admission** claims ``ceil(prompt_len / block_size)`` blocks, strictly
  FIFO: under memory pressure the head of the queue waits and nothing
  overtakes it. An attention-only model streams the prompt straight into
  the claimed blocks (``prefill_chunk_paged``). A model with mamba or rwkv
  layers stages it (``staged_prefill``): their carries cannot be rebuilt
  from paged context, so the slot prefills a B=1 contiguous state through
  ``prefill_chunk`` and hands it over with ``insert_request_paged`` when
  the prompt is done.
- **Lazy growth, block-granular free.** Decode grows a slot one block at a
  time; a finished request returns its blocks the same iteration.
- **Prefix sharing.** A fully written prompt block is registered under the
  prompt's tokens up to and including it; a later admission shares the
  longest common whole-block prefix by refcount. Off under an int8 KV
  cache, whose codes depend on where the chunks fell, and under staged
  prefill, whose carries a shared block cannot restore.
- **Eviction by recompute.** If decode needs a block and the pool is dry,
  the youngest other request loses its blocks (and a recurrent request its
  carries) and is requeued at the front; readmitted, it prefills from
  scratch. Greedy decoding and the per-request sampling stream (a fresh
  generator seeded with the request's seed, ``ContinuousServeEngine.
  _sample``) replay identically, so eviction never changes outputs.
- **Disaggregated prefill/decode.** With ``prefill_mesh``/``decode_mesh``
  (``launch.mesh.make_disaggregated_meshes``: two ``DeviceMesh`` slices
  over disjoint ranks of one process group, one process per rank) each
  rank learns its role from the meshes: a prefill rank is in the prefill
  slice, a decode rank in the decode slice, and a rank in neither raises.
  Prefill is staged at B=1 on the prefill ranks under their mesh and
  ``MULTIPOD_SERVE_RULES``; when a prompt is done, the first prefill rank
  broadcasts its B=1 state (attention K/V up to the prompt's length,
  recurrent carries) to every decode rank, which scatters it into the
  slot's blocks with ``insert_request_paged``; decode runs on the decode
  ranks under theirs. Every rank keeps its own plain copy of the params
  and plans; the pool exists only on decode ranks, staged states only on
  prefill ranks. The scheduler (queue, slots, tables, allocator, stats,
  sampling) runs on every rank and decides the same things everywhere:
  a prompt's first token travels with its handoff, and once an iteration
  the first decode rank broadcasts its decode step's tokens (and the rows
  a sampled request draws from) to every rank, together with a digest of
  its host decisions that every rank checks against its own. Both groups
  are opened at construction with a timeout (``GROUP_TIMEOUT``), so a
  collective that a rank misses fails instead of hanging. A backend
  without device tensors (``gloo``) gets the bytes staged through host
  memory; NCCL takes them on the device.

Greedy outputs equal the contiguous and lockstep engines' (see
``_paged_gather``: masked gather positions contribute exact zeros). The
pool is written in place; the host block table is authoritative, and each
call gets its own device copy of it.

Telemetry (``telemetry=``, as in ``ContinuousServeEngine``) adds the
reference's pool hooks: occupancy and peak on every change of the pool,
admission waits, prefix-block hits and evictions. In the disaggregated
mode every hook fires on every rank, as in one process: the prefill
span covers a rank's part of a chunk (its prefill, or receiving the
handoff) and the decode span its part of a step (the decode, or
receiving its tokens).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (
    MULTIPOD_SERVE_RULES,
    axis_rules,
    use_mesh,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.scheduler import (
    ContinuousServeEngine,
    RequestOutput,
    _Slot,
)

# how long a rank waits in a collective of the disaggregated engine (a
# handoff, or an iteration's tokens) before it fails
GROUP_TIMEOUT = datetime.timedelta(seconds=300)
# the host decisions every rank checks once an iteration (``_digest``)
DIGEST_KEYS = ("iteration", "live", "prefill_chunks", "evictions",
               "admission_waits", "completed", "blocks_in_use", "queued")


def _mesh_ranks(mesh) -> list[int]:
    """The global ranks of a ``DeviceMesh``, in mesh order."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def _slice_role(prefill_mesh, decode_mesh) -> str:
    """``"prefill"`` or ``"decode"``: the slice this rank has a coordinate
    in. Raises on a rank in neither slice or in both."""
    in_p = prefill_mesh.get_coordinate() is not None
    in_d = decode_mesh.get_coordinate() is not None
    if in_p and in_d:
        raise ValueError("prefill_mesh and decode_mesh overlap: this rank "
                         "is in both slices")
    if not (in_p or in_d):
        raise ValueError("this rank is in neither the prefill nor the "
                         "decode slice; a disaggregated engine runs on the "
                         "ranks of its two meshes only")
    return "prefill" if in_p else "decode"


def _padded(n: int) -> int:
    return -(-n // 8) * 8


def _packed_bytes(specs) -> int:
    """Bytes of ``_pack``'s buffer for parts of these (shape, dtype)."""
    return sum(_padded(int(np.prod(shape)) * dtype.itemsize)
               for shape, dtype in specs)


def _pack(parts: list[torch.Tensor]) -> torch.Tensor:
    """The bytes of ``parts`` in order, each padded to a multiple of 8, in
    one flat uint8 tensor on their device (one collective moves them)."""
    out = []
    for t in parts:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        out.append(b)
        if b.numel() % 8:
            out.append(b.new_zeros(-b.numel() % 8))
    return torch.cat(out)


def _unpack(buf: torch.Tensor, specs) -> list[torch.Tensor]:
    """``_pack``'s parts back as views of ``buf``, given their (shape,
    dtype); every part starts 8-byte aligned."""
    out, off = [], 0
    for shape, dtype in specs:
        n = int(np.prod(shape)) * dtype.itemsize
        out.append(buf[off:off + n].view(dtype).reshape(shape))
        off += _padded(n)
    return out


def _totals_vector(tot: L.DeviceTotals, device) -> torch.Tensor:
    """A decode step's PIM work totals as int64 in ``PIM_STAT_KEYS``
    order, on the device (no host sync)."""
    v = torch.tensor([tot.static[k] for k in L.PIM_STAT_KEYS],
                     dtype=torch.int64, device=device)
    if tot.counts is not None:
        idx = [L.PIM_STAT_KEYS.index(k) for k in L.PIM_DEVICE_KEYS]
        v[idx] += tot.counts.to(device)
    return v


class BlockAllocator:
    """Host-side free list, refcounts and prefix index over a fixed pool.

    Pool row ``n_blocks`` (the scratch/sentinel row) is never allocated.
    Prefix sharing is hash-chained like vLLM's: block ``j`` of a prompt
    registers under ``prompt[:(j + 1) * block_size].tobytes()``, so a
    lookup walks the chain and shares the longest common whole-block
    prefix. A registration lives exactly as long as some request
    refcounts the block: releasing the last reference unregisters it.
    """

    def __init__(self, n_blocks: int, block_size: int):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.free: collections.deque[int] = collections.deque(range(n_blocks))
        self.refcount = np.zeros(n_blocks, np.int32)
        self.prefix_index: dict[bytes, int] = {}
        self._block_key: dict[int, bytes] = {}

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - len(self.free)

    def prefix_key(self, prompt: np.ndarray, j: int) -> bytes:
        return np.ascontiguousarray(
            prompt[:(j + 1) * self.block_size], dtype=np.int32).tobytes()

    def match_prefix(self, prompt: np.ndarray) -> list[int]:
        """Registered blocks covering the longest whole-block prefix of
        ``prompt`` (non-mutating: claim the result to share it)."""
        out = []
        for j in range(len(prompt) // self.block_size):
            bid = self.prefix_index.get(self.prefix_key(prompt, j))
            if bid is None:
                break
            out.append(bid)
        return out

    def claim(self, bid: int) -> int:
        """Take a shared reference on an in-use block."""
        if self.refcount[bid] <= 0:
            raise RuntimeError(f"claim() of free block {bid}")
        self.refcount[bid] += 1
        return bid

    def alloc(self, n: int) -> list[int]:
        if n > len(self.free):
            raise RuntimeError(
                f"pool exhausted: want {n}, have {len(self.free)} free")
        out = [self.free.popleft() for _ in range(n)]
        for b in out:
            self.refcount[b] = 1
        return out

    def release(self, bid: int) -> None:
        if self.refcount[bid] <= 0:
            raise RuntimeError(f"double free of block {bid}")
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            key = self._block_key.pop(bid, None)
            if key is not None:
                self.prefix_index.pop(key, None)
            self.free.append(bid)

    def register(self, bid: int, key: bytes) -> None:
        """Publish a fully written prompt block for prefix sharing."""
        if key not in self.prefix_index and bid not in self._block_key:
            self.prefix_index[key] = bid
            self._block_key[bid] = key


@dataclasses.dataclass
class _PagedSlot(_Slot):
    blocks: list = dataclasses.field(default_factory=list)  # table order
    n_shared: int = 0     # leading blocks claimed through the prefix index
    live: bool = False    # prefill finished, decoding
    host_pos: int = 0     # authoritative position (the device pos of a
                          # mid-prefill slot drifts: prefill_chunk_paged)
    seq: int = 0          # admission order; eviction takes the youngest


class PagedServeEngine(ContinuousServeEngine):
    """Continuous batching over a paged KV pool, optionally disaggregated
    over a prefill and a decode mesh slice. The module docstring gives the
    semantics; intake, sampling streams and stop handling are inherited
    from ``ContinuousServeEngine``.

    Disaggregated, ``role`` is this rank's slice and every rank of both
    slices must construct the engine and call ``step`` (or ``run``) with
    the same requests; ``handoffs``, ``handoff_bytes`` and
    ``handoff_seconds`` count this rank's part of the handoffs (the first
    prefill rank: packing and sending; a decode rank: receiving, waiting
    for the prefill included, and inserting)."""

    def __init__(self, cfg: ArchConfig, params: Any, *, n_slots: int = 4,
                 max_len: int = 512, prefill_chunk: int = 64,
                 block_size: int = 16, n_blocks: int | None = None,
                 prefix_sharing: bool = True, plans: Any = None,
                 prefill_mesh=None, decode_mesh=None, telemetry=None):
        if block_size < 1 or max_len % block_size != 0:
            raise ValueError(
                f"block_size ({block_size}) must be >= 1 and divide "
                f"max_len ({max_len}) — the gathered per-slot view must "
                f"equal one contiguous max_len cache for bit-identity")
        max_blocks = max_len // block_size
        if n_blocks is None:
            n_blocks = n_slots * max_blocks    # no memory pressure
        if n_blocks < max_blocks:
            raise ValueError(
                f"n_blocks ({n_blocks}) under max_len/block_size "
                f"({max_blocks}): one max-length request could never fit "
                f"even after evicting everything else")
        if (prefill_mesh is None) != (decode_mesh is None):
            raise ValueError(
                "pass both prefill_mesh and decode_mesh, or neither")
        self.prefill_mesh, self.decode_mesh = prefill_mesh, decode_mesh
        self.role = (None if prefill_mesh is None
                     else _slice_role(prefill_mesh, decode_mesh))
        self.layout = T.PagedLayout(n_blocks=n_blocks, block_size=block_size)
        self.alloc = BlockAllocator(n_blocks, block_size)
        super().__init__(cfg, params, n_slots=n_slots, max_len=max_len,
                         prefill_chunk=prefill_chunk, plans=plans,
                         telemetry=telemetry)
        # recurrent carries cannot be rebuilt from paged context, and a
        # disaggregated prefill has no pool: both prefill at B=1 and hand
        # over through insert_request_paged
        self.staged_prefill = (any(k != "attn" for k in cfg.block_pattern)
                               or self.role is not None)
        # int8 KV quantizes per chunk, so a shared block written under one
        # chunking is not bit-identical under another: no sharing there
        self.prefix_sharing = (prefix_sharing and not self.staged_prefill
                               and cfg.kv_cache_dtype != "int8")
        self._seq = 0
        # host-authoritative block tables (sentinel = unmapped)
        self.tables = np.full((n_slots, max_blocks), self.layout.sentinel,
                              np.int64)
        if self.role is not None:
            self._open_groups()

    def _init_state(self) -> dict | None:
        """The block pool (none on a prefill rank)."""
        if self.role == "prefill":
            return None
        return T.init_decode_state(self.cfg, self.n_slots, self.max_len,
                                   per_slot_pos=True, paged=self.layout,
                                   device=self.device)

    def _staged_state(self) -> Any:
        """A slot's B=1 prefill state (none on a decode rank)."""
        if self.role == "decode":
            return None
        return super()._staged_state()

    # ------------------------------------------------------ disaggregated
    def _open_groups(self) -> None:
        """Open the handoff group (the first prefill rank and every decode
        rank) and the iteration group (every rank of both slices). Every
        rank of the slices opens both, in this order, once."""
        pre = _mesh_ranks(self.prefill_mesh)
        dec = _mesh_ranks(self.decode_mesh)
        self.rank = dist.get_rank()
        self._src_p, self._src_d = pre[0], dec[0]
        self._handoff_group = dist.new_group([pre[0]] + dec,
                                             timeout=GROUP_TIMEOUT)
        self._step_group = dist.new_group(pre + dec, timeout=GROUP_TIMEOUT)
        # gloo broadcasts host tensors here; NCCL takes device tensors
        self._on_host = dist.get_backend(self._step_group) != "nccl"
        # the B=1 state's leaves, shapes only (the handoff's layout)
        self._template1 = T.init_decode_state(self.cfg, 1, self.max_len,
                                              device="meta")
        self._iteration = 0
        self._token_hash = 0
        self.handoffs, self.handoff_bytes, self.handoff_seconds = 0, 0, 0.0

    @contextlib.contextmanager
    def _on(self, mesh):
        """Run under one slice's mesh and ``MULTIPOD_SERVE_RULES`` (nothing
        without a mesh)."""
        if mesh is None:
            yield
            return
        with use_mesh(mesh), axis_rules(MULTIPOD_SERVE_RULES):
            yield

    def _broadcast(self, buf: torch.Tensor | None, n_bytes: int, src: int,
                   group) -> torch.Tensor:
        """One broadcast of ``n_bytes`` from rank ``src``, whose ``buf``
        they are, over ``group``: staged through host memory for a backend
        without device tensors. Returns them on the host when staged, else
        on the device."""
        mine = self.rank == src
        if mine and buf.numel() != n_bytes:
            raise RuntimeError(f"packed {buf.numel()} bytes, the layout "
                               f"says {n_bytes}")
        if self._on_host:
            out = buf.cpu() if mine else torch.empty(n_bytes,
                                                     dtype=torch.uint8)
        else:
            out = buf if mine else torch.empty(n_bytes, dtype=torch.uint8,
                                               device=self.device)
        dist.broadcast(out, src=src, group=group)
        return out

    def _handoff_specs(self, slot: _PagedSlot, hi: int) -> list:
        """(shape, dtype) of a handoff's parts: each cache leaf of the B=1
        state (an attention leaf up to the prompt's length ``hi``), the
        first token, and for a sampled request its float32 logits row."""
        specs = []
        for c in self._template1["caches"]:
            for t in c.values():
                shape = ((1, hi) + tuple(t.shape[2:]) if "k" in c
                         else tuple(t.shape))
                specs.append((shape, t.dtype))
        specs.append(((1,), torch.int64))
        if slot.req.temperature > 0.0:
            specs.append(((self.cfg.vocab_size,), torch.float32))
        return specs

    def _handoff(self, i: int, slot: _PagedSlot, logits, hi: int) -> tuple:
        """Hand slot ``i``'s finished B=1 state from the first prefill rank
        to every decode rank, which scatters it into the slot's blocks
        under the decode mesh. Returns the prompt's first-token inputs, the
        same on every rank: the float32 logits row on the host for a
        sampled request (else None) and the greedy token."""
        specs = self._handoff_specs(slot, hi)
        n_bytes = _packed_bytes(specs)
        sampled = slot.req.temperature > 0.0
        if self.role == "prefill" and self.device.type == "cuda":
            # the chunk's kernels end first: handoff_seconds time the
            # handoff alone (its first host copy would wait for them)
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if self.role == "prefill":
            row = logits[0, -1].to(torch.float32)
            parts = [t[:, :hi] if "k" in c else t
                     for c in slot.state1["caches"] for t in c.values()]
            tok = torch.argmax(row).reshape(1)
            parts += [tok, row] if sampled else [tok]
            slot.state1 = None
            if self.rank == self._src_p:
                self._broadcast(_pack(parts), n_bytes, self._src_p,
                                self._handoff_group)
                self._count_handoff(n_bytes, t0)
            return (row.cpu() if sampled else None), int(tok)
        got = iter(_unpack(self._broadcast(
            None, n_bytes, self._src_p, self._handoff_group
        ).to(self.device), specs))
        caches = []
        for c in self._template1["caches"]:
            leaves = {}
            for k, t in c.items():
                part = next(got)
                if "k" in c:  # the rest of max_len stays zero, as staged
                    full = torch.zeros(t.shape, dtype=t.dtype,
                                       device=self.device)
                    full[:, :hi] = part
                    part = full
                leaves[k] = part
            caches.append(leaves)
        tok = int(next(got))
        row = next(got).cpu() if sampled else None
        with self._on(self.decode_mesh):
            T.insert_request_paged(self.state, {"caches": caches, "pos": hi},
                                   i, self._device_table(self.tables[i]),
                                   self.layout)
        if self.device.type == "cuda":  # handoff_seconds cover the insert
            torch.cuda.synchronize(self.device)
        self._count_handoff(n_bytes, t0)
        return row, tok

    def _count_handoff(self, n_bytes: int, t0: float) -> None:
        self.handoffs += 1
        self.handoff_bytes += n_bytes
        self.handoff_seconds += time.perf_counter() - t0

    def _prefill_split(self, i: int, slot: _PagedSlot, prompt: np.ndarray,
                       lo: int, hi: int, last: bool):
        """One chunk of slot ``i``'s staged prefill, on the prefill ranks
        under the prefill mesh; after the prompt's ``last`` chunk, its
        handoff, whose first-token inputs it returns (else None)."""
        logits = None
        if self.role == "prefill":
            toks = torch.as_tensor(prompt[None, lo:hi], dtype=torch.int64,
                                   device=self.device)
            with self._on(self.prefill_mesh):
                logits, slot.state1 = T.prefill_chunk(
                    self.params, self.cfg, slot.state1, toks,
                    plans=self.plans)
        return self._handoff(i, slot, logits, hi) if last else None

    def _digest(self, live: list[int]) -> list[int]:
        """This rank's host decisions so far (``DIGEST_KEYS``)."""
        st = self.stats
        return [self._iteration, sum(1 << i for i in live),
                st.prefill_chunks, st.evictions, st.admission_waits,
                st.completed, self.alloc.blocks_in_use, len(self.queue),
                self._token_hash]

    def _decode_split(self, live: list[int], finished: list, t0: float,
                      tables: np.ndarray) -> None:
        """The iteration's one collective, reached by every rank whatever
        its role and whether or not a slot is live: the first decode rank
        broadcasts the digest of its host decisions, its decode step's
        greedy tokens, the step's PIM totals when the telemetry asks for
        them, and the float32 rows its sampled requests draw from. Every
        rank checks the digest (and a decode rank its own step's tokens)
        against its own, then commits the tokens. ``t0`` starts the step's
        host seconds."""
        head = self._digest(live)
        sampled = [i for i in live if self.slots[i].req.temperature > 0.0]
        n_tot = len(L.PIM_STAT_KEYS) if live and self._collect_pim else 0
        specs = ([((len(head) + len(live) + n_tot,), torch.int64)]
                 + [((self.cfg.vocab_size,), torch.float32)] * len(sampled))
        span = (self.tel.span("decode_step", n_live=len(live)) if live
                else contextlib.nullcontext())
        with span:
            mine = None
            if self.role == "decode":
                mine = (self._decode_here(live, sampled, head, tables)
                        if live else [torch.tensor(head, dtype=torch.int64,
                                                   device=self.device)])
            buf = self._broadcast(None if mine is None else _pack(mine),
                                  _packed_bytes(specs), self._src_d,
                                  self._step_group)
            parts = _unpack(buf, specs)
            ints = parts[0].tolist()
            if mine is not None and self.rank != self._src_d \
                    and mine[0].tolist() != ints:
                raise RuntimeError(
                    f"rank {self.rank}: decode step differs from rank "
                    f"{self._src_d}'s: {mine[0].tolist()} vs {ints}")
            if ints[:len(head)] != head:
                theirs = dict(zip(DIGEST_KEYS, ints[:len(head)]))
                raise RuntimeError(
                    f"rank {self.rank}: host state diverged from rank "
                    f"{self._src_d}'s: {dict(zip(DIGEST_KEYS, head))} vs "
                    f"{theirs}")
            if not live:
                return
            greedy = ints[len(head):len(head) + len(live)]
            rows = dict(zip(sampled, (p.cpu() for p in parts[1:])))
            if n_tot:
                self.tel.on_pim_totals(
                    dict(zip(L.PIM_STAT_KEYS, ints[-n_tot:])), len(live))
            self.tel.observe_decode_step_seconds(time.perf_counter() - t0)
            self.stats.decode_steps += 1
            self.stats.decode_slot_tokens += len(live)
            self.tel.on_decode_step(len(live))
            for i, tok in zip(live, greedy):
                self._commit(i, self.slots[i],
                             self._sample(self.slots[i], rows.get(i), tok),
                             finished)

    def _decode_here(self, live: list[int], sampled: list[int],
                     head: list[int], tables: np.ndarray) -> list:
        """A decode rank's paged decode step under the decode mesh; returns
        ``_decode_split``'s parts on the device."""
        toks = torch.zeros((self.n_slots, 1), dtype=torch.int64)
        for i in live:
            toks[i, 0] = self.slots[i].next_tok
        with self.tel.annotate_step("decode_step", self.stats.decode_steps), \
                self._on(self.decode_mesh):
            out = self._decode(self.params, self.cfg, self.state,
                               toks.to(self.device), plans=self.plans,
                               block_tables=self._device_table(tables),
                               paged=self.layout)
        logits, self.state = out[:2]
        last = logits[:, -1].to(torch.float32)
        ints = [torch.tensor(head, dtype=torch.int64, device=self.device),
                torch.argmax(last[live], dim=-1)]
        if self._collect_pim:
            ints.append(_totals_vector(out[2], self.device))
        return [torch.cat(ints)] + [last[i] for i in sampled]

    # ----------------------------------------------------------- helpers
    def _note_blocks(self) -> None:
        used = self.alloc.blocks_in_use
        self.stats.blocks_in_use = used
        self.stats.peak_blocks_in_use = max(self.stats.peak_blocks_in_use,
                                            used)
        self.tel.on_pool(used, self.stats.peak_blocks_in_use)

    def _drain_budget(self) -> int:
        # evicted requests recompute from scratch; in the worst case each
        # of the other slots' requests preempts a victim once
        return super()._drain_budget() * (1 + self.n_slots)

    def _device_table(self, table: np.ndarray) -> torch.Tensor:
        """A device copy of a host table: later host edits never reach a
        table a queued call still reads."""
        return torch.tensor(table, dtype=torch.int64, device=self.device)

    # ---------------------------------------------------------- lifecycle
    def _try_admit(self, i: int) -> bool:
        """Admit the queue head into free slot ``i`` if its prompt blocks
        fit (strict FIFO: on a miss the head keeps waiting)."""
        req = self.queue[0]
        prompt = np.asarray(req.prompt, np.int32)
        plen = prompt.shape[0]
        bs = self.layout.block_size
        shared: list[int] = []
        if self.prefix_sharing:
            # at least one prompt token must be prefilled (the first token
            # needs its logits), and decode never writes a shared block
            shared = self.alloc.match_prefix(prompt)[:(plen - 1) // bs]
        need = self.layout.blocks_for(plen) - len(shared)
        if need > len(self.alloc.free):
            self.stats.admission_waits += 1
            self.tel.on_admission_wait(req.uid)
            return False
        self.queue.popleft()
        blocks = [self.alloc.claim(b) for b in shared] + self.alloc.alloc(need)
        self.stats.prefix_block_hits += len(shared)
        self.tel.on_admit(req.uid, plen)
        if shared:
            self.tel.on_prefix_hits(req.uid, len(shared))
        state1 = self._staged_state() if self.staged_prefill else None
        self.slots[i] = _PagedSlot(req=req, state1=state1, blocks=blocks,
                                   n_shared=len(shared),
                                   n_prefilled=len(shared) * bs,
                                   seq=self._seq)
        self._seq += 1
        self.tables[i, :] = self.layout.sentinel
        self.tables[i, :len(blocks)] = blocks
        self._note_blocks()
        return True

    def _insert(self, i: int, state1: Any) -> None:
        """Hand a staged slot's finished B=1 state to the pool."""
        T.insert_request_paged(self.state, state1, i,
                               self._device_table(self.tables[i]),
                               self.layout)

    def _free_slot(self, i: int, slot: _PagedSlot) -> None:
        for b in slot.blocks:
            self.alloc.release(b)
        slot.blocks = []
        self.tables[i, :] = self.layout.sentinel

    def _commit(self, idx: int, slot: _Slot, tok: int,
                finished: list[RequestOutput]) -> None:
        if self.role is not None:  # every committed token, in order
            self._token_hash = (self._token_hash * 1_000_003 + tok + 1) \
                % (1 << 61)
        super()._commit(idx, slot, tok, finished)
        if self.slots[idx] is None:        # retired: block-granular free
            self._free_slot(idx, slot)
            self._note_blocks()

    def _evict_youngest(self, protect: int) -> None:
        """Preempt the youngest other request: free its blocks and requeue
        it at the front (it was admitted before everything still queued,
        so FIFO order holds)."""
        victims = [(s.seq, j) for j, s in enumerate(self.slots)
                   if s is not None and j != protect]
        if not victims:
            raise RuntimeError(
                "pool exhausted with no evictable request — unreachable "
                "when n_blocks * block_size >= max_len")
        _, j = max(victims)
        slot = self.slots[j]
        self._free_slot(j, slot)
        self.queue.appendleft(slot.req)
        self.slots[j] = None
        self.stats.evictions += 1
        self.tel.on_eviction(slot.req.uid)

    def _ensure_decode_block(self, i: int) -> None:
        """Grow slot ``i``'s table to cover its next write position,
        evicting youngest-first under pressure."""
        slot = self.slots[i]
        bi = slot.host_pos // self.layout.block_size
        while len(slot.blocks) <= bi:
            while not self.alloc.free:
                self._evict_youngest(protect=i)
            slot.blocks.extend(self.alloc.alloc(1))
            self.tables[i, len(slot.blocks) - 1] = slot.blocks[-1]
        self._note_blocks()

    def _register_prompt_blocks(self, slot: _PagedSlot) -> None:
        """Publish the finished prompt's full private blocks for sharing."""
        if not self.prefix_sharing:
            return
        prompt = np.asarray(slot.req.prompt, np.int32)
        for j in range(slot.n_shared,
                       prompt.shape[0] // self.layout.block_size):
            self.alloc.register(slot.blocks[j],
                                self.alloc.prefix_key(prompt, j))

    # ------------------------------------------------------------- engine
    def _iterate(self) -> list[RequestOutput]:
        """``step``'s body: admit (FIFO, queue until blocks free) -> one
        prefill chunk per admitted slot that is not live (in the pool, or
        staged at B=1 and inserted when its prompt is done) -> one batched
        paged decode of the live slots (lazy block growth, eviction under
        pressure). One host sync for the finished prefills' logits and one
        for the decode step's, as in the parent engine. Disaggregated, the
        prefill ranks run the chunks, the decode ranks the decode step, and
        every rank takes part in the handoffs and in the iteration's
        broadcast of tokens (``_decode_split``)."""
        finished: list[RequestOutput] = []
        if self.role is not None:
            self._iteration += 1
        with self.tel.span("admission"):
            free_idx = [i for i, s in enumerate(self.slots) if s is None]
            while free_idx and self.queue:
                if not self._try_admit(free_idx[0]):
                    break                   # head waits; FIFO holds
                free_idx.pop(0)
        done = []
        for i, slot in enumerate(self.slots):
            if slot is None or slot.live:
                continue
            prompt = np.asarray(slot.req.prompt)
            lo = slot.n_prefilled
            hi = min(lo + self.prefill_chunk, prompt.shape[0])
            last = hi == prompt.shape[0]
            with self._prefill_span(slot, lo, hi):
                if self.role is not None:
                    first = self._prefill_split(i, slot, prompt, lo, hi,
                                                last)
                else:
                    toks = torch.as_tensor(prompt[None, lo:hi],
                                           dtype=torch.int64,
                                           device=self.device)
                    if self.staged_prefill:
                        logits = self._prefill_staged(i, slot, toks, last)
                    else:
                        logits, self.state = T.prefill_chunk_paged(
                            self.params, self.cfg, self.state, toks, slot=i,
                            table_row=self._device_table(self.tables[i]),
                            pos0=lo, paged=self.layout, plans=self.plans)
                    first = logits[0, -1]
            slot.n_prefilled = hi
            self.stats.prefill_chunks += 1
            self.tel.on_prefill_chunk(slot.req.uid, lo, hi)
            if last:
                slot.live = True
                slot.host_pos = hi
                self._register_prompt_blocks(slot)
                done.append((i, slot, first))
        if done:
            if self.role is None:
                self._commit_prefilled(done, finished)
            else:  # first-token inputs, already on the host
                for i, slot, (row, tok) in done:
                    self._commit(i, slot, self._sample(slot, row, tok),
                                 finished)
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.live]
        for i in sorted(live, key=lambda j: self.slots[j].seq):
            if self.slots[i] is not None:   # an eviction may have taken it
                self._ensure_decode_block(i)
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.live]
        t0 = time.perf_counter()
        tables = np.full_like(self.tables, self.layout.sentinel)
        for i in live:
            tables[i] = self.tables[i]  # other rows stay sentinel
            self.slots[i].host_pos += 1
        if self.role is not None:
            self._decode_split(live, finished, t0, tables)
        elif live:
            self._decode_live(live, finished, t0,
                              block_tables=self._device_table(tables),
                              paged=self.layout)
        return finished
