"""Paged-KV continuous batching.

Port of ``repro.serve.paged`` without the disaggregated prefill/decode
meshes and without the telemetry object. The contiguous
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

Greedy outputs equal the contiguous and lockstep engines' (see
``_paged_gather``: masked gather positions contribute exact zeros). The
pool is written in place; the host block table is authoritative, and each
call gets its own device copy of it.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.serve.scheduler import (
    ContinuousServeEngine,
    RequestOutput,
    _Slot,
)


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
    """Continuous batching over a paged KV pool. The module docstring
    gives the semantics; intake, sampling streams and stop handling are
    inherited from ``ContinuousServeEngine``."""

    def __init__(self, cfg: ArchConfig, params: Any, *, n_slots: int = 4,
                 max_len: int = 512, prefill_chunk: int = 64,
                 block_size: int = 16, n_blocks: int | None = None,
                 prefix_sharing: bool = True, plans: Any = None):
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
        self.layout = T.PagedLayout(n_blocks=n_blocks, block_size=block_size)
        self.alloc = BlockAllocator(n_blocks, block_size)
        super().__init__(cfg, params, n_slots=n_slots, max_len=max_len,
                         prefill_chunk=prefill_chunk, plans=plans)
        # recurrent carries cannot be rebuilt from paged context: such
        # models prefill at B=1 and hand over through insert_request_paged
        self.staged_prefill = any(k != "attn" for k in cfg.block_pattern)
        # int8 KV quantizes per chunk, so a shared block written under one
        # chunking is not bit-identical under another: no sharing there
        self.prefix_sharing = (prefix_sharing and not self.staged_prefill
                               and cfg.kv_cache_dtype != "int8")
        self._seq = 0
        # host-authoritative block tables (sentinel = unmapped)
        self.tables = np.full((n_slots, max_blocks), self.layout.sentinel,
                              np.int64)

    def _init_state(self) -> dict:
        return T.init_decode_state(self.cfg, self.n_slots, self.max_len,
                                   per_slot_pos=True, paged=self.layout,
                                   device=self.device)

    # ----------------------------------------------------------- helpers
    def _note_blocks(self) -> None:
        used = self.alloc.blocks_in_use
        self.stats.blocks_in_use = used
        self.stats.peak_blocks_in_use = max(self.stats.peak_blocks_in_use,
                                            used)

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
            return False
        self.queue.popleft()
        blocks = [self.alloc.claim(b) for b in shared] + self.alloc.alloc(need)
        self.stats.prefix_block_hits += len(shared)
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
    @torch.no_grad()
    def step(self) -> list[RequestOutput]:
        """One iteration: admit (FIFO, queue until blocks free) -> one
        prefill chunk per admitted slot that is not live (in the pool, or
        staged at B=1 and inserted when its prompt is done) -> one batched
        paged decode of the live slots (lazy block growth, eviction under
        pressure). One host sync for the finished prefills' logits and one
        for the decode step's, as in the parent engine."""
        finished: list[RequestOutput] = []
        free_idx = [i for i, s in enumerate(self.slots) if s is None]
        while free_idx and self.queue:
            if not self._try_admit(free_idx[0]):
                break                       # head waits; FIFO holds
            free_idx.pop(0)
        done = []
        t0 = time.perf_counter()
        for i, slot in enumerate(self.slots):
            if slot is None or slot.live:
                continue
            prompt = np.asarray(slot.req.prompt)
            lo = slot.n_prefilled
            hi = min(lo + self.prefill_chunk, prompt.shape[0])
            toks = torch.as_tensor(prompt[None, lo:hi], dtype=torch.int64,
                                   device=self.device)
            if self.staged_prefill:
                logits = self._prefill_staged(i, slot, toks,
                                              last=hi == prompt.shape[0])
            else:
                logits, self.state = T.prefill_chunk_paged(
                    self.params, self.cfg, self.state, toks, slot=i,
                    table_row=self._device_table(self.tables[i]), pos0=lo,
                    paged=self.layout, plans=self.plans)
            slot.n_prefilled = hi
            self.stats.prefill_chunks += 1
            if hi == prompt.shape[0]:
                slot.live = True
                slot.host_pos = hi
                self._register_prompt_blocks(slot)
                done.append((i, slot, logits[0, -1]))
        if done:
            rows = torch.stack([lg for _, _, lg in done]).cpu()
            for (i, slot, _), row in zip(done, rows):
                self._commit(i, slot,
                             self._sample(slot, row, int(torch.argmax(row))),
                             finished)
            self.stats.prefill_seconds += time.perf_counter() - t0
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.live]
        for i in sorted(live, key=lambda j: self.slots[j].seq):
            if self.slots[i] is not None:   # an eviction may have taken it
                self._ensure_decode_block(i)
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.live]
        if live:
            t0 = time.perf_counter()
            toks = torch.zeros((self.n_slots, 1), dtype=torch.int64)
            tables = np.full_like(self.tables, self.layout.sentinel)
            for i in live:
                toks[i, 0] = self.slots[i].next_tok
                tables[i] = self.tables[i]  # other rows stay sentinel
            logits, self.state = T.decode_step(
                self.params, self.cfg, self.state, toks.to(self.device),
                plans=self.plans, block_tables=self._device_table(tables),
                paged=self.layout)
            rows = logits[:, -1].cpu()
            self.stats.decode_seconds += time.perf_counter() - t0
            self.stats.decode_steps += 1
            self.stats.decode_slot_tokens += len(live)
            greedy = torch.argmax(rows, dim=-1)
            for i in live:
                slot = self.slots[i]
                slot.host_pos += 1
                self._commit(i, slot, self._sample(slot, rows[i],
                                                   int(greedy[i])), finished)
        return finished
