"""Continuous-batching serve engine (iteration-level scheduling).

Port of ``repro.serve.scheduler.ContinuousServeEngine``, contiguous caches,
no telemetry object yet:

- the batched decode state holds ``n_slots`` cache slots (KV caches and
  recurrent carries) with per-slot positions
  (``init_decode_state(..., per_slot_pos=True)``);
- each iteration admits queued requests into free slots, advances every
  prefilling slot by at most one prefill chunk, then runs one batched
  ``decode_step`` for every slot that is mid-generation;
- a finished request frees its slot at once; the next request's B=1
  prefill state is spliced in with ``insert_request``.

Greedy outputs equal running each request alone through the lockstep
engine: decode math is per-slot independent and chunked prefill reproduces
whole-prompt prefill for float KV caches. Each iteration makes one host
sync for all slots' logits (greedy argmax takes the first maximum, as
``np.argmax`` and ``torch.argmax`` both do). A sampled request draws from
a CPU generator seeded with its seed, through the lockstep engine's
``sample`` on its host row, so it replays that engine's B = 1 stream
(``serve.engine`` says why the host).
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
from repro_torch.serve.engine import check_plans, sample


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request with its own sampling/stop parameters."""
    uid: int
    prompt: np.ndarray                     # (prompt_len,) int token ids
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    stop_tokens: tuple[int, ...] = ()      # stop after emitting any of these


@dataclasses.dataclass
class RequestOutput:
    uid: int
    prompt_len: int
    tokens: np.ndarray                     # (n_generated,) int32, includes
    finish_reason: str                     # the stop token: "stop"|"length"


@dataclasses.dataclass
class ServeStats:
    decode_steps: int = 0                  # batched decode_step calls
    decode_slot_tokens: int = 0            # useful tokens over those calls
    prefill_chunks: int = 0
    completed: int = 0
    # host wall-clock of each phase, up to the iteration's one host sync
    # (the logits fetch), so device time is included
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    # block-pool accounting (paged engine, ``serve.paged``; zero on the
    # contiguous engine, whose per-slot regions are never shared)
    blocks_in_use: int = 0                 # current pool occupancy
    peak_blocks_in_use: int = 0
    evictions: int = 0                     # preempt-by-recompute events
    prefix_block_hits: int = 0             # shared-prefix blocks reused
    admission_waits: int = 0               # iterations head-of-queue waited

    @property
    def decode_utilization(self) -> float:
        """Average useful tokens per decode step (0.0 before any step)."""
        return 0.0 if self.decode_steps == 0 else (
            self.decode_slot_tokens / self.decode_steps)


EngineStats = ServeStats   # the reference's older name


@dataclasses.dataclass
class _Slot:
    req: Request
    state1: Any                    # B=1 partial prefill state, until inserted
    n_prefilled: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    next_tok: int = 0
    gen: torch.Generator | None = None  # only if temperature > 0


class ContinuousServeEngine:
    """Slot-based continuous batching over prefill_chunk / decode_step."""

    def __init__(self, cfg: ArchConfig, params: Any, *, n_slots: int = 4,
                 max_len: int = 512, prefill_chunk: int = 64,
                 plans: Any = None):
        check_plans(cfg, plans)
        if n_slots < 1 or prefill_chunk < 1:
            raise ValueError("n_slots and prefill_chunk must be >= 1")
        self.cfg = cfg
        self.params = params
        self.plans = plans
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.device = params["embed"]["embed"].device
        self.state = self._init_state()
        self.slots: list[_Slot | None] = [None] * n_slots
        self.queue: collections.deque[Request] = collections.deque()
        self.stats = ServeStats()

    def _init_state(self) -> dict:
        """The batched decode state: one contiguous ``max_len`` region per
        slot (the paged engine allocates a block pool instead)."""
        return T.init_decode_state(self.cfg, self.n_slots, self.max_len,
                                   per_slot_pos=True, device=self.device)

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        plen = int(np.asarray(req.prompt).shape[0])
        if plen < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: max_new_tokens < 1")
        if plen + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt ({plen}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds engine max_len "
                f"({self.max_len})")
        self.queue.append(req)

    @property
    def active_uids(self) -> tuple[int, ...]:
        return tuple(s.req.uid for s in self.slots if s is not None)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    # ------------------------------------------------------------- engine
    def _sample(self, slot: _Slot, logits_row: torch.Tensor,
                greedy_tok: int) -> int:
        if slot.req.temperature <= 0.0:
            return greedy_tok
        if slot.gen is None:  # a host generator, as the lockstep engine's
            slot.gen = torch.Generator().manual_seed(slot.req.seed)
        return int(sample(logits_row[None], slot.req.temperature, slot.gen))

    def _commit(self, idx: int, slot: _Slot, tok: int,
                finished: list[RequestOutput]) -> None:
        """Record a generated token; retire the slot if the request is done."""
        slot.tokens.append(tok)
        slot.next_tok = tok
        reason = None
        if tok in slot.req.stop_tokens:
            reason = "stop"
        elif len(slot.tokens) >= slot.req.max_new_tokens:
            reason = "length"
        if reason is not None:
            finished.append(RequestOutput(
                uid=slot.req.uid,
                prompt_len=int(np.asarray(slot.req.prompt).shape[0]),
                tokens=np.asarray(slot.tokens, np.int32),
                finish_reason=reason))
            self.slots[idx] = None
            self.stats.completed += 1

    def _staged_state(self) -> Any:
        """A fresh B=1 decode state for a slot's prompt."""
        return T.init_decode_state(self.cfg, 1, self.max_len,
                                   device=self.device)

    def _prefill_staged(self, i: int, slot: _Slot, toks: torch.Tensor,
                        last: bool) -> torch.Tensor:
        """Advance slot ``i``'s B=1 state by one prefill chunk; after the
        prompt's ``last`` chunk, splice it into the batched state. Returns
        the chunk's logits."""
        logits, slot.state1 = T.prefill_chunk(
            self.params, self.cfg, slot.state1, toks, plans=self.plans)
        if last:
            self._insert(i, slot.state1)
            slot.state1 = None
        return logits

    def _insert(self, i: int, state1: Any) -> None:
        """Splice a finished B=1 prefill state into slot ``i``."""
        T.insert_request(self.state, state1, i)

    @torch.no_grad()
    def step(self) -> list[RequestOutput]:
        """One scheduler iteration: admit -> prefill one chunk -> decode.
        Returns the requests that finished during this iteration."""
        finished: list[RequestOutput] = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                self.slots[i] = _Slot(req=self.queue.popleft(),
                                      state1=self._staged_state())
        done = []
        t0 = time.perf_counter()
        for i, slot in enumerate(self.slots):
            if slot is None or slot.state1 is None:
                continue
            prompt = np.asarray(slot.req.prompt)
            lo = slot.n_prefilled
            hi = min(lo + self.prefill_chunk, prompt.shape[0])
            toks = torch.as_tensor(prompt[None, lo:hi], dtype=torch.int64,
                                   device=self.device)
            logits = self._prefill_staged(i, slot, toks,
                                          last=hi == prompt.shape[0])
            slot.n_prefilled = hi
            self.stats.prefill_chunks += 1
            if hi == prompt.shape[0]:
                done.append((i, slot, logits[0, -1]))
        if done:
            rows = torch.stack([lg for _, _, lg in done]).cpu()
            for (i, slot, _), row in zip(done, rows):
                self._commit(i, slot,
                             self._sample(slot, row, int(torch.argmax(row))),
                             finished)
            self.stats.prefill_seconds += time.perf_counter() - t0
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.state1 is None]
        if live:
            t0 = time.perf_counter()
            toks = torch.zeros((self.n_slots, 1), dtype=torch.int64)
            for i in live:
                toks[i, 0] = self.slots[i].next_tok
            logits, self.state = T.decode_step(
                self.params, self.cfg, self.state, toks.to(self.device),
                plans=self.plans)
            rows = logits[:, -1].cpu()
            self.stats.decode_seconds += time.perf_counter() - t0
            self.stats.decode_steps += 1
            self.stats.decode_slot_tokens += len(live)
            greedy = torch.argmax(rows, dim=-1)
            for i in live:
                self._commit(i, self.slots[i],
                             self._sample(self.slots[i], rows[i],
                                          int(greedy[i])), finished)
        return finished

    def _drain_budget(self) -> int:
        """Iteration cap for ``run`` (the paged engine widens it: evicted
        requests recompute from scratch)."""
        return ((len(self.queue) + len(self.active_uids) + 1)
                * (self.max_len + self.max_len // self.prefill_chunk + 2))

    def run(self, requests: list[Request] | None = None,
            max_iters: int | None = None) -> list[RequestOutput]:
        """Submit ``requests`` and step until everything finishes; outputs
        ordered by ``uid``."""
        for r in requests or ():
            self.submit(r)
        budget = max_iters if max_iters is not None else self._drain_budget()
        outputs: list[RequestOutput] = []
        it = 0
        while self.has_work:
            if it >= budget:
                raise RuntimeError(
                    f"scheduler did not drain within {budget} iterations")
            outputs.extend(self.step())
            it += 1
        return sorted(outputs, key=lambda o: o.uid)
