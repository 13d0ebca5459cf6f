"""Driver kind ``serve``: a closed loop of clients over the port's
continuous-batching engine (``repro_torch.serve.ContinuousServeEngine``).

Each client sends its next request when its last one finishes; requests
come from the traffic mix's pool in order (``core.traffic``), greedy, with
no stop tokens, so each generates exactly its ``new_tokens``. The mix's
``start`` says where the window opens: ``queued``, with every client's
first request waiting to be admitted, or ``decoding``, after set-up has
stepped the engine until no session is still prefilling (the first
prompts are then in the cache, as on a server already under this load).
The window calls ``engine.step()`` until an iteration would start past
``seconds``; every step ends in the engine's one host fetch, and every
token it committed is stamped with the host clock at that step's return.

The engine is the port's, with host hooks of the benchmark's own around
its calls into the model (``_prefill_staged``, ``_decode_live``) and its
token commits (``_commit``): they record the rows each call processed and
its host span, and call the port's code unchanged.

After the window the check runs the plain reference (float32, exact
int8 projections, its own calibration) over a sample of the finished
requests drawn from the seed, the longest among them, each prompt with its
served tokens, and reads ``top_gap`` of every served token; and compares
the PIM layer's counters with what the window's decode steps and prefill
heads must bill.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench.core import program, traffic as gen, weights
from bench.core.spec import reference as load_reference
from bench.reference import compare, counters

FOLD_EVERY = 32  # iterations between foldings of the stats collector
WARM_UID = 1 << 40  # warm-up requests' ids, past any pool's


def _engine_class():
    from repro_torch.serve import ContinuousServeEngine

    class HookedEngine(ContinuousServeEngine):
        """The port's engine with the benchmark's host hooks."""

        def _hooks(self, log):
            self.log = log

        def _prefill_staged(self, i, slot, toks, last):
            t0 = time.perf_counter_ns()
            out = super()._prefill_staged(i, slot, toks, last)
            # (rows, the chunk's first position, whether it ends a prompt)
            self.log["chunks"].append((int(toks.shape[1]), slot.n_prefilled,
                                       bool(last)))
            self.log["spans"].append(("prefill_chunk host", t0,
                                      time.perf_counter_ns()))
            return out

        def _decode_live(self, live, finished, t0, **kw):
            s0 = time.perf_counter_ns()
            ctx = sum(len(self.slots[i].req.prompt)
                      + len(self.slots[i].tokens) for i in live)
            super()._decode_live(live, finished, t0, **kw)
            self.log["decodes"].append((len(live), ctx))
            self.log["spans"].append(("decode_step host and fetch", s0,
                                      time.perf_counter_ns()))

        def _commit(self, idx, slot, tok, finished):
            self.log["commits"].append((slot.req.uid, int(tok)))
            super()._commit(idx, slot, tok, finished)

    return HookedEngine


def _new_log() -> dict:
    return {"chunks": [], "decodes": [], "commits": [], "spans": []}


class Driver:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.model = self.config["model"]
        gen.require(self.traffic, loop="closed", decoding="greedy",
                    token_ids="uniform")
        if self.traffic["start"] not in ("queued", "decoding"):
            raise ValueError(f"unknown start {self.traffic['start']!r}")

    # -------------------------------------------------------------- setup
    def setup(self) -> dict:
        cfg = self.cfg = program.program_config(self.config)
        program.build_kernels(cfg, self.device)
        self.params = weights.make_params(self.model, self.seed, self.device)
        self.calib = gen.calibration_tokens(self.config, self.seed)
        self.plans, compile_s = program.compile_plans(self.params, cfg,
                                                      self.calib)
        e = self.traffic["engine"]
        self.engine = _engine_class()(
            cfg, self.params, plans=self.plans, n_slots=e["n_slots"],
            max_len=e["max_len"], prefill_chunk=e["prefill_chunk"])
        self.sizes = gen.request_sizes(self.traffic, self.seed)
        if self.traffic["warmup"]:
            self._warm_up()
        self._pool = iter(enumerate(self.sizes))
        self.sent, self.finished = {}, []
        for _ in range(self.traffic["clients"]):
            self._send()
        if self.traffic["start"] == "decoding":
            self._start_decoding()
        return {"compile_s": compile_s}

    def _send(self) -> None:
        """A client's next request from the pool, submitted."""
        try:
            uid, (plen, new) = next(self._pool)
        except StopIteration:
            raise RuntimeError("the traffic pool ran dry; make it larger")
        self.sent[uid] = (plen, new)
        self.engine.submit(self._request(uid, plen, new))

    def _start_decoding(self) -> None:
        """Step the closed loop until every admitted session has its
        prompt in the cache (the sessions' own prefill and decode warm the
        window's paths)."""
        eng = self.engine
        eng._hooks(_new_log())
        while eng.queue or any(s is not None and s.state1 is not None
                               for s in eng.slots):
            for o in eng.step():
                self.finished.append(o)
                self._send()
        self._sync()

    def _request(self, uid: int, plen: int, new: int):
        from repro_torch.serve import Request
        return Request(uid=uid, prompt=gen.prompt(
            self.seed, uid, plen, self.model["vocab_size"]),
            max_new_tokens=new)

    def _warm_up(self) -> None:
        """The window's shapes once: every slot admitted with the warm-up
        prompt lengths (one- and two-chunk prompts, a chunk's whole and
        partial rows), then decode steps with every slot live."""
        w = self.traffic["warmup"]
        eng = self.engine
        eng._hooks(_new_log())
        lens = w["prompt_lens"]
        reqs = [self._request(WARM_UID + k, lens[k % len(lens)],
                              w["new_tokens"]) for k in range(eng.n_slots)]
        eng.run(reqs)
        self._sync()

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------- window
    def window(self, seconds: float, tracer) -> dict:
        from repro_torch.serve import ServeStats
        eng = self.engine
        eng.stats = ServeStats()
        log = _new_log()
        eng._hooks(log)
        stamps: dict = {}  # uid -> host clock of each token in the window
        steps, billed = [], []
        launches0 = program.launches()

        with program.stats_sink() as sink, tracer:
            t0 = tracer.host_start_ns = time.perf_counter_ns()
            t_end = t0
            while time.perf_counter_ns() - t0 < seconds * 1e9:
                chunks0, n_commit = len(log["chunks"]), len(log["commits"])
                decodes0 = len(log["decodes"])
                s0 = time.perf_counter_ns()
                outs = eng.step()
                t_end = time.perf_counter_ns()
                for uid, _ in log["commits"][n_commit:]:
                    stamps.setdefault(uid, []).append(t_end)
                new_chunks = len(log["chunks"]) - chunks0
                decoded = len(log["decodes"]) > decodes0
                steps.append((s0, t_end, new_chunks, decoded))
                billed += [(0, 1)] * new_chunks
                if decoded:
                    billed.append((eng.n_slots, eng.n_slots))
                for o in outs:
                    self.finished.append(o)
                    self._send()
                if len(steps) % FOLD_EVERY == 0:
                    program.fold_stats(sink)
            totals = program.stats_totals(sink)
        log["spans"] += [("engine step, outside the model calls", s, e)
                         for s, e, _, _ in steps]
        launches = program.launches()
        return self._record(log, steps, stamps, self.sent, billed, totals,
                            {k: launches[k] - launches0.get(k, 0)
                             for k in launches}, (t_end - t0) / 1e9)

    def _record(self, log, steps, stamps, sent, billed, totals, launches,
                window_s) -> dict:
        n_slots = self.engine.n_slots
        gaps = []
        for ts in stamps.values():
            gaps += [(b - a) / 1e9 for a, b in zip(ts, ts[1:])]
        decode_only = [(e - s) / 1e9 for s, e, c, d in steps if c == 0 and d]
        chunk_ctx = sum(sum(range(lo + 1, lo + c + 1))
                        for c, lo, _ in log["chunks"])
        prefill_rows = sum(c for c, _, _ in log["chunks"])
        prompts_done = sum(last for _, _, last in log["chunks"])
        live_rows = sum(n for n, _ in log["decodes"])
        calls = ([(c, 1) for c, _, _ in log["chunks"]]
                 + [(n_slots, n_slots)] * len(log["decodes"]))
        return {
            "window_s": window_s,
            "iterations": len(steps),
            "tokens": sum(len(ts) for ts in stamps.values()),
            "input_positions": prefill_rows,
            "token_gaps_s": gaps,
            "decode_only_step_s": decode_only,
            "attempted": len(sent),
            "launches": launches,
            "k2_calls": calls,
            "useful": {"layer_rows": prefill_rows + live_rows,
                       "head_rows": prompts_done + live_rows,
                       "attn_context": chunk_ctx + sum(
                           c for _, c in log["decodes"])},
            "billed": billed,
            "pim_totals": totals,
            "spans": log["spans"],
        }

    def release(self) -> None:
        """Free the program's state (engine, caches, plans); the weights
        stay for the reference."""
        self.engine = self.plans = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check
    def sample(self) -> list:
        """The finished requests the check compares: the longest, then
        others in an order drawn from the seed, until ``min_tokens`` served
        tokens are in (or every finished request)."""
        outs = sorted(self.finished, key=lambda o: o.uid)
        if not outs:
            return []
        longest = max(outs, key=lambda o: (o.prompt_len + len(o.tokens),
                                           -o.uid))
        rest = [o for o in outs if o is not longest]
        order = gen.rng(self.seed, gen.SAMPLE).permutation(len(rest))
        picked, n = [longest], len(longest.tokens)
        for i in order:
            if n >= self.traffic["check"]["min_tokens"]:
                break
            picked.append(rest[i])
            n += len(rest[i].tokens)
        return picked

    def served(self, sample) -> tuple[list, list, list]:
        """Each sampled request's sequence (prompt and served tokens but
        the last), the positions whose logits chose its served tokens, and
        those tokens."""
        dev = self.device
        seqs, rows, toks = [], [], []
        for o in sample:
            p = gen.prompt(self.seed, o.uid, o.prompt_len,
                           self.model["vocab_size"])
            t = np.asarray(o.tokens, dtype=np.int64)
            seqs.append(torch.as_tensor(np.concatenate([p, t[:-1]]),
                                        device=dev))
            rows.append(torch.arange(o.prompt_len - 1,
                                     o.prompt_len - 1 + len(t), device=dev))
            toks.append(torch.as_tensor(t, device=dev))
        return seqs, rows, toks

    def failed(self) -> int:
        """Finished requests that broke the request's contract: not
        exactly their ``new_tokens``, or an id outside the vocabulary."""
        V = self.model["vocab_size"]
        bad = 0
        for o in self.finished:
            _, new = self.sizes[o.uid]
            t = np.asarray(o.tokens)
            bad += int(len(t) != new or t.min() < 0 or t.max() >= V)
        return bad

    def check(self, rec: dict, control: bool = False) -> dict:
        """The compared numbers (``top_gap``, ``converts_diff``,
        ``spec_failures``); with ``control``, also the control's
        ``top_gap`` at the same positions (``control_top_gap``)."""
        ref_mod = load_reference(self.config["reference"])
        pim = self.config["pim"]
        sample = self.sample()
        want = counters.expected(self.model, pim, rec["billed"])
        tot = rec["pim_totals"]
        out = {"converts_diff": abs(tot["adc_converts"]
                                    - want["adc_converts"]),
               "spec_failures": tot["spec_failures"],
               "top_gap": None}
        if not sample:
            return out
        seqs, rows, toks = self.served(sample)
        ref = ref_mod.DenseReference(self.model, self.params, self.calib)
        ref_logits = ref.logits(seqs, rows)
        del ref
        out["top_gap"] = compare.widest(
            [compare.top_gaps(r, t) for r, t in zip(ref_logits, toks)])
        out["checked_tokens"] = sum(len(t) for t in toks)
        if control:
            low = ref_mod.DenseReference(self.model, self.params, self.calib,
                                         bits=self.config["control_bits"])
            ctrl = low.logits(seqs, rows)
            out["control_top_gap"] = compare.widest(
                [compare.control_gaps(r, c)
                 for r, c in zip(ref_logits, ctrl)])
        return out
