"""Driver kind ``encode``: back-to-back batches through the port's
full-sequence forward (``repro_torch.models.transformer.forward``) with
the compiled PIM plans, one caller.

Forward i takes batch ``i % pool`` of the mix's token ids (drawn from the
seed, on the device before the window) and ends in a synchronize, as a
caller that reads its logits; the window runs forwards until one would
start past ``seconds``. A reservoir drawn from the seed keeps
``check.batches`` of the window's forwards' logits for the check, which
runs the plain reference over the same token ids and reads ``top_gap`` of
the program's top token at every position; and compares the PIM layer's
counters with what the forwards' heads must bill.
"""

from __future__ import annotations

import gc
import time

import torch

from bench.core import program, traffic as gen, weights
from bench.core.spec import reference as load_reference
from bench.reference import compare, counters


class Driver:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.model = self.config["model"]
        gen.require(self.traffic, token_ids="uniform")

    def setup(self) -> dict:
        cfg = self.cfg = program.program_config(self.config)
        program.build_kernels(cfg, self.device)
        self.params = weights.make_params(self.model, self.seed, self.device)
        self.calib = gen.calibration_tokens(self.config, self.seed)
        self.plans, compile_s = program.compile_plans(self.params, cfg,
                                                      self.calib)
        self.pool = torch.as_tensor(
            gen.batches(self.traffic, self.model["vocab_size"], self.seed),
            device=self.device)
        self._forward(self.pool[0])  # the window's one shape
        return {"compile_s": compile_s}

    def _forward(self, tokens: torch.Tensor) -> torch.Tensor:
        from repro_torch.models import transformer
        with torch.no_grad():
            logits = transformer.forward(self.params, self.cfg, tokens,
                                         self.plans)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        return logits

    def window(self, seconds: float, tracer) -> dict:
        keep = self.traffic["check"]["batches"]
        draw = gen.rng(self.seed, gen.SAMPLE)
        kept: dict = {}
        spans = []
        launches0 = program.launches()
        n = 0
        with program.stats_sink() as sink, tracer:
            t0 = tracer.host_start_ns = time.perf_counter_ns()
            t_end = t0
            while time.perf_counter_ns() - t0 < seconds * 1e9:
                s0 = time.perf_counter_ns()
                logits = self._forward(self.pool[n % len(self.pool)])
                t_end = time.perf_counter_ns()
                spans.append(("forward host and sync", s0, t_end))
                # reservoir sampling of the forwards' logits
                if n < keep:
                    kept[n] = logits
                else:
                    j = int(draw.integers(0, n + 1))
                    if j < keep:
                        kept.pop(sorted(kept)[j])
                        kept[n] = logits
                n += 1
            totals = program.stats_totals(sink)
        self.kept = kept
        launches = program.launches()
        rows = self.traffic["batch"] * self.traffic["seq_len"]
        S = self.traffic["seq_len"]
        ctx = S * S if not self.model["causal"] else S * (S + 1) // 2
        return {
            "window_s": (t_end - t0) / 1e9,
            "iterations": n,
            "tokens": 0,
            "input_positions": n * rows,
            "attempted": n,
            "launches": {k: launches[k] - launches0.get(k, 0)
                         for k in launches},
            "k2_calls": [(rows, rows)] * n,
            "useful": {"layer_rows": n * rows, "head_rows": n * rows,
                       "attn_context": n * self.traffic["batch"] * ctx},
            "billed": [(0, rows)] * n,
            "pim_totals": totals,
            "spans": spans,
        }

    def release(self) -> None:
        self.plans = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def failed(self) -> int:
        """Kept forwards whose logits are not all finite."""
        return sum(int(not torch.isfinite(lg).all()) for lg in
                   self.kept.values())

    def check(self, rec: dict, control: bool = False) -> dict:
        ref_mod = load_reference(self.config["reference"])
        want = counters.expected(self.model, self.config["pim"],
                                 rec["billed"])
        tot = rec["pim_totals"]
        out = {"converts_diff": abs(tot["adc_converts"]
                                    - want["adc_converts"]),
               "spec_failures": tot["spec_failures"],
               "top_gap": None}
        if not self.kept:
            return out
        S = self.traffic["seq_len"]
        every = torch.arange(S, device=self.device)
        seqs, rows, toks = [], [], []
        for i, logits in sorted(self.kept.items()):
            for b in range(logits.shape[0]):
                seqs.append(self.pool[i % len(self.pool), b])
                rows.append(every)
                toks.append(logits[b].float().argmax(dim=-1))
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
