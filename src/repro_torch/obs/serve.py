"""Serve-stack telemetry: request lifecycle metrics, spans, PIM depth.

Port of ``repro.obs.serve``. :class:`ServeTelemetry` is the object the
serve engines thread through their scheduler loops
(``ContinuousServeEngine(..., telemetry=...)``). It owns a
:class:`repro_torch.obs.metrics.MetricsRegistry` and an optional
:class:`repro_torch.obs.tracing.Tracer`, and exposes the small hook
surface the engines call:

- request lifecycle — ``on_submit`` / ``on_admit`` / ``on_token`` /
  ``on_finish`` drive the queue-wait, TTFT, TPOT, and e2e latency
  histograms plus per-request trace lanes;
- scheduler work — ``on_prefill_chunk`` / ``on_decode_step`` /
  ``on_admission_wait`` / ``on_prefix_hits`` / ``on_eviction`` /
  ``on_pool`` mirror the :class:`repro_torch.serve.scheduler.ServeStats`
  counters as live Prometheus series;
- PIM depth — ``on_pim_totals`` accumulates the exact-path work totals
  of each decode step (converts, speculation failures, saturations: the
  counters kernel K2 returns, or K1's ``CrossbarStats`` with speculation
  off), which the engine sums on the device
  (``repro_torch.models.layers.with_pim_stats``), and joins them with
  ``repro_torch.core.energy`` into a live estimated pJ/token gauge (the
  Titanium Law's serve-time face). As in the reference, decode steps
  alone are billed: the prefill's LM head is not.

Timing discipline: every timestamp is taken host-side at points where
the engine already synced (its host fetch of the logits; the decode
step's totals tensor is fetched right after them), so telemetry adds
**no** sync inside a step; greedy outputs are bit-identical with
telemetry on or off (tested). Eviction-by-recompute replays a request
from scratch — its replay re-observes queue-wait/TTFT (each observation
is one *scheduling attempt*), while ``requests_completed`` counts the
request once.

``record_stats`` mirrors ``ServeStats.snapshot()``, whose keys are the
reference's.

Program spans (``repro_torch.obs.tracing``): the reference's three engine
spans (``span``) are also program spans whenever a recorder is installed,
and a tracing telemetry installs its tracer as that recorder for each
engine step (``recording``) unless one is installed already, so its
Chrome trace also carries the engine's, the model's and the PIM layer's
spans on their own lane.

``torch.profiler`` hooks: with ``profile_dir`` set, ``profile()`` wraps
a run in ``torch.profiler.profile`` (CPU activity, and CUDA activity
when the run is on the card) and writes its Chrome trace into
``profile_dir`` on exit; ``annotate_step`` marks each decode/prefill
dispatch with a ``record_function`` range named ``"{name}#{step}"`` so
device profiles line up with scheduler iterations. Both are inert when
``profile_dir`` is ``None``.
"""

from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.core import energy as en
from repro_torch.obs import tracing
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import ENGINE_TID, Tracer

# finer than the generic latency defaults at the fast end: toy-model
# decode steps on CPU land well under a millisecond
STEP_BUCKETS = (1e-5, 5e-5, 1e-4, 5e-4, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

PIM_COUNTER_HELP = {
    "adc_converts": "ADC conversions performed (speculation + recovery)",
    "no_spec_converts": "converts a no-speculation design would need",
    "spec_failures": "failed speculative (column x slice) conversions",
    "spec_attempts": "speculative conversion attempts",
    "recovery_saturations": "accepted fidelity losses (saturated recovery)",
    "cycles": "crossbar cycles consumed",
    "macs": "logical 8b MACs computed",
}


def record_pim_totals(registry: MetricsRegistry, totals: dict,
                      n_tokens: int, adc_bits: int, *,
                      engine: str = "serve") -> dict:
    """Fold one collected-totals dict into PIM counters + derived gauges.

    ``totals`` is a ``repro_torch.models.layers.pim_stats_totals`` dict
    (host values). Returns the derived per-token dict (converts/token, failure
    rate, saturations/token, estimated pJ/token via the §2.5 component
    energies) so callers can report it inline too.
    """
    for k, help_ in PIM_COUNTER_HELP.items():
        registry.counter(f"repro_pim_{k}_total", help_,
                         ("engine",)).inc(int(totals.get(k, 0)),
                                          engine=engine)
    registry.counter("repro_pim_decode_tokens_total",
                     "useful decode tokens the PIM counters cover",
                     ("engine",)).inc(n_tokens, engine=engine)
    c = registry  # re-read accumulated series for the derived gauges
    tok = c.counter("repro_pim_decode_tokens_total", "",
                    ("engine",)).get(engine=engine)
    tot = {k: c.counter(f"repro_pim_{k}_total", "", ("engine",))
           .get(engine=engine) for k in PIM_COUNTER_HELP}
    energy = en.pim_work_energy_pj(tot, adc_bits)
    derived = {
        "adc_converts_per_token": tot["adc_converts"] / max(tok, 1),
        "no_spec_converts_per_token":
            tot["no_spec_converts"] / max(tok, 1),
        "spec_failure_rate":
            tot["spec_failures"] / max(tot["spec_attempts"], 1),
        "saturations_per_token":
            tot["recovery_saturations"] / max(tok, 1),
        "pj_per_token": energy["total_pj"] / max(tok, 1),
        "adc_pj_per_token": energy["e_adc_pj"] / max(tok, 1),
    }
    for k, v in derived.items():
        registry.gauge(f"repro_pim_{k}",
                       f"running per-token {k.replace('_', ' ')} over the "
                       f"collected decode steps",
                       ("engine",)).set(v, engine=engine)
    return derived


class ServeTelemetry:
    """Live telemetry for one serve-engine run. See the module docstring
    for the hook taxonomy; every hook is a no-op on
    :data:`NULL_TELEMETRY` (the engines' default)."""

    enabled = True

    def __init__(self, engine: str = "serve", *,
                 registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None, tracing: bool = False,
                 profile_dir: str | None = None,
                 pim_stats: bool = True):
        self.engine = engine
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None \
            else Tracer(enabled=tracing)
        self.profile_dir = profile_dir
        self.pim_stats = pim_stats
        self.pim_adc_bits: int | None = None
        self._submit_ts: dict[int, float] = {}
        self._restart_ts: dict[int, float] = {}
        self._last_token_ts: dict[int, float] = {}
        self._lab = {"engine": engine}
        r = self.registry
        self._submitted = r.counter(
            "repro_serve_requests_submitted_total",
            "requests entered through submit()", ("engine",))
        self._completed = r.counter(
            "repro_serve_requests_completed_total",
            "requests retired, by finish reason", ("engine", "reason"))
        self._tokens = r.counter(
            "repro_serve_tokens_generated_total",
            "tokens committed (first tokens + decode tokens)", ("engine",))
        self._decode_steps = r.counter(
            "repro_serve_decode_steps_total",
            "batched decode_step dispatches", ("engine",))
        self._slot_tokens = r.counter(
            "repro_serve_decode_slot_tokens_total",
            "useful (non-padding) tokens over all decode steps",
            ("engine",))
        self._prefill_chunks = r.counter(
            "repro_serve_prefill_chunks_total",
            "prefill chunk dispatches", ("engine",))
        self._prefill_tokens = r.counter(
            "repro_serve_prefill_tokens_total",
            "prompt tokens prefilled (recompute included)", ("engine",))
        self._waits = r.counter(
            "repro_serve_admission_waits_total",
            "iterations the queue head waited for pool blocks", ("engine",))
        self._evictions = r.counter(
            "repro_serve_evictions_total",
            "preempt-by-recompute events", ("engine",))
        self._prefix_hits = r.counter(
            "repro_serve_prefix_block_hits_total",
            "shared-prefix KV blocks reused at admission", ("engine",))
        self._blocks = r.gauge(
            "repro_serve_blocks_in_use", "KV pool occupancy (blocks)",
            ("engine",))
        self._peak_blocks = r.gauge(
            "repro_serve_peak_blocks_in_use",
            "max KV pool occupancy seen (blocks)", ("engine",))
        self._queue_wait = r.histogram(
            "repro_serve_queue_wait_seconds",
            "submit (or eviction) to slot admission", ("engine",))
        self._ttft = r.histogram(
            "repro_serve_ttft_seconds",
            "submit (or eviction) to first committed token", ("engine",))
        self._tpot = r.histogram(
            "repro_serve_tpot_seconds",
            "inter-token latency during decode", ("engine",),
            buckets=STEP_BUCKETS)
        self._e2e = r.histogram(
            "repro_serve_e2e_seconds", "submit to request completion",
            ("engine",))
        self._step_time = r.histogram(
            "repro_serve_decode_step_seconds",
            "host wall time of one batched decode step (dispatch + the "
            "iteration's one logits fetch)", ("engine",),
            buckets=STEP_BUCKETS)
        self.tracer.name_track(ENGINE_TID, f"{engine} engine")

    # ------------------------------------------------------------ helpers
    def _now_s(self) -> float:
        return self.tracer.now() / 1e6

    def _req_tid(self, uid: int) -> int:
        return uid + 1

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """The trace span ``name``, also a program span ``name`` on the
        active recorder, if any."""
        with self.tracer.span(name, **args), tracing.span(name):
            yield

    def recording(self):
        """Around one engine step: the tracer installed as the active
        recorder when it traces and no recorder is installed already (an
        outer one keeps every span)."""
        if not self.tracer.enabled or tracing.ACTIVE is not None:
            return tracing.NULL_SPAN
        return tracing.recording(self.tracer)

    # --------------------------------------------------------- lifecycle
    def on_submit(self, uid: int) -> None:
        self._submitted.inc(**self._lab)
        self._submit_ts[uid] = self._now_s()
        self.tracer.name_track(self._req_tid(uid), f"request {uid}")
        self.tracer.instant("submit", tid=self._req_tid(uid), uid=uid)

    def on_admit(self, uid: int, prompt_len: int) -> None:
        now = self._now_s()
        t0 = self._restart_ts.get(uid, self._submit_ts.get(uid, now))
        self._queue_wait.observe(now - t0, **self._lab)
        self.tracer.complete("queue_wait", t0 * 1e6, (now - t0) * 1e6,
                             tid=self._req_tid(uid), uid=uid)
        self.tracer.instant("admit", tid=self._req_tid(uid), uid=uid,
                            prompt_len=prompt_len)

    def on_prefill_chunk(self, uid: int, lo: int, hi: int) -> None:
        self._prefill_chunks.inc(**self._lab)
        self._prefill_tokens.inc(hi - lo, **self._lab)

    def on_prefix_hits(self, uid: int, n_blocks: int) -> None:
        if n_blocks:
            self._prefix_hits.inc(n_blocks, **self._lab)
            self.tracer.instant("prefix_hit", tid=self._req_tid(uid),
                                uid=uid, blocks=n_blocks)

    def on_admission_wait(self, uid: int) -> None:
        self._waits.inc(**self._lab)

    def on_eviction(self, uid: int) -> None:
        self._evictions.inc(**self._lab)
        now = self._now_s()
        self._restart_ts[uid] = now
        self._last_token_ts.pop(uid, None)
        self.tracer.instant("evicted", tid=self._req_tid(uid), uid=uid)

    def on_pool(self, blocks_in_use: int, peak: int) -> None:
        self._blocks.set(blocks_in_use, **self._lab)
        self._peak_blocks.set(peak, **self._lab)

    def on_decode_step(self, n_live: int) -> None:
        self._decode_steps.inc(**self._lab)
        self._slot_tokens.inc(n_live, **self._lab)

    def observe_decode_step_seconds(self, dt: float) -> None:
        self._step_time.observe(dt, **self._lab)

    def on_token(self, uid: int) -> None:
        """One committed token for ``uid`` — first-vs-subsequent decides
        TTFT vs TPOT (host clock; called right after the batched
        host fetch that surfaced the logits)."""
        now = self._now_s()
        self._tokens.inc(**self._lab)
        last = self._last_token_ts.get(uid)
        if last is None:
            t0 = self._restart_ts.get(uid, self._submit_ts.get(uid, now))
            self._ttft.observe(now - t0, **self._lab)
            self.tracer.instant("first_token", tid=self._req_tid(uid),
                                uid=uid)
        else:
            self._tpot.observe(now - last, **self._lab)
        self._last_token_ts[uid] = now

    def on_finish(self, uid: int, reason: str, n_tokens: int) -> None:
        now = self._now_s()
        t0 = self._submit_ts.pop(uid, now)
        self._restart_ts.pop(uid, None)
        self._last_token_ts.pop(uid, None)
        self._completed.inc(engine=self.engine, reason=reason)
        self._e2e.observe(now - t0, **self._lab)
        self.tracer.complete("request", t0 * 1e6, (now - t0) * 1e6,
                             tid=self._req_tid(uid), uid=uid,
                             reason=reason, tokens=n_tokens)

    # --------------------------------------------------------------- pim
    def wants_pim_stats(self, cfg) -> bool:
        """Exact mode is the only path with work counters to collect."""
        return bool(self.pim_stats) and cfg.pim_mode == "exact"

    def on_pim_totals(self, totals: dict, n_tokens: int) -> dict:
        bits = self.pim_adc_bits if self.pim_adc_bits is not None else 8
        return record_pim_totals(self.registry, totals, n_tokens, bits,
                                 engine=self.engine)

    def record_stats(self, stats) -> None:
        """Mirror a final ``ServeStats.snapshot()`` as gauges (one call at
        export time — the per-event counters above track the live run)."""
        for k, v in stats.snapshot().items():
            self.registry.gauge(
                f"repro_serve_stats_{k}",
                f"ServeStats.{k} at export time", ("engine",)).set(
                    float(v), **self._lab)

    # --------------------------------------------------------- profiling
    def annotate_step(self, name: str, step: int):
        """A ``torch.profiler.record_function`` range ``"{name}#{step}"``
        around a dispatch when device profiling is configured; inert
        otherwise."""
        if self.profile_dir is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"{name}#{step}")

    def profile_path(self) -> str | None:
        """Where ``profile()`` writes its Chrome trace (None when off)."""
        if self.profile_dir is None:
            return None
        return os.path.join(self.profile_dir, f"{self.engine}.pt.trace.json")

    @contextlib.contextmanager
    def profile(self, device=None):
        """Wrap a run in ``torch.profiler.profile`` when ``profile_dir`` is
        set (serve ``--profile-dir``) and write its Chrome trace to
        ``profile_path()`` on exit. CPU activity always; CUDA activity when
        ``device`` is a CUDA device (default: when CUDA is available)."""
        if self.profile_dir is None:
            yield
            return
        act = torch.profiler.ProfilerActivity
        cuda = (torch.cuda.is_available() if device is None
                else torch.device(device).type == "cuda")
        activities = [act.CPU] + ([act.CUDA] if cuda else [])
        os.makedirs(self.profile_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(self.profile_path())


class _NullTelemetry(ServeTelemetry):
    """Hook-compatible no-op: every metric write hits the disabled
    registry's shared null metric and every span is a disabled-tracer
    pass-through, so engines call hooks unconditionally."""

    enabled = False

    def __init__(self):
        super().__init__("null", registry=MetricsRegistry(enabled=False),
                         tracer=Tracer(enabled=False), pim_stats=False)

    def on_submit(self, uid):
        pass

    def on_admit(self, uid, prompt_len):
        pass

    def on_token(self, uid):
        pass

    def on_finish(self, uid, reason, n_tokens):
        pass

    def observe_decode_step_seconds(self, dt):
        pass


NULL_TELEMETRY = _NullTelemetry()
