"""The port's telemetry (``repro_torch.obs``) against the reference's
(``repro.obs``), on the CPU with reduced float32 yi-6b
(``_torch_parity.setup``).

Registry, exposition, ``write_metrics`` documents, the Chrome trace and
``record_pim_totals`` equal the reference's with ``==`` for the same
writes. ``ServeStats.snapshot()`` and the pool series equal the
reference's after the same trace. Greedy tokens are the same with
telemetry on and off on both engines, and the live counters equal
``ServeStats``. At the paper's 7b ADC, exact mode on the reference's own
plans (``convert.plans_from_reference``): the ``repro_pim_*_total``
counters equal the port's own ``with_pim_stats`` replay and the
reference's registry. An outer ``collect_pim_stats()`` sees the same
totals with telemetry on and off; ``NULL_TELEMETRY`` opens no sink. The
launcher's ``--metrics-out``, ``--trace-out`` and ``--profile-dir``, and
its refusal of them for the lockstep engine.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.serve import ContinuousServeEngine as RefContinuous
from repro.serve import PagedServeEngine as RefPaged
from repro.serve import Request as RefRequest
from repro_torch import obs
from repro_torch.core import energy as en
from repro_torch.launch import serve as launch
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.serve import NULL_TELEMETRY, STEP_BUCKETS, ServeTelemetry
from repro_torch.obs.tracing import Tracer
from repro_torch.serve import (
    ContinuousServeEngine,
    PagedServeEngine,
    Request,
    ServeStats,
)

from _torch_parity import (  # noqa: F401  one_thread: an autouse fixture
    compiled_pim, one_thread, setup)

ARCH = "yi-6b"
LAB = {"engine": "test"}
ENGINES = {"continuous": (ContinuousServeEngine, RefContinuous),
           "paged": (PagedServeEngine, RefPaged)}


def requests(cls, vocab: int, n: int = 4, seed: int = 0) -> list:
    """test_obs.py's mixed trace, as ``cls`` requests."""
    rng = np.random.default_rng(seed)
    plens, steps = [3, 7, 5, 9][:n], [6, 3, 9, 4][:n]
    return [cls(uid=i, prompt=rng.integers(0, vocab, plens[i]).astype(
        np.int32), max_new_tokens=steps[i]) for i in range(n)]


def engine_kw(name: str) -> dict:
    kw = dict(n_slots=2, max_len=32, prefill_chunk=4)
    if name == "paged":
        kw["block_size"] = 4
    return kw


def counter(reg, name: str, **lab) -> float:
    return reg.counter(name, "", tuple(lab)).get(**lab)


def exact_model(speculation: bool = True):
    """(cfg, params, plans) in exact mode on the port's own compile."""
    _, cfg, _, _, params, _, _ = setup(ARCH)
    return (dataclasses.replace(cfg, pim_mode="exact",
                                pim_speculation=speculation),
            params, compiled_pim(ARCH, "exact")[1].plans)


# ------------------------------------------------------------- registry
def writes_golden(r) -> None:
    """test_obs.py's golden exposition writes."""
    r.counter("req_total", "requests served", ("engine",)).inc(
        3, engine="paged")
    r.gauge("pool_frac", "pool occupancy").set(0.25)
    h = r.histogram("lat_seconds", "latency", ("engine",),
                    buckets=(0.5, 1.0))
    h.observe(0.2, engine="paged")
    h.observe(2.0, engine="paged")


def writes_escaping(r) -> None:
    """Label values that need escaping; a default-bucket histogram."""
    r.counter("c_total", "c", ("k",)).inc(1, k='a"b\n')
    r.counter("c_total", "c", ("k",)).inc(2.5, k="back\\slash")
    r.histogram("h_seconds", "h").observe(0.01)
    r.histogram("h_seconds", "h").observe(100.0)


def writes_mixed(r) -> None:
    """Several series per metric, gauge inc/dec, integral and fractional
    values, the serve step buckets."""
    c = r.counter("done_total", "retired", ("engine", "reason"))
    for eng, reason, v in (("b", "stop", 1), ("a", "length", 4),
                           ("a", "stop", 2), ("b", "stop", 3)):
        c.inc(v, engine=eng, reason=reason)
    g = r.gauge("blocks", "pool", ("engine",))
    g.set(7, engine="a")
    g.inc(-3, engine="a")
    g.inc(1.5, engine="b")
    h = r.histogram("step_seconds", "step", ("engine",),
                    buckets=STEP_BUCKETS)
    for v in (1e-5, 3e-4, 0.0025, 0.7, 1e3):
        h.observe(v, engine="a")


@pytest.mark.parametrize("writes", [writes_golden, writes_escaping,
                                    writes_mixed])
def test_registry_and_exports_equal_reference(writes, tmp_path):
    """The same writes to both registries: exposition, snapshot and the
    ``write_metrics`` document equal with ``==``."""
    mine, ref = MetricsRegistry(), ref_obs.MetricsRegistry()
    writes(mine)
    writes(ref)
    assert obs.to_prometheus(mine) == ref_obs.to_prometheus(ref)
    assert obs.snapshot(mine) == ref_obs.snapshot(ref)
    assert mine.snapshot() == json.loads(json.dumps(ref.snapshot()))
    a = obs.write_metrics(mine, str(tmp_path / "a.json"), config={"x": 1})
    b = ref_obs.write_metrics(ref, str(tmp_path / "b.json"), config={"x": 1})
    assert a == b
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    if writes is writes_golden:  # test_obs.py's golden text, in the port
        assert obs.to_prometheus(mine).startswith(
            "# HELP lat_seconds latency\n# TYPE lat_seconds histogram\n"
            'lat_seconds_bucket{engine="paged",le="0.5"} 1\n')


def test_histogram_bucket_math_and_label_guards():
    """test_obs.py's bucket math and guards on the port's registry."""
    r = MetricsRegistry()
    h = r.histogram("h_seconds", "test", buckets=(1.0, 2.0, 5.0))
    for v in (0.5, 1.0, 3.0, 10.0):
        h.observe(v)
    s = h.get()
    assert s["counts"] == [2, 2, 3, 4] and s["count"] == 4
    assert s["sum"] == pytest.approx(14.5)
    c = r.counter("req_total", "requests", ("engine",))
    c.inc(engine="paged")
    c.inc(2, engine="continuous")
    assert (c.get(engine="paged"), c.get(engine="continuous"),
            c.get(engine="other")) == (1, 2, 0.0)
    with pytest.raises(ValueError):
        c.inc(-1, engine="paged")
    with pytest.raises(ValueError):
        c.inc(engine="paged", extra="x")
    g = r.gauge("blocks", "pool")
    g.set(7)
    g.inc(-3)
    assert g.get() == 4
    assert r.counter("req_total", "requests", ("engine",)) is c
    for bad in (lambda: r.gauge("req_total", "requests", ("engine",)),
                lambda: r.counter("req_total", "x", ("engine", "reason")),
                lambda: r.histogram("h", buckets=(1.0, 1.0))):
        with pytest.raises(ValueError):
            bad()
    off = MetricsRegistry(enabled=False)
    off.counter("x_total", "x", ("engine",)).inc(5, engine="paged")
    off.histogram("h_seconds").observe(0.1)
    assert off.counter("x_total").get(engine="paged") == 0.0
    assert off.snapshot() == {} and obs.to_prometheus(off) == "\n"


def trace_calls(tr) -> None:
    tr.name_track(0, "engine")
    tr.name_track(3, "request 2")
    with tr.span("decode_step", n_live=2):
        tr.instant("first_token", tid=3, uid=2)
    tr.complete("queue_wait", 5.0, 12.5, tid=3, uid=2)
    tr.complete("request", 1.0, -4.0, tid=3, uid=2, reason="length")
    tr.name_track(0, "renamed")       # the first name sticks
    with tr.span("admission"):
        pass


def test_tracer_equals_reference(tmp_path):
    """The same calls on both tracers, each on its own ticking clock: the
    same document (names, phases, tids, args, and here the timestamps
    too); a disabled tracer records nothing."""
    def clock():
        t = [0.0]

        def tick():
            t[0] += 10.0
            return t[0]
        return tick
    mine, ref = Tracer(clock_us=clock()), ref_obs.Tracer(clock_us=clock())
    trace_calls(mine)
    trace_calls(ref)
    assert mine.chrome_trace() == ref.chrome_trace()
    mine.write(str(tmp_path / "a.json"))
    ref.write(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    off = Tracer(enabled=False)
    trace_calls(off)
    assert off.events() == [] and off.chrome_trace()["traceEvents"] == []


TOTALS = (
    {"adc_converts": 100, "no_spec_converts": 400, "spec_failures": 5,
     "spec_attempts": 100, "recovery_saturations": 2, "cycles": 64,
     "macs": 4096},
    {"adc_converts": 123457, "no_spec_converts": 1 << 40,
     "spec_failures": 0, "spec_attempts": 77, "macs": 3},  # cycles absent
)


@pytest.mark.parametrize("adc_bits", [7, 8, 24])
def test_record_pim_totals_equals_reference(adc_bits):
    """Each totals dict folded twice into both registries: the derived
    dicts, the exposition and the snapshot equal with ``==``."""
    mine, ref = MetricsRegistry(), ref_obs.MetricsRegistry()
    for tot in TOTALS:
        for n_tok in (4, 3):
            d = obs.record_pim_totals(mine, tot, n_tok, adc_bits,
                                      engine="e")
            dr = ref_obs.record_pim_totals(ref, tot, n_tok, adc_bits,
                                           engine="e")
            assert d == dr
    assert obs.to_prometheus(mine) == ref_obs.to_prometheus(ref)
    assert mine.snapshot() == ref.snapshot()
    acc = {k: 2 * sum(t.get(k, 0) for t in TOTALS)
           for k in L.PIM_STAT_KEYS}
    assert d["pj_per_token"] == en.pim_work_energy_pj(
        acc, adc_bits)["total_pj"] / 14


# ------------------------------------------------------------ engines
def ref_model():
    rcfg, _, rparams, _, _, _, _ = setup(ARCH)
    return rcfg, rparams


@pytest.mark.parametrize("name", ["continuous", "paged"])
def test_snapshot_parity_with_reference(name):
    """After the same trace in ``off`` mode: the port's snapshot keys are
    the reference's, every value equal; ``record_stats`` mirrors every
    key."""
    cls, ref_cls = ENGINES[name]
    _, cfg, _, _, params, _, _ = setup(ARCH)
    rcfg, rparams = ref_model()
    eng = cls(cfg, params, **engine_kw(name))
    ref = ref_cls(rcfg, rparams, **engine_kw(name))
    eng.run(requests(Request, cfg.vocab_size))
    ref.run(requests(RefRequest, cfg.vocab_size))
    mine, theirs = eng.stats.snapshot(), ref.stats.snapshot()
    assert type(eng.stats) is ServeStats
    assert set(mine) == set(theirs)
    assert mine == theirs
    tel = ServeTelemetry(engine=name)
    tel.record_stats(eng.stats)
    snap = obs.snapshot(tel.registry)
    assert {f"repro_serve_stats_{k}" for k in mine} == {
        m for m in snap if m.startswith("repro_serve_stats_")}


@pytest.mark.parametrize("name", ["continuous", "paged"])
def test_greedy_bit_identical_with_telemetry(name):
    """test_obs.py's contract on the port: tokens equal with telemetry
    (metrics and tracing) on and off; the live counters equal
    ``ServeStats``; TTFT, e2e and queue-wait observed once a request, TPOT
    once a decode token; the trace has a lane per request."""
    cls, _ = ENGINES[name]
    _, cfg, _, _, params, _, _ = setup(ARCH)
    base = cls(cfg, params, **engine_kw(name)).run(
        requests(Request, cfg.vocab_size))
    tel = ServeTelemetry(engine="test", tracing=True)
    eng = cls(cfg, params, telemetry=tel, **engine_kw(name))
    outs = eng.run(requests(Request, cfg.vocab_size))
    assert [o.uid for o in outs] == [o.uid for o in base]
    for a, b in zip(outs, base):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    r, st = tel.registry, eng.stats
    assert counter(r, "repro_serve_decode_steps_total",
                   **LAB) == st.decode_steps
    assert counter(r, "repro_serve_decode_slot_tokens_total",
                   **LAB) == st.decode_slot_tokens
    assert counter(r, "repro_serve_prefill_chunks_total",
                   **LAB) == st.prefill_chunks
    n_tok = sum(len(o.tokens) for o in outs)
    assert counter(r, "repro_serve_tokens_generated_total", **LAB) == n_tok
    done = r.counter("repro_serve_requests_completed_total", "",
                     ("engine", "reason"))
    assert sum(v for _, v in done.series()) == len(outs) == st.completed
    for h in ("repro_serve_ttft_seconds", "repro_serve_e2e_seconds",
              "repro_serve_queue_wait_seconds"):
        assert r.histogram(h, "", ("engine",)).get(
            **LAB)["count"] == len(outs)
    for h in ("repro_serve_tpot_seconds", "repro_serve_decode_step_seconds"):
        want = n_tok - len(outs) if "tpot" in h else st.decode_steps
        assert r.histogram(h, "", ("engine",), buckets=STEP_BUCKETS).get(
            **LAB)["count"] == want
    assert not any(m.startswith("repro_pim_") for m in r.snapshot())
    doc = json.loads(json.dumps(tel.tracer.chrome_trace()))
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"admission", "decode_step", "prefill_chunk", "queue_wait",
            "request", "first_token", "submit"} <= names
    req = [e for e in doc["traceEvents"] if e["name"] == "request"]
    assert sorted(e["args"]["uid"] for e in req) == [o.uid for o in outs]
    assert all(e["tid"] == e["args"]["uid"] + 1 for e in req)


def pressure_trace(which: str, vocab: int):
    """(engine kwargs, [(prompt, max_new_tokens)]): test_obs.py's tight
    pool (8 blocks of 4, three 9-token prompts of 8 new tokens), or
    test_torch_paged.py's decisions trace (6 blocks of 4, a shared
    8-token system prompt), which also evicts and hits the prefix."""
    if which == "tight":
        prompts = np.random.default_rng(3).integers(
            0, vocab, (3, 9)).astype(np.int32)
        return (dict(n_slots=3, max_len=32, prefill_chunk=4, block_size=4,
                     n_blocks=8), [(p, 8) for p in prompts])
    rng = np.random.default_rng(7)
    sys_prompt = rng.integers(0, vocab, 8).astype(np.int32)
    spec = [(sys_prompt, 2, 6), (sys_prompt, 3, 5), (None, 5, 6),
            (sys_prompt, 1, 4), (None, 6, 3)]
    return (dict(n_slots=3, max_len=16, prefill_chunk=4, block_size=4,
                 n_blocks=6),
            [(np.concatenate([p if p is not None else [],
                              rng.integers(0, vocab, x)]).astype(np.int32),
              n) for p, x, n in spec])


@pytest.mark.parametrize("which", ["tight", "prefix"])
def test_paged_pool_metrics_equal_reference(which):
    """Under pool pressure the port's wait, eviction, prefix-hit, peak and
    occupancy series equal the reference's registry values and
    ``ServeStats``, and its tokens equal the run without telemetry."""
    _, cfg, _, _, params, _, _ = setup(ARCH)
    rcfg, rparams = ref_model()
    kw, trace = pressure_trace(which, cfg.vocab_size)

    def reqs(cls):
        return [cls(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(trace)]
    base = PagedServeEngine(cfg, params, **kw).run(reqs(Request))
    tel = ServeTelemetry(engine="paged")
    eng = PagedServeEngine(cfg, params, telemetry=tel, **kw)
    outs = eng.run(reqs(Request))
    for a, b in zip(outs, base):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    rtel = ref_obs.ServeTelemetry(engine="paged")
    RefPaged(rcfg, rparams, telemetry=rtel, **kw).run(reqs(RefRequest))
    st, lab = eng.stats, {"engine": "paged"}
    assert st.admission_waits > 0
    if which == "prefix":
        assert st.evictions > 0 and st.prefix_block_hits > 0
    series = (("counter", "repro_serve_admission_waits_total",
               st.admission_waits),
              ("counter", "repro_serve_evictions_total", st.evictions),
              ("counter", "repro_serve_prefix_block_hits_total",
               st.prefix_block_hits),
              ("gauge", "repro_serve_peak_blocks_in_use",
               st.peak_blocks_in_use),
              ("gauge", "repro_serve_blocks_in_use", 0))
    for kind, name, want in series:
        got = getattr(tel.registry, kind)(name, "", ("engine",)).get(**lab)
        ref = getattr(rtel.registry, kind)(name, "", ("engine",)).get(**lab)
        assert got == ref == want, name
    for h in ("repro_serve_queue_wait_seconds", "repro_serve_ttft_seconds"):
        assert tel.registry.histogram(h, "", ("engine",)).get(
            **lab)["count"] == rtel.registry.histogram(
                h, "", ("engine",)).get(**lab)["count"]


# ----------------------------------------------------------- pim depth
def test_device_totals_equal_host_sums():
    """``pim_stats_device_totals`` of SpeculationStats and CrossbarStats
    (and of earlier totals) equals a plain Python sum of the fields;
    ``with_pim_stats`` re-records its totals into the enclosing sink."""
    from repro_torch.core.crossbar import CrossbarStats
    from repro_torch.core.speculation import SpeculationStats
    i64 = torch.int64
    spec = [SpeculationStats(
        adc_converts=torch.tensor(10 + k, dtype=i64), no_spec_converts=40,
        spec_failures=torch.tensor(k, dtype=i64), spec_attempts=9,
        recovery_saturations=torch.tensor(k % 2, dtype=i64), cycles=11,
        macs=100) for k in range(5)]
    xbar = CrossbarStats(adc_converts=7, saturations=torch.tensor(3),
                         conversions_possible=8, macs=6)
    want = {"adc_converts": 60 + 7, "no_spec_converts": 200 + 8,
            "spec_failures": 10, "spec_attempts": 45,
            "recovery_saturations": 2, "cycles": 55, "macs": 506}
    dev = L.pim_stats_device_totals(spec + [xbar])
    assert dev.counts.dtype == i64 and dev.counts.shape == (3,)
    assert dev.host() == L.pim_stats_totals(spec + [xbar]) == want
    assert L.pim_stats_totals([dev, dev]) == {k: 2 * v
                                              for k, v in want.items()}
    assert L.pim_stats_device_totals([xbar]).counts is None

    def body():
        L.pim_stats_record(spec[0])
        return "out"
    with L.collect_pim_stats() as outer:
        out, tot = L.with_pim_stats(body)()
    assert out == "out" and outer == [tot]
    assert tot.host() == L.pim_stats_totals(spec[:1])
    assert not L.pim_stats_active()


def ref_exact7(rcfg):
    """The reference's exact compile and its 7b config, speculation on."""
    rc = dataclasses.replace(rcfg, pim_mode="exact", pim_speculation=True,
                             pim_adc_bits=7)
    return rc, compiled_pim(ARCH, "exact")[0].plans


def test_serve_pim_counters_at_7b_adc():
    """Exact mode with speculation at the 7b ADC on the reference's own
    plans: every ``repro_pim_*_total`` counter equals the port's
    ``with_pim_stats`` replay of the same decode steps, the pJ/token
    gauge equals the energy model on those totals, and the counters, the
    decode-token count and the tokens equal the reference's registry and
    output with ``==``."""
    rcfg, rparams = ref_model()
    rc, rplans = ref_exact7(rcfg)
    _, cfg, _, _, params, _, _ = setup(ARCH)
    cfg = dataclasses.replace(cfg, pim_mode="exact", pim_speculation=True,
                              pim_adc_bits=7)
    plans = convert.plans_from_reference(
        jax.tree.map(np.asarray, rplans), cfg, "cpu")
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, 4).astype(np.int32)
    steps, max_len = 5, 16
    tel = ServeTelemetry(engine="serve")
    eng = ContinuousServeEngine(cfg, params, n_slots=1, max_len=max_len,
                                plans=plans, telemetry=tel)
    assert tel.wants_pim_stats(cfg) and eng._collect_pim
    outs = eng.run([Request(uid=0, prompt=prompt, max_new_tokens=steps)])

    step = L.with_pim_stats(lambda st, tok: T.decode_step(
        params, cfg, st, tok, plans=plans))
    want = dict.fromkeys(L.PIM_STAT_KEYS, 0)
    with torch.no_grad():
        logits, state = T.prefill(params, cfg,
                                  torch.as_tensor(prompt[None]).long(),
                                  max_len=max_len, plans=plans)
        replay = [int(logits[0, -1].argmax())]
        for _ in range(steps - 1):
            logits, state, tot = step(
                state, torch.tensor([[replay[-1]]], dtype=torch.int64))
            replay.append(int(logits[0, -1].argmax()))
            for k, v in tot.host().items():
                want[k] += v
    np.testing.assert_array_equal(replay, outs[0].tokens)
    r, lab = tel.registry, {"engine": "serve"}
    got = {k: counter(r, f"repro_pim_{k}_total", **lab)
           for k in L.PIM_STAT_KEYS}
    assert got == want
    assert want["spec_failures"] > 0
    n_tok = counter(r, "repro_pim_decode_tokens_total", **lab)
    assert n_tok == steps - 1
    assert r.gauge("repro_pim_pj_per_token", "", ("engine",)).get(
        **lab) == en.pim_work_energy_pj(want, 7)["total_pj"] / n_tok

    rtel = ref_obs.ServeTelemetry(engine="serve")
    ref = RefContinuous(rc, rparams, n_slots=1, max_len=max_len,
                        plans=rplans, telemetry=rtel)
    routs = ref.run([RefRequest(uid=0, prompt=prompt, max_new_tokens=steps)])
    np.testing.assert_array_equal(routs[0].tokens, outs[0].tokens)
    theirs = {k: counter(rtel.registry, f"repro_pim_{k}_total", **lab)
              for k in L.PIM_STAT_KEYS}
    assert got == theirs
    assert counter(rtel.registry, "repro_pim_decode_tokens_total",
                   **lab) == n_tok


@pytest.mark.parametrize("name,speculation", [
    ("continuous", True), ("paged", True), ("continuous", False)])
def test_outer_sink_same_with_telemetry(name, speculation):
    """An outer ``collect_pim_stats()`` around ``eng.run`` sees the same
    totals with telemetry on and off, through K2 (speculation) and K1's
    ``CrossbarStats`` (speculation off); the telemetry bills the decode
    steps alone."""
    cls, _ = ENGINES[name]
    cfg, params, plans = exact_model(speculation=speculation)
    reqs = requests(Request, cfg.vocab_size, n=2)
    sums, tokens = [], []
    for tel in (None, ServeTelemetry(engine="test")):
        eng = cls(cfg, params, plans=plans, telemetry=tel,
                  **engine_kw(name))
        with L.collect_pim_stats() as sink:
            outs = eng.run(reqs)
        sums.append(L.pim_stats_totals(sink))
        tokens.append([o.tokens.tolist() for o in outs])
    assert sums[0] == sums[1] and tokens[0] == tokens[1]
    billed = {k: counter(tel.registry, f"repro_pim_{k}_total", **LAB)
              for k in L.PIM_STAT_KEYS}
    # the outer sink also holds each prompt's prefill LM head
    assert 0 < billed["macs"] < sums[0]["macs"]
    assert counter(tel.registry, "repro_pim_decode_tokens_total",
                   **LAB) == eng.stats.decode_slot_tokens
    assert (billed["spec_attempts"] > 0) == speculation


@pytest.mark.parametrize("name", ["continuous", "paged"])
def test_dropped_engine_frees_its_state_without_the_collector(name):
    """An exact-mode engine with telemetry, after a run, holds no
    reference cycle: dropping it frees its caches at once (with the
    cyclic collector off), as a caller that serves model after model on
    one card needs."""
    import gc
    import weakref
    cls, _ = ENGINES[name]
    cfg, params, plans = exact_model()
    gc.collect()
    gc.disable()
    try:
        eng = cls(cfg, params, plans=plans,
                  telemetry=ServeTelemetry(engine="test", tracing=True),
                  **engine_kw(name))
        eng.run(requests(Request, cfg.vocab_size, n=2))
        cache = weakref.ref(next(iter(eng.state["caches"][0].values())))
        del eng
        assert cache() is None
    finally:
        gc.enable()


def test_null_telemetry_collects_nothing_and_opens_no_sink(monkeypatch):
    """``NULL_TELEMETRY``'s hooks record nothing, it never asks for PIM
    stats, and an exact-mode engine on it runs its decode steps with no
    sink open."""
    assert not NULL_TELEMETRY.enabled
    NULL_TELEMETRY.on_submit(0)
    NULL_TELEMETRY.on_token(0)
    NULL_TELEMETRY.on_pim_totals({"adc_converts": 5}, 1)
    with NULL_TELEMETRY.span("x"):
        pass
    assert NULL_TELEMETRY.registry.snapshot() == {}
    assert NULL_TELEMETRY.tracer.events() == []
    cfg, params, plans = exact_model()
    assert not NULL_TELEMETRY.wants_pim_stats(cfg)
    assert not ServeTelemetry(pim_stats=False).wants_pim_stats(cfg)
    seen = []
    decode = T.decode_step

    def spy(*args, **kw):
        seen.append(L.pim_stats_active())
        return decode(*args, **kw)
    monkeypatch.setattr(T, "decode_step", spy)
    eng = ContinuousServeEngine(cfg, params, plans=plans, **engine_kw(
        "continuous"))
    assert eng.tel is NULL_TELEMETRY and not eng._collect_pim
    eng.run(requests(Request, cfg.vocab_size, n=1))
    assert seen and not any(seen)


def test_fast_mode_collects_lifecycle_only():
    """``fast`` mode (K3): lifecycle counters as in the other modes, no
    PIM counters, tokens equal with telemetry on and off."""
    _, cfg, _, _, params, _, _ = setup(ARCH)
    cfg = dataclasses.replace(cfg, pim_mode="fast")
    plans = compiled_pim(ARCH, "fast")[1].plans
    reqs = requests(Request, cfg.vocab_size, n=2)
    base = ContinuousServeEngine(cfg, params, plans=plans,
                                 **engine_kw("continuous")).run(reqs)
    tel = ServeTelemetry(engine="test")
    eng = ContinuousServeEngine(cfg, params, plans=plans, telemetry=tel,
                                **engine_kw("continuous"))
    outs = eng.run(reqs)
    assert [o.tokens.tolist() for o in outs] == [o.tokens.tolist()
                                                for o in base]
    assert not eng._collect_pim
    snap = tel.registry.snapshot()
    assert not any(m.startswith("repro_pim_") for m in snap)
    assert counter(tel.registry, "repro_serve_decode_steps_total",
                   **LAB) == eng.stats.decode_steps > 0


# ------------------------------------------------------------ launcher
LAUNCH = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "2",
          "--steps", "4"]


def test_launcher_metrics_and_trace_on_cpu(tmp_path, capsys):
    """``--pim exact --engine paged --metrics-out --trace-out``: both
    files load; the metrics carry the PIM counters and every
    ``repro_serve_stats_*`` gauge, the trace a lane per request."""
    m, t = tmp_path / "m.json", tmp_path / "t.json"
    launch.main(LAUNCH + ["--pim", "exact", "--engine", "paged",
                          "--metrics-out", str(m), "--trace-out", str(t)])
    assert "metrics snapshot ->" in capsys.readouterr().out
    doc = json.loads(m.read_text())
    snap = doc["metrics"]
    assert snap["repro_pim_adc_converts_total"]["series"][0]["value"] > 0
    assert {f"repro_serve_stats_{k}" for k in doc["stats"]} <= set(snap)
    assert doc["config"]["pim_mode"] == "exact"
    assert doc["prometheus"].startswith("# HELP")
    trace = json.loads(t.read_text())
    lanes = {e["tid"] for e in trace["traceEvents"] if e["name"] == "request"}
    assert lanes == {1, 2}


def test_launcher_profile_dir_on_cpu(tmp_path, capsys):
    """``--profile-dir`` writes a ``torch.profiler`` Chrome trace with CPU
    activity only, its decode steps named by ``annotate_step``."""
    d = tmp_path / "prof"
    launch.main(LAUNCH + ["--engine", "continuous", "--requests", "1",
                          "--steps", "2", "--profile-dir", str(d)])
    assert "torch profiler trace ->" in capsys.readouterr().out
    (path,) = d.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "decode_step#0" in names and "prefill_chunk#0" in names
    assert not any(e.get("cat") in ("kernel", "gpu_memcpy") for e in events)


@pytest.mark.parametrize("flag", ["--metrics-out", "--trace-out",
                                  "--profile-dir"])
def test_launcher_refuses_telemetry_for_lockstep(flag, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        launch.main(LAUNCH + ["--engine", "lockstep", flag,
                              str(tmp_path / "x")])
    assert exc.value.code != 0
    assert ("the lockstep reference engine has no request lifecycle to "
            "trace") in capsys.readouterr().err
    assert not (tmp_path / "x").exists()
