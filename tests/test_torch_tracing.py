"""The port's program spans (``repro_torch.obs.tracing``): the active
recorder, the span tree of the engine, the model and the PIM layer, the
host-sync counter, the clock map onto the profiler's records.

On the CPU with the port alone, at test_torch_obs.py's size (reduced
float32 yi-6b) on the port's own exact compile: one exact-mode
``ContinuousServeEngine.step`` under a recorder gives the span tree below
(parents and nesting of every span; one ``pim.call`` a ``pim_matmul``
through a plan); nothing reads the recorder's clock while no recorder is
installed; greedy tokens are the same with a recorder on and off on both
engines; torch's sync warnings are billed to the innermost open span; the
clock map is exact on injected clocks.
"""

import dataclasses
import itertools
import json
import time
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import pim_compile
from repro_torch.models import transformer as T
from repro_torch.obs import tracing
from repro_torch.obs.serve import ServeTelemetry
from repro_torch.obs.tracing import ENGINE_TID, PROGRAM_TID, Tracer
from repro_torch.serve import ContinuousServeEngine, PagedServeEngine, Request

from _torch_parity import one_thread  # noqa: F401  an autouse fixture

ENGINES = {"continuous": ContinuousServeEngine, "paged": PagedServeEngine}

# one iteration that prefills a whole prompt in one chunk, commits its
# first token and decodes it: every span of the engine, the model and the
# PIM layer, by its path from the root
STEP_TREE = {
    "step", "step/admission", "step/prefill_chunk",
    "step/prefill_chunk/h2d_tokens", "step/prefill_chunk/model.prefill_chunk",
    "step/prefill_chunk/model.prefill_chunk/pim.call",
    "step/prefill_chunk/model.prefill_chunk/pim.call/pim.plan",
    "step/prefill_chunk/model.prefill_chunk/pim.call/pim.tables",
    "step/prefill_chunk/model.prefill_chunk/pim.call/pim.launch",
    "step/fetch", "step/commit", "step/decode_step",
    "step/decode_step/h2d_tokens", "step/decode_step/model.decode_step",
    "step/decode_step/model.decode_step/pim.call",
    "step/decode_step/model.decode_step/pim.call/pim.plan",
    "step/decode_step/model.decode_step/pim.call/pim.tables",
    "step/decode_step/model.decode_step/pim.call/pim.launch",
    "step/decode_step/fetch", "step/decode_step/commit"}


@pytest.fixture(scope="module")
def exact():
    """(cfg, params, plans): reduced yi-6b in exact mode, the port's own
    compile."""
    cfg = dataclasses.replace(
        configs.get("yi-6b").reduced(dtype="float32",
                                     kv_cache_dtype="float32"),
        pim_mode="exact")
    params = T.init_params(cfg, seed=0, device="cpu")
    calib = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    return cfg, params, pim_compile.compile_pim_params(params, cfg,
                                                       calib).plans


def requests(vocab: int, n: int = 3) -> list:
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, vocab, p).astype(np.int32),
                    max_new_tokens=m)
            for i, (p, m) in enumerate([(3, 5), (7, 3), (5, 4)][:n])]


def engine(name, exact, **kw):
    cfg, params, plans = exact
    extra = {"block_size": 4} if name == "paged" else {}
    return ENGINES[name](cfg, params, n_slots=2, max_len=32, prefill_chunk=4,
                         plans=plans, **extra, **kw)


def paths(spans) -> list[str]:
    def path(i):
        out = []
        while i >= 0:
            out.append(spans[i][0])
            i = spans[i][3]
        return "/".join(reversed(out))
    return [path(i) for i in range(len(spans))]


def test_span_tree_of_one_exact_step(exact, monkeypatch):
    """The tree of one iteration; each span inside its parent; one
    ``pim.call`` for each ``pim_matmul`` through a plan, two tables and two
    launches for each (the signed passes)."""
    eng = engine("continuous", exact)
    eng.submit(requests(exact[0].vocab_size, 1)[0])
    calls = []
    inner = L.pim_matmul

    def counted(x, w, plan, cfg):
        if plan is not None:
            calls.append(w.shape)
        return inner(x, w, plan, cfg)
    monkeypatch.setattr(L, "pim_matmul", counted)
    rec = Tracer()
    with tracing.recording(rec):
        eng.step()
    prog = rec.program()
    spans = prog["spans"]
    assert set(paths(spans)) == STEP_TREE
    assert paths(spans)[0] == "step"
    for name, t0, t1, parent, _ in spans:
        assert t0 <= t1
        if parent >= 0:
            assert spans[parent][1] <= t0 and t1 <= spans[parent][2], name
    pim = [s for s in spans if s[0] == "pim.call"]
    assert len(calls) > 0 and len(pim) == len(calls)
    assert [tuple(s[4][1:3]) for s in pim] == [tuple(c) for c in calls]
    assert all(s[4][3] == "exact" for s in pim)
    for child in ("pim.tables", "pim.launch"):
        assert sum(s[0] == child for s in spans) == 2 * len(calls)
    assert prog["counters"].get("host_syncs", 0) == 0  # no CUDA here


def test_paged_engine_inherits_the_engine_spans(exact):
    eng = engine("paged", exact)
    eng.submit(requests(exact[0].vocab_size, 1)[0])
    rec = Tracer()
    with tracing.recording(rec):
        eng.step()
    got = set(paths(rec.program()["spans"]))
    assert {"step", "step/admission", "step/prefill_chunk", "step/fetch",
            "step/commit", "step/decode_step", "step/decode_step/h2d_tokens",
            "step/decode_step/fetch", "step/decode_step/commit",
            "step/decode_step/model.decode_step/pim.call/pim.launch"} <= got


@pytest.mark.parametrize("name", ["continuous", "paged"])
def test_no_recorder_reads_no_clock(exact, name, monkeypatch):
    """With nothing installed, engine steps and a forward run with every
    clock a recorder could read raising; a span site hands back the
    shared null span and allocates nothing more than a call that returns
    it."""
    def boom():
        raise AssertionError("a clock was read")
    idle = Tracer(clock_ns=boom)  # made, never installed
    monkeypatch.setattr(time, "perf_counter_ns", boom)
    assert tracing.ACTIVE is None and tracing.span("step") is \
        tracing.NULL_SPAN
    eng = engine(name, exact)
    outs = eng.run(requests(exact[0].vocab_size))
    assert len(outs) == 3 and idle.program()["spans"] == []
    cfg, params, plans = exact
    T.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int64), plans)
    monkeypatch.undo()
    assert traced_bytes(tracing.span) == \
        traced_bytes(lambda name: tracing.NULL_SPAN)


def traced_bytes(site) -> tuple[int, int]:
    """(kept, peak) bytes that 1,000 spans from ``site`` allocate, after
    two rounds that warm the interpreter's caches."""
    tracemalloc.start()
    try:
        for _ in range(3):
            tracemalloc.reset_peak()
            before = tracemalloc.get_traced_memory()[0]
            for _ in itertools.repeat(None, 1000):
                with site("pim.plan"):
                    pass
            now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return now - before, peak - before


@pytest.mark.parametrize("name", ["continuous", "paged"])
def test_greedy_bit_identical_with_recorder(exact, name):
    vocab = exact[0].vocab_size
    base = engine(name, exact).run(requests(vocab))
    rec = Tracer()
    with tracing.recording(rec):
        outs = engine(name, exact).run(requests(vocab))
    assert [o.uid for o in outs] == [o.uid for o in base]
    for a, b in zip(outs, base):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    spans = rec.program()["spans"]
    assert sum(s[0] == "step" for s in spans) > 3
    assert tracing.ACTIVE is None


def test_host_syncs_billed_to_the_innermost_span():
    """The seam: torch's sync warning, raised inside nested spans, counts
    one ``host_syncs`` billed to the innermost open span (-1 outside any);
    other warnings pass through; the seam ends with the recorder."""
    rec = Tracer()
    with tracing.recording(rec):
        warnings.warn(tracing.SYNC_WARNING, UserWarning)
        with tracing.span("step"):
            with tracing.span("fetch"):
                warnings.warn(tracing.SYNC_WARNING, UserWarning)
                warnings.warn(tracing.SYNC_WARNING, UserWarning)
            with tracing.span("pim.call"):
                with tracing.span("pim.plan"):
                    warnings.warn(tracing.SYNC_WARNING, UserWarning)
                with pytest.warns(RuntimeWarning, match="not a sync"):
                    warnings.warn("not a sync", RuntimeWarning)
    prog = rec.program()
    names = [prog["spans"][i][0] if i >= 0 else None for i in prog["syncs"]]
    assert names == [None, "fetch", "fetch", "pim.plan"]
    assert prog["counters"]["host_syncs"] == 4
    with pytest.warns(UserWarning, match=tracing.SYNC_WARNING):
        warnings.warn(tracing.SYNC_WARNING, UserWarning)
    assert rec.program()["counters"]["host_syncs"] == 4


def test_recording_nests_and_restores():
    """An inner recording of another tracer takes over until it ends; of
    the active one it does nothing; a disabled tracer is never
    installed."""
    outer, inner = Tracer(), Tracer()
    with tracing.recording(outer):
        with tracing.recording(Tracer(enabled=False)):
            assert tracing.ACTIVE is outer
        with tracing.recording(outer):
            assert tracing.ACTIVE is outer
        with tracing.recording(inner):
            with tracing.span("a"):
                pass
        assert tracing.ACTIVE is outer
    assert tracing.ACTIVE is None
    assert [s[0] for s in inner.program()["spans"]] == ["a"]
    assert outer.program()["spans"] == []


@pytest.mark.parametrize("scale", [1.0, 1.0 + 3e-6, 1.0 - 7e-7])
def test_clock_map_on_injected_clocks(scale):
    """Paired readings of two injected clocks: the map onto the other
    clock is exact (to the nanosecond) for ints and int64 arrays, at Unix
    nanoseconds past float64's integers, and a span's stamps convert."""
    host = iter(range(10_000, 10**9, 10_000))
    t_host = [0]

    def host_ns():
        t_host[0] = next(host)
        return t_host[0]

    def other_of(h):
        return 1_792_374_601_257_756_498 + round((h - 5_000) * scale)

    # the other clock is read between two host readings 10 us apart
    clock = tracing.ProfilerClock(host_ns=host_ns,
                                  other=lambda: other_of(t_host[0] + 5_000))
    for _ in range(1000):
        host_ns()
    clock.read()
    m = clock.map()
    (h0, _), (h1, _) = clock.pairs
    for h in (h0, h1, (h0 + h1) // 2, h1 + 123_457):
        assert abs(m(h) - other_of(h)) <= 1
    arr = np.array([h0, h1, 7_777_777], dtype=np.int64)
    got = m(arr)
    assert got.dtype == np.int64
    assert all(abs(int(g) - other_of(int(h))) <= 1
               for g, h in zip(got, arr))
    rec = Tracer(clock_ns=host_ns)
    with tracing.recording(rec):
        with tracing.span("fetch"):
            pass
    (_, t0, t1, _, _), = rec.program()["spans"]
    assert m(t1) - m(t0) == round((t1 - t0) * scale)


def test_profiler_clock_defaults_read():
    """The default readings (torch's approximate clock, converted after
    the last reading) lie near the Unix clock and advance with it."""
    clock = tracing.ProfilerClock()
    time.sleep(0.01)
    clock.read()
    m = clock.map()
    now = m(time.perf_counter_ns())
    assert abs(now - time.time_ns()) < 5e7  # within 50 ms of Unix time
    assert m(clock.pairs[1][0]) > m(clock.pairs[0][0])


def test_telemetry_installs_its_tracer(exact):
    """``ServeTelemetry(tracing=True)`` records the program spans into its
    own tracer for each step; its Chrome trace carries them on their own
    lane after the reference's events, which are unchanged, on the same
    clock: each engine span of the program lane lies inside the engine
    lane's; an outer recorder keeps every span."""
    vocab = exact[0].vocab_size
    tel = ServeTelemetry(engine="t", tracing=True)
    engine("continuous", exact, telemetry=tel).run(requests(vocab))
    prog = tel.tracer.program()
    doc = json.loads(json.dumps(tel.tracer.chrome_trace()))
    events = doc["traceEvents"]
    program = [e for e in events if e.get("cat") == "program"]
    for name in ("admission", "prefill_chunk", "decode_step"):
        lane = [e for e in events if e["name"] == name and e["ph"] == "X"
                and e["tid"] == ENGINE_TID]
        mine = [e for e in program if e["name"] == name]
        assert len(lane) == len(mine) > 0, name
        for a, b in zip(lane, mine):  # (1e-3 us: the sums' rounding)
            assert a["ts"] <= b["ts"] + 1e-3
            assert b["ts"] + b["dur"] <= a["ts"] + a["dur"] + 1e-3
    assert len(program) == len(prog["spans"])
    assert all(e["tid"] == PROGRAM_TID and e["ph"] == "X" for e in program)
    assert {"step", "decode_step", "pim.call", "h2d_tokens", "fetch"} <= {
        e["name"] for e in program}
    call = next(e for e in program if e["name"] == "pim.call")
    assert set(call["args"]) == {"parent", "rows", "R", "C", "mode"}
    assert events[-len(program):] == program
    lanes = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert lanes[PROGRAM_TID] == "program spans"
    outer, tel2 = Tracer(), ServeTelemetry(engine="u", tracing=True)
    with tracing.recording(outer):
        engine("continuous", exact, telemetry=tel2).run(requests(vocab))
    assert tel2.tracer.program()["spans"] == []
    assert sum(s[0] == "step" for s in outer.program()["spans"]) > 3


def test_launcher_trace_out_carries_program_spans(tmp_path, capsys):
    """``--trace-out`` of an exact paged run: the program lane holds every
    engine step with its model and PIM spans (the paged prefill,
    ``prefill_chunk_paged``, has no model span: its calls' parent is the
    engine's ``prefill_chunk``)."""
    from repro_torch.launch import serve as launch
    t = tmp_path / "t.json"
    launch.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                 "--requests", "2", "--steps", "4", "--pim", "exact",
                 "--engine", "paged", "--trace-out", str(t)])
    capsys.readouterr()
    events = json.loads(t.read_text())["traceEvents"]
    program = [e for e in events if e.get("tid") == PROGRAM_TID
               and e["ph"] == "X"]
    names = {e["name"] for e in program}
    assert {"step", "admission", "prefill_chunk", "decode_step", "fetch",
            "commit", "model.decode_step", "pim.call", "pim.plan",
            "pim.tables", "pim.launch"} <= names
    steps = [e for e in program if e["name"] == "step"]
    calls = [e for e in program if e["name"] == "pim.call"]
    assert {e["args"]["parent"] for e in calls} == {"model.decode_step",
                                                    "prefill_chunk"}
    assert len(steps) >= 3 and all(e["args"]["parent"] is None
                                   for e in steps)
