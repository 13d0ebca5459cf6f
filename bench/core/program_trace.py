"""The traced window with the port's span recorder: device idle time named
by the program's own spans, on the device records' clock.

``ProgramTracer`` is ``trace.Tracer`` with the port's recorder
(``repro_torch.obs.tracing``) installed over the window, and paired
readings of the host clock and the profiler's record clock taken right
after the profiler starts and right before it stops; ``recorded`` is the
record's ``program`` entry (the spans, counters and syncs, and the two
clock pairs). ``summary`` is ``trace.summary`` handed every host span, the
harness's and the program's, put on the device clock through the pairs
rather than through the window's first device record, so that each idle
gap is named by the innermost span holding it; it adds the idle time by
innermost program span (``idle_by_span``, piecewise, not by a gap's
midpoint). ``copy_checks`` and ``copy_places`` hold the map to the copies
that the spans issue. The readers below take a record with ``program``
and that summary as ``trace`` and return None without them.

A window records nothing of this unless its caller passes a
``ProgramTracer``; ``tools/trace_cell.py`` runs one cell so.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from bench.core import trace

# engine spans outside the model calls (``idle_engine_host``)
ENGINE_SPANS = ("step", "admission", "h2d_tokens", "fetch", "commit")
NO_SPAN = "no program span"
DTOH, HTOD = re.compile(r"Memcpy DtoH"), re.compile(r"Memcpy HtoD")


class ProgramTracer(trace.Tracer):
    """``trace.Tracer`` that also records the program's spans over the
    window (``recorder=False``: only the clock pairs)."""

    def __init__(self, on: bool, recorder: bool = True, host_ns=None):
        super().__init__(on)
        self.with_recorder = recorder
        self.host_ns = host_ns  # the recorder's clock (default its own)
        self.recorder = None
        self._clock = self._recording = None

    def __enter__(self):
        super().__enter__()
        if self.on:
            from repro_torch.obs import tracing
            self._clock = tracing.ProfilerClock(host_ns=self.host_ns)
            if self.with_recorder:
                self.recorder = tracing.Tracer(clock_ns=self.host_ns)
                self._recording = tracing.recording(self.recorder)
                self._recording.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            torch.cuda.synchronize()
            if self._recording is not None:
                self._recording.__exit__(*exc)
            self._clock.read()
        return super().__exit__(*exc)

    def recorded(self) -> dict | None:
        """The record's ``program``: the recorder's export (empty without
        a recorder) and ``clock``, the pairs mapped to Unix nanoseconds."""
        if self._clock is None:
            return None
        m = self._clock.map()
        pairs = [[h, m(h)] for h, _ in (self._clock.pairs[0],
                                        self._clock.pairs[-1])]
        out = (self.recorder.program() if self.recorder is not None
               else {"spans": [], "counters": {}, "syncs": []})
        out["clock"] = pairs
        return out


def clock_map(program: dict):
    """The map of the recorder's clock onto the records' through the two
    clock pairs: a line, which the records' clock leaves by up to
    milliseconds for seconds at a time within a window on an H100."""
    from repro_torch.obs.tracing import ClockMap
    return ClockMap(*[tuple(p) for p in program["clock"]])


def self_segments(spans: list) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts, ends, owner) of the intervals in which each span is the
    innermost open one (its time less its children's), sorted; ``spans``
    in start order with parent indices, as the recorder keeps them.
    Between top-level spans nothing is recorded."""
    kids: list[list[int]] = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s[3] >= 0:
            kids[s[3]].append(i)
    seg = []
    for i, (_, t0, t1, _, _) in enumerate(spans):
        cur = t0
        for k in kids[i]:
            if spans[k][1] > cur:
                seg.append((cur, spans[k][1], i))
            cur = max(cur, spans[k][2])
        if t1 > cur:
            seg.append((cur, t1, i))
    a = np.array(sorted(seg), dtype=np.int64).reshape(-1, 3)
    return a[:, 0], a[:, 1], a[:, 2]


def idle_intervals(busy: list, w0: int, w1: int) -> list[tuple[int, int]]:
    """The complement of the merged ``busy`` intervals within [w0, w1]."""
    out, cur = [], w0
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, w1)))
        cur = max(cur, e)
        if cur >= w1:
            break
    if cur < w1:
        out.append((cur, w1))
    return [iv for iv in out if iv[1] > iv[0]]


def idle_by_owner(idle: list, starts, ends, owner) -> dict[int, int]:
    """Nanoseconds of ``idle`` spent in each owner's segments (-1: in none
    of them)."""
    out: dict[int, int] = {}
    starts, ends, owner = starts.tolist(), ends.tolist(), owner.tolist()
    j, n = 0, len(starts)
    for a, b in idle:
        covered = 0
        while j < n and ends[j] <= a:
            j += 1
        k = j
        while k < n and starts[k] < b:
            lo, hi = max(a, starts[k]), min(b, ends[k])
            if hi > lo:
                out[owner[k]] = out.get(owner[k], 0) + hi - lo
                covered += hi - lo
            k += 1
        if b - a > covered:
            out[-1] = out.get(-1, 0) + (b - a) - covered
    return out


def mapped_spans(program: dict) -> list:
    """The program's spans ``[name, start, end, parent, args]`` on the
    device clock."""
    spans = program["spans"]
    if not spans:
        return []
    m = clock_map(program)
    t = m(np.array([[s[1], s[2]] for s in spans], dtype=np.int64))
    return [[s[0], int(a), int(b), s[3], s[4]] for s, (a, b) in zip(spans, t)]


def summary(tracer, spans: list, program: dict | None, window_s: float,
            top: int = 10) -> dict | None:
    """``trace.summary`` of the window on the shared clock, plus
    ``idle_by_span`` (idle seconds by innermost program span, ``NO_SPAN``
    outside them), ``syncs_by_span`` and ``old_offset_error_us`` (how far
    the first record's offset put host time from the pairs' map, at the
    window's start: positive when it looked host spans up too early).
    ``trace.summary`` looks each gap up at its midpoint less the first
    record's offset; it is handed every host span, the harness's and the
    program's, mapped onto the device clock and shifted by that offset,
    so its breakdown names each gap by the innermost span on the map.
    None when nothing was traced or the record has no clock pairs."""
    recs = tracer.records
    if not recs or not program:
        return None
    m = clock_map(program)
    prog = mapped_spans(program)
    busy = trace.merge([(s, e) for _, s, e in recs])
    offset = busy[0][0] - tracer.host_start_ns
    out = trace.summary(tracer, [(lab, m(s) - offset, m(e) - offset)
                                 for lab, s, e in spans]
                        + [(s[0], s[1] - offset, s[2] - offset)
                           for s in prog], top)
    w0 = m(tracer.host_start_ns)
    by_owner = idle_by_owner(idle_intervals(busy, w0, w0 + round(
        window_s * 1e9)), *self_segments(prog))
    idle_by_span: dict[str, float] = {}
    for i, ns in by_owner.items():
        name = prog[i][0] if i >= 0 else NO_SPAN
        idle_by_span[name] = idle_by_span.get(name, 0.0) + ns / 1e9
    syncs: dict[str, int] = {}
    for i in program["syncs"]:
        name = program["spans"][i][0] if i >= 0 else NO_SPAN
        syncs[name] = syncs.get(name, 0) + 1
    out.update(idle_by_span=idle_by_span, syncs_by_span=syncs,
               old_offset_error_us=(tracer.host_start_ns + offset - w0) / 1e3)
    return out


def innermost(points: np.ndarray, prog: list) -> dict[str, int]:
    """How many of ``points`` (device clock) lie in each program span as
    the innermost one (``NO_SPAN``: in none)."""
    out: dict[str, int] = {}
    if not prog:
        return {NO_SPAN: len(points)} if len(points) else {}
    starts, ends, owner = self_segments(prog)
    i = np.searchsorted(starts, points, side="right") - 1
    for p, j in zip(points.tolist(), i.tolist()):
        name = (prog[owner[j]][0] if j >= 0 and p < ends[j] else NO_SPAN)
        out[name] = out.get(name, 0) + 1
    return out


def copy_checks(records: list, program: dict, shift_ns: int = 0) -> dict:
    """The tokens' and logits' copies against the spans that issue them:
    each ``fetch`` of a decode step must hold the end of a ``Memcpy DtoH``
    record, each ``h2d_tokens`` the start of a ``Memcpy HtoD`` record (both
    copies block the host until they are done). ``shift_ns`` moves every
    span (to check another offset). Counts of spans and violations."""
    prog = mapped_spans(program)
    d_end = copy_points(records, DTOH, 2)
    h_start = copy_points(records, HTOD, 1)

    def held(points, a, b):
        i = np.searchsorted(points, a + shift_ns, side="left")
        return i < len(points) and points[i] <= b + shift_ns

    out = {"fetch_spans": 0, "fetch_violations": 0, "h2d_spans": 0,
           "h2d_violations": 0}
    for name, a, b, parent, _ in prog:
        up = prog[parent][0] if parent >= 0 else None
        if name == "fetch" and up == "decode_step":
            out["fetch_spans"] += 1
            out["fetch_violations"] += not held(d_end, a, b)
        elif name == "h2d_tokens":
            out["h2d_spans"] += 1
            out["h2d_violations"] += not held(h_start, a, b)
    return out


def copy_points(records: list, kind: re.Pattern, col: int) -> np.ndarray:
    """The sorted starts (``col`` 1) or ends (2) of the copy records of
    ``kind``."""
    return np.sort(np.array([r[col] for r in records if kind.search(r[0])],
                            dtype=np.int64))


def copy_places(records: list, program: dict) -> dict:
    """Where every copy record lies on the map: the number of ``Memcpy
    DtoH`` ends and of ``Memcpy HtoD`` starts by the innermost program span
    holding them (``NO_SPAN``: none), beside the number of ``fetch`` and
    ``h2d_tokens`` spans. A ``copy_checks`` violation with no record left
    over outside the spans that issue copies is a record the profiler
    lost; one with a record just beside its span is a fault of the map."""
    prog = mapped_spans(program)
    n = {k: sum(s[0] == k for s in prog) for k in ("fetch", "h2d_tokens")}
    return {"fetch_spans": n["fetch"], "dtoh_records": innermost(
                copy_points(records, DTOH, 2), prog),
            "h2d_tokens_spans": n["h2d_tokens"], "htod_records": innermost(
                copy_points(records, HTOD, 1), prog)}


# ---------------------------------------------------------------- readers
def _ready(rec: dict) -> bool:
    tr, prog = rec.get("trace"), rec.get("program")
    return bool(tr and "idle_by_span" in tr and prog and prog["spans"])


def idle_share(rec: dict, names) -> float | None:
    """The share of the window idle while the innermost program span is
    one of ``names`` (a predicate on the name, or a tuple), in %."""
    if not _ready(rec):
        return None
    pick = names if callable(names) else (lambda n: n in names)
    idle = sum(v for k, v in rec["trace"]["idle_by_span"].items() if pick(k))
    return 100.0 * idle / rec["window_s"]


def idle_pim_host(rec: dict, cell) -> float | None:
    """Idle while the innermost program span is ``pim.call`` or a child of
    it (``pim.plan``, ``pim.tables``, ``pim.launch``), in %."""
    return idle_share(rec, lambda n: n.startswith("pim."))


def idle_engine_host(rec: dict, cell) -> float | None:
    """Idle while the innermost program span is an engine span outside
    the model calls (``ENGINE_SPANS``), in %."""
    return idle_share(rec, ENGINE_SPANS)


def pim_host_us(rec: dict, cell) -> float | None:
    """The mean host duration of the window's ``pim.call`` spans, in us."""
    if not _ready(rec):
        return None
    d = [s[2] - s[1] for s in rec["program"]["spans"] if s[0] == "pim.call"]
    return sum(d) / len(d) / 1e3 if d else None


def host_syncs_per_iter(rec: dict, cell) -> float | None:
    """The recorder's ``host_syncs`` over the window's ``step`` spans."""
    if not _ready(rec):
        return None
    prog = rec["program"]
    steps = sum(s[0] == "step" for s in prog["spans"])
    return (prog["counters"].get("host_syncs", 0) / steps) if steps else None
