"""Per-request tracing: Chrome-trace (Perfetto-loadable) event log.

A copy of ``repro.obs.tracing``. The tracer records *host-observed*
intervals — the serve engines already make one host fetch of the logits
per decode step (``logits[:, -1].cpu()``, and one for the rows of the
prompts that finished prefill), so a span's duration is the wall time
between the host syncs the engine was doing anyway. Tracing never adds a
device sync.

Events follow the Chrome Trace Event format (the JSON ``traceEvents``
array Perfetto / ``chrome://tracing`` load directly):

- complete events (``ph: "X"``) for spans, with ``ts``/``dur`` in
  microseconds;
- instant events (``ph: "i"``) for point occurrences (prefix hits,
  evictions, first tokens);
- one metadata event per track naming the lane.

Track convention (the reference's ``docs/observability.md`` gives the
span taxonomy):
``tid 0`` is the engine lane (admission / prefill_chunk / decode_step);
each request gets its own lane at ``tid = uid + 1`` (queue_wait /
request / instants), so a Perfetto timeline shows scheduler occupancy
above a per-request Gantt chart.

A disabled tracer (``Tracer(enabled=False)``) makes every call a no-op;
``clock`` is injectable so tests pin deterministic timestamps.

**Program spans** (the port's own; the reference has none). A tracer
installed with :func:`recording` is the process's active recorder
(``ACTIVE``): code anywhere below the engine opens a span with
``with tracing.span("pim.plan"):`` and no telemetry object passed down.
With nothing installed a span site costs one check of ``ACTIVE``: it reads
no clock and allocates nothing (``span`` hands back the shared
``NULL_SPAN``). A recorded span is a tuple ``(name, start_ns, end_ns,
parent, args)`` stamped with ``clock_ns`` (``time.perf_counter_ns`` unless
injected), ``parent`` the index of the span open when it began (-1 for
none); the recorder also counts its host syncs (``host_syncs``), each
billed to the innermost open span (``sync``). While a recorder
is installed on a machine with CUDA, torch's sync debug mode is ``warn``
and its warnings are taken off the warnings stream and billed with
``sync``: a device copy without ``non_blocking`` to or from pageable host
memory, ``.cpu()``, ``.item()``. ``program()`` exports all of it as plain
lists; ``chrome_trace()`` appends the spans on a lane of their own
(``PROGRAM_TID``), which the reference's calls never reach, so a trace
without program spans is the reference's document. The reference's
three engine spans (``admission``, ``prefill_chunk``, ``decode_step``) are
program spans too (``ServeTelemetry.span``), so that the lane's tree is
whole: a tracing telemetry's export shows them on both lanes, on one
clock (``clock_us`` is ``clock_ns`` in microseconds unless injected on
its own). :class:`ClockMap` and
:class:`ProfilerClock` put the recorder's stamps onto the clock of
``torch.profiler``'s device records.
"""

from __future__ import annotations

import contextlib
import json
import time
import warnings
from typing import Callable

ENGINE_TID = 0
PROGRAM_TID = -1  # the lane of the program spans in ``chrome_trace()``
# the names of a program span's ``args``, by span name, for the export
ARG_NAMES = {"pim.call": ("rows", "R", "C", "mode")}
# the warning torch raises for each host-blocking device sync in sync
# debug mode "warn" (c10/cuda/CUDAFunctions.cpp)
SYNC_WARNING = "called a synchronizing CUDA operation"

# the recorder program spans go to (installed by ``recording``), or None
ACTIVE: "Tracer | None" = None


class _NullSpan:
    """The span of every site while nothing records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


NULL_SPAN = _NullSpan()


def span(name: str):
    """A program span ``name`` on the active recorder (``NULL_SPAN`` when
    none is installed). A site with ``args`` calls ``ACTIVE.region``
    itself, so that nothing is built while nothing records."""
    rec = ACTIVE
    return NULL_SPAN if rec is None else rec.region(name)


class _Region:
    """One open program span of ``rec``."""
    __slots__ = ("rec", "name", "args", "i", "parent", "t0")

    def __init__(self, rec: "Tracer", name: str, args: tuple):
        self.rec, self.name, self.args = rec, name, args

    def __enter__(self):
        rec = self.rec
        self.i = len(rec._spans)
        rec._spans.append(None)  # its place keeps the spans in start order
        self.parent = rec._open[-1] if rec._open else -1
        rec._open.append(self.i)
        self.t0 = rec._clock_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        t1 = rec._clock_ns()
        rec._open.pop()
        rec._spans[self.i] = (self.name, self.t0, t1, self.parent,
                              self.args)
        return False


class _SyncWatch:
    """Bills each of torch's sync warnings to ``rec`` (``Tracer.sync``)
    and shows every other warning as before; on CUDA, sync debug mode
    ``warn`` for the duration."""

    def __init__(self, rec: "Tracer"):
        self.rec = rec
        self._mode = None

    def __enter__(self):
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self._show = warnings.showwarning
        warnings.showwarning = self._bill
        import torch
        if torch.cuda.is_available():
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def _bill(self, message, category, filename, lineno, file=None,
              line=None):
        if str(message).startswith(SYNC_WARNING):
            self.rec.sync()
        else:
            self._show(message, category, filename, lineno, file, line)

    def __exit__(self, *exc):
        if self._mode is not None:
            import torch
            torch.cuda.set_sync_debug_mode(self._mode)
        self._catch.__exit__(*exc)
        return False


@contextlib.contextmanager
def recording(tracer: "Tracer"):
    """Install ``tracer`` as the active recorder for the body (nothing for
    a disabled tracer). An inner ``recording`` of another tracer takes
    over until it ends; of the active one, it does nothing."""
    global ACTIVE
    prev = ACTIVE
    if not tracer.enabled or prev is tracer:
        yield tracer
        return
    ACTIVE = tracer
    try:
        with _SyncWatch(tracer):
            yield tracer
    finally:
        ACTIVE = prev


class ClockMap:
    """The linear map of the recorder's clock onto another, from two
    paired readings ``(host_ns, other_ns)``, taken when recording starts
    and when it stops. Integer nanoseconds in, integer nanoseconds out
    (numpy int64 arrays too): the other clock's readings (Unix
    nanoseconds, ~1.8e18) are past float64's integers."""

    def __init__(self, first: tuple[int, int], last: tuple[int, int]):
        (self.h0, self.d0), (h1, d1) = first, last
        self.scale = (d1 - self.d0) / (h1 - self.h0) if h1 != self.h0 \
            else 1.0

    def __call__(self, t):
        if isinstance(t, int):
            return self.d0 + round((t - self.h0) * self.scale)
        import numpy as np
        dt = (np.asarray(t, dtype=np.int64) - self.h0) * self.scale
        return self.d0 + np.rint(dt).astype(np.int64)


def _approximate_clock():
    """``(read, to_unix_ns)``: torch's approximate clock, which the
    profiler stamps its records with, and a fresh converter of its
    readings to Unix nanoseconds (calibrated from its making to its first
    use, as the profiler's own is from start to stop); ``time.time_ns``
    twice where this torch lacks them."""
    try:
        from torch._C import _profiler as p
        conv = p._ApproximateClockToUnixTimeConverter()
        return p._get_approximate_time, conv.to_unix_ns
    except (ImportError, AttributeError):
        return time.time_ns, lambda t: t


class ProfilerClock:
    """Paired readings of the recorder's clock and of ``torch.profiler``'s
    record clock: make it right after the profiler starts, call
    ``read()`` right before it stops, and ``map()`` after it stopped. Both
    clocks are injectable (``other`` then reads the records' nanoseconds
    directly)."""

    def __init__(self, host_ns: Callable[[], int] | None = None,
                 other: Callable[[], int] | None = None):
        self._host = host_ns or time.perf_counter_ns
        if other is None:
            self._other, self._to_ns = _approximate_clock()
        else:
            self._other, self._to_ns = other, (lambda t: t)
        self.pairs = [self._pair()]

    def _pair(self) -> tuple[int, int]:
        h0 = self._host()
        o = self._other()
        h1 = self._host()
        return (h0 + h1) // 2, o

    def read(self) -> None:
        self.pairs.append(self._pair())

    def map(self) -> ClockMap:
        (h0, o0), (h1, o1) = self.pairs[0], self.pairs[-1]
        return ClockMap((h0, self._to_ns(o0)), (h1, self._to_ns(o1)))


class Tracer:
    def __init__(self, enabled: bool = True, *, pid: int = 0,
                 clock_us: Callable[[], float] | None = None,
                 clock_ns: Callable[[], int] | None = None):
        self.enabled = enabled
        self.pid = pid
        self._clock_ns = clock_ns or time.perf_counter_ns
        self._clock = clock_us or (lambda: self._clock_ns() / 1e3)
        self._events: list[dict] = []
        self._track_names: dict[int, str] = {}
        # program spans (``region``), open span indices, counters, syncs
        self._spans: list = []
        self._open: list[int] = []
        self.counters: dict[str, int] = {}
        self._syncs: list[int] = []

    # ------------------------------------------------------------ recording
    def now(self) -> float:
        """Current trace timestamp (microseconds)."""
        return self._clock()

    def name_track(self, tid: int, name: str) -> None:
        if self.enabled:
            self._track_names.setdefault(tid, name)

    def complete(self, name: str, ts: float, dur: float, *,
                 tid: int = ENGINE_TID, cat: str = "serve",
                 **args) -> None:
        """One finished span with explicit start/duration (used for spans
        whose start predates the call, e.g. queue_wait at admit time)."""
        if self.enabled:
            self._events.append({
                "name": name, "cat": cat, "ph": "X", "ts": ts,
                "dur": max(dur, 0.0), "pid": self.pid, "tid": tid,
                "args": args})

    @contextlib.contextmanager
    def span(self, name: str, *, tid: int = ENGINE_TID, cat: str = "serve",
             **args):
        if not self.enabled:
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            self.complete(name, t0, self._clock() - t0, tid=tid, cat=cat,
                          **args)

    def instant(self, name: str, *, tid: int = ENGINE_TID,
                cat: str = "serve", **args) -> None:
        if self.enabled:
            self._events.append({
                "name": name, "cat": cat, "ph": "i", "ts": self._clock(),
                "s": "t", "pid": self.pid, "tid": tid, "args": args})

    # ------------------------------------------------------ program spans
    def region(self, name: str, args: tuple = ()) -> _Region:
        """A program span ``name`` (a context manager) with ``args``."""
        return _Region(self, name, args)

    def sync(self) -> None:
        """One host-blocking device sync, billed to the innermost open
        program span (``host_syncs``)."""
        self._syncs.append(self._open[-1] if self._open else -1)
        self.counters["host_syncs"] = len(self._syncs)

    def program(self) -> dict:
        """The program spans (``[name, start_ns, end_ns, parent, args]``),
        the counters and each sync's span index, as plain lists; with no
        span open."""
        if self._open:
            raise RuntimeError(f"{len(self._open)} program spans still open")
        return {"spans": [list(s) for s in self._spans],
                "counters": dict(self.counters),
                "syncs": list(self._syncs)}

    # ------------------------------------------------------------- export
    def events(self) -> list[dict]:
        return list(self._events)

    def _program_events(self) -> list[dict]:
        out = []
        for s in self._spans:
            if s is None:
                continue
            name, t0, t1, parent, args = s
            up = self._spans[parent] if parent >= 0 else None
            a = {"parent": up[0] if up else None}
            a.update(zip(ARG_NAMES.get(name, ()), args))
            out.append({"name": name, "cat": "program", "ph": "X",
                        "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
                        "pid": self.pid, "tid": PROGRAM_TID, "args": a})
        return out

    def chrome_trace(self) -> dict:
        """The full Perfetto-loadable document; the program spans, if any,
        on their own lane after the reference's events."""
        tracks = dict(self._track_names)
        program = self._program_events()
        if program:
            tracks[PROGRAM_TID] = "program spans"
        meta = [{"name": "thread_name", "ph": "M", "pid": self.pid,
                 "tid": tid, "args": {"name": name}}
                for tid, name in sorted(tracks.items())]
        return {"traceEvents": meta + self._events + program,
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
