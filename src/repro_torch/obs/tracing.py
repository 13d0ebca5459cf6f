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
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Callable

ENGINE_TID = 0


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


class Tracer:
    def __init__(self, enabled: bool = True, *, pid: int = 0,
                 clock_us: Callable[[], float] | None = None):
        self.enabled = enabled
        self.pid = pid
        self._clock = clock_us or _now_us
        self._events: list[dict] = []
        self._track_names: dict[int, str] = {}

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

    # ------------------------------------------------------------- export
    def events(self) -> list[dict]:
        return list(self._events)

    def chrome_trace(self) -> dict:
        """The full Perfetto-loadable document."""
        meta = [{"name": "thread_name", "ph": "M", "pid": self.pid,
                 "tid": tid, "args": {"name": name}}
                for tid, name in sorted(self._track_names.items())]
        return {"traceEvents": meta + self._events,
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
