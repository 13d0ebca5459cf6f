"""Metrics registry: counters / gauges / histograms with label sets.

A copy of ``repro.obs.metrics`` (the port imports nothing of the
reference); behaviour, names and exposition are the reference's.

The registry is the one place every subsystem reports through — serve
engines, PIM work counters, benchmark scripts. Design constraints:

- **Near-zero cost when disabled.** ``MetricsRegistry(enabled=False)``
  hands out a shared no-op metric; every ``inc``/``set``/``observe`` is
  one attribute lookup + an empty method call, no locks, no dict churn.
  Engines therefore thread a registry unconditionally instead of
  guarding every call site.
- **Thread-safe.** One registry lock guards series creation and every
  update (serve loops are single-threaded today, but benchmark scripts
  and future async schedulers are not).
- **Two export faces.** :func:`repro_torch.obs.export.to_prometheus` renders
  the standard text exposition; :meth:`MetricsRegistry.snapshot` returns
  a JSON-serializable dict (the shape the reference's
  ``benchmarks/run.py --record`` stores).

Labels follow the Prometheus model: a metric is declared once with its
label *names*; each distinct label-*value* tuple is an independent
series. Histograms use cumulative ``le`` buckets (upper-bound
inclusive), matching Prometheus semantics exactly so the exposition
needs no re-bucketing.
"""

from __future__ import annotations

import threading

# serve-latency oriented default buckets (seconds); +Inf is implicit
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _NullMetric:
    """Shared no-op stand-in handed out by a disabled registry."""

    __slots__ = ()

    def inc(self, value=1, **labels):
        pass

    def set(self, value, **labels):
        pass

    def observe(self, value, **labels):
        pass

    def get(self, **labels):
        return 0.0


_NULL = _NullMetric()


class Metric:
    """One named metric: a family of series keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = lock
        self._series: dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, declared "
                f"{sorted(self.labelnames)}")
        return tuple(labels[n] for n in self.labelnames)

    def get(self, **labels) -> float:
        return self._series.get(self._key(labels), 0.0)

    def series(self) -> list[tuple[dict, float]]:
        with self._lock:
            return [(dict(zip(self.labelnames, k)), v)
                    for k, v in sorted(self._series.items())]


class Counter(Metric):
    kind = "counter"

    def inc(self, value=1, **labels) -> None:
        if value < 0:
            raise ValueError(f"{self.name}: counters only go up ({value})")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = value

    def inc(self, value=1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus ``le`` semantics).

    Each series holds per-bucket counts (a value lands in every bucket
    whose upper bound is >= it, plus the implicit +Inf), a running sum,
    and a total count.
    """

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        b = tuple(sorted(float(x) for x in buckets))
        if len(set(b)) != len(b) or not b:
            raise ValueError(f"{name}: buckets must be distinct, non-empty")
        self.buckets = b
        self._series: dict[tuple, dict] = {}

    def _blank(self) -> dict:
        return {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0,
                "count": 0}

    def observe(self, value, **labels) -> None:
        key = self._key(labels)
        value = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._blank()
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    s["counts"][i] += 1
            s["counts"][-1] += 1          # +Inf
            s["sum"] += value
            s["count"] += 1

    def get(self, **labels) -> dict:
        s = self._series.get(self._key(labels))
        return dict(s) if s else self._blank()

    def series(self) -> list[tuple[dict, dict]]:
        with self._lock:
            return [(dict(zip(self.labelnames, k)),
                     {"counts": list(v["counts"]), "sum": v["sum"],
                      "count": v["count"]})
                    for k, v in sorted(self._series.items())]


class MetricsRegistry:
    """Declare-once, update-anywhere metric store.

    ``counter``/``gauge``/``histogram`` return the existing metric on
    re-declaration (idempotent, so library code can declare at call
    sites) but refuse a re-declaration that changes type, labels, or
    buckets — silent schema drift is exactly what this subsystem exists
    to prevent.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def _declare(self, cls, name, help, labelnames, **kw):
        if not self.enabled:
            return _NULL
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                same = (type(m) is cls and m.labelnames == labelnames
                        and (cls is not Histogram
                             or m.buckets == tuple(sorted(
                                 float(b) for b in kw.get(
                                     "buckets", DEFAULT_BUCKETS)))))
                if not same:
                    raise ValueError(
                        f"metric {name!r} re-declared with a different "
                        f"type/labels/buckets")
                return m
            m = cls(name, help, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames=()) -> Counter:
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._declare(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, labelnames,
                             buckets=buckets)

    def metrics(self) -> list[Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """JSON-serializable dump of every series (the ``--record``
        schema's ``metrics`` block)."""
        out: dict = {}
        for m in self.metrics():
            entry = {"type": m.kind, "help": m.help,
                     "labelnames": list(m.labelnames)}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
                entry["series"] = [{"labels": lab, **val}
                                   for lab, val in m.series()]
            else:
                entry["series"] = [{"labels": lab, "value": val}
                                   for lab, val in m.series()]
            out[m.name] = entry
        return out
