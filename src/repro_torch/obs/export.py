"""Metric export: Prometheus text exposition + JSON snapshot files.

A copy of ``repro.obs.export``: the same text and documents, byte for byte.

Two faces over one :class:`repro_torch.obs.metrics.MetricsRegistry`:

- :func:`to_prometheus` renders the standard text exposition format
  (``# HELP`` / ``# TYPE`` headers, label escaping, cumulative
  ``_bucket{le=...}`` / ``_sum`` / ``_count`` histogram series) — what a
  scrape endpoint or pushgateway would serve;
- :func:`write_metrics` writes the ``serve --metrics-out`` document: a
  JSON object carrying the structured snapshot *and* the Prometheus text
  (so one file feeds both dashboards and ad-hoc ``promtool``-style
  checks).
"""

from __future__ import annotations

import json

from repro_torch.obs.metrics import Histogram, MetricsRegistry


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _labelstr(labels: dict, extra: tuple[tuple[str, str], ...] = ()) -> str:
    items = [(k, labels[k]) for k in sorted(labels)] + list(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _fmt_le(ub: float) -> str:
    return str(int(ub)) if float(ub).is_integer() else repr(float(ub))


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render every registered series in Prometheus text exposition."""
    lines: list[str] = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for labels, s in m.series():
                for ub, c in zip(m.buckets, s["counts"]):
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_labelstr(labels, (('le', _fmt_le(ub)),))} {c}")
                lines.append(
                    f"{m.name}_bucket{_labelstr(labels, (('le', '+Inf'),))}"
                    f" {s['counts'][-1]}")
                lines.append(f"{m.name}_sum{_labelstr(labels)} "
                             f"{_fmt(s['sum'])}")
                lines.append(f"{m.name}_count{_labelstr(labels)} "
                             f"{s['count']}")
        else:
            for labels, v in m.series():
                lines.append(f"{m.name}{_labelstr(labels)} {_fmt(v)}")
    return "\n".join(lines) + "\n"


def snapshot(registry: MetricsRegistry) -> dict:
    """Structured JSON-serializable dump (delegates to the registry)."""
    return registry.snapshot()


def metrics_document(registry: MetricsRegistry, **extra) -> dict:
    """The ``--metrics-out`` document: snapshot + exposition + context
    (config, engine stats, ...) passed as keyword blocks."""
    doc = {"metrics": registry.snapshot(),
           "prometheus": to_prometheus(registry)}
    doc.update(extra)
    return doc


def write_metrics(registry: MetricsRegistry, path: str, **extra) -> dict:
    doc = metrics_document(registry, **extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    return doc
