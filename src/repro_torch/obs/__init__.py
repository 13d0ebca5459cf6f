"""repro_torch.obs — unified telemetry: metrics, tracing, profiling hooks.

Port of ``repro.obs``, with the reference's ``__all__``: a label-set
metrics registry with Prometheus/JSON export (``obs.metrics``,
``obs.export``, copies of the reference's), a Chrome-trace span recorder
(``obs.tracing``, a copy), and the serve-stack binding that threads both
through the schedulers plus the PIM work counters, the §2.5 energy model
and the ``torch.profiler`` hooks (``obs.serve``).
"""

from repro_torch.obs.export import (  # noqa: F401
    metrics_document,
    snapshot,
    to_prometheus,
    write_metrics,
)
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.serve import (  # noqa: F401
    NULL_TELEMETRY,
    ServeTelemetry,
    record_pim_totals,
)
from repro_torch.obs.tracing import Tracer  # noqa: F401

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TELEMETRY",
    "ServeTelemetry",
    "Tracer",
    "metrics_document",
    "record_pim_totals",
    "snapshot",
    "to_prometheus",
    "write_metrics",
]
