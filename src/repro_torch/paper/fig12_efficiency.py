"""Fig. 12: RAELLA vs 8b-ISAAC energy efficiency + throughput, 7 DNNs.

Port of the reference's ``benchmarks/fig12_efficiency.py`` on the port's
copy of the analytic model (``core.energy``, ``core.workloads``); no card
work. Paper: efficiency 2.9-4.9x (geomean 3.9x), throughput 0.7-3.3x
(geomean 2.0x); without speculation 2.8x / 2.7x geomean.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import energy as en
from repro_torch.core import workloads as wl


def _geo(xs):
    return float(np.exp(np.mean(np.log(xs))))


def run() -> dict:
    rows = {}
    es, ts, es_ns, ts_ns = [], [], [], []
    for name, fn in wl.WORKLOADS.items():
        layers = fn()
        ri = en.analyze_dnn(en.ISAAC_8B, layers)
        rr = en.analyze_dnn(en.RAELLA, layers)
        rn = en.analyze_dnn(en.RAELLA_NO_SPEC, layers)
        rows[name] = {
            "efficiency_x": ri.energy / rr.energy,
            "throughput_x": ri.latency_ns / rr.latency_ns,
            "nospec_efficiency_x": ri.energy / rn.energy,
            "nospec_throughput_x": ri.latency_ns / rn.latency_ns,
        }
        es.append(rows[name]["efficiency_x"])
        ts.append(rows[name]["throughput_x"])
        es_ns.append(rows[name]["nospec_efficiency_x"])
        ts_ns.append(rows[name]["nospec_throughput_x"])
    rows["geomean"] = {
        "efficiency_x": _geo(es), "throughput_x": _geo(ts),
        "nospec_efficiency_x": _geo(es_ns), "nospec_throughput_x": _geo(ts_ns),
        "paper": "3.9 / 2.0 (nospec 2.8 / 2.7)",
    }
    return rows


if __name__ == "__main__":
    for k, v in run().items():
        print(k, {kk: (round(vv, 2) if isinstance(vv, float) else vv)
                  for kk, vv in v.items()})
