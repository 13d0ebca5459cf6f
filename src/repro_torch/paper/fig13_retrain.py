"""Fig. 13: RAELLA vs retraining architectures (FORMS-8, TIMELY).

Port of the reference's ``benchmarks/fig13_retrain.py`` on the port's
copy of the analytic model; no card work. FORMS-8: fine-grained polarized
pruning (2x MACs reduction on ResNet-class nets per the paper) + 5b ADC,
modeled with halved filter lengths. TIMELY: its published ~10x efficiency
is vs the *original 16b* ISAAC; the baseline here is the paper's
8b-modified ISAAC (~4x better than original), so TIMELY's efficiency vs
ISAAC-8b is ~10/4 = 2.5x. RAELLA matches/exceeds both WITHOUT retraining
(geomean over ResNet18/50, as the paper reports).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import energy as en
from repro_torch.core import workloads as wl


def _geo(xs):
    return float(np.exp(np.mean(np.log(xs))))


def run() -> dict:
    out = {}
    e_fo, t_fo, e_ra, t_ra = [], [], [], []
    for fn in (wl.resnet18, wl.resnet50):
        layers = fn()
        pruned = [dataclasses.replace(
            l, filter_len=max(1, l.filter_len // int(en.FORMS_PRUNE_RATIO)))
            for l in layers]
        ri = en.analyze_dnn(en.ISAAC_8B, layers)
        rf = en.analyze_dnn(en.FORMS_8, pruned)
        rr = en.analyze_dnn(en.RAELLA, layers)
        e_fo.append(ri.energy / rf.energy)
        t_fo.append(ri.latency_ns / rf.latency_ns)
        e_ra.append(ri.energy / rr.energy)
        t_ra.append(ri.latency_ns / rr.latency_ns)
    out["forms8_vs_isaac"] = {"efficiency_x": _geo(e_fo),
                              "throughput_x": _geo(t_fo), "retrains": True}
    out["timely_vs_isaac"] = {
        "efficiency_x": en.TIMELY_REL_EFFICIENCY / 4.0,  # vs 8b baseline
        "retrains": True,
        "note": "published 10x is vs original 16b ISAAC; 8b-ISAAC is ~4x that"}
    out["raella_vs_isaac"] = {"efficiency_x": _geo(e_ra),
                              "throughput_x": _geo(t_ra), "retrains": False}
    out["claim"] = ("RAELLA efficiency >= both retraining architectures "
                    "and throughput ~ FORMS, with no retraining: "
                    f"{_geo(e_ra):.2f}x vs FORMS {_geo(e_fo):.2f}x / "
                    f"TIMELY {out['timely_vs_isaac']['efficiency_x']:.2f}x")
    return out


if __name__ == "__main__":
    for k, v in run().items():
        print(k, v)
