"""Fig. 14: energy ablation — strategies applied cumulatively.

Port of the reference's ``benchmarks/fig14_ablation.py`` on the port's
copy of the analytic model; no card work. Paper converts/MAC sequence:
0.25 -> 0.063 -> 0.047 -> 0.018 (ideal), with ADC dominating ISAAC and
each strategy cutting a specific component.
"""

from __future__ import annotations

from repro_torch.core import energy as en
from repro_torch.core import workloads as wl


def run() -> dict:
    seq = [en.ISAAC_8B, en.CENTER_OFFSET_ONLY, en.CENTER_ADAPTIVE, en.RAELLA]
    layers = wl.resnet18()
    out = {}
    base = None
    for arch in seq:
        rep = en.analyze_dnn(arch, layers, replicate=False)
        ideal_cpm = (arch.n_weight_slices * arch.converts_per_column_pass()
                     / arch.rows)
        if arch.adaptive_slicing:
            ideal_cpm = 3 * arch.converts_per_column_pass() / arch.rows
        e = rep.energy
        base = base or e
        out[arch.name] = {
            "ideal_converts_per_mac": round(ideal_cpm, 4),
            "measured_converts_per_mac": round(rep.converts_per_mac, 4),
            "energy_vs_isaac": round(base / e, 2),
            "adc_share": round(rep.energy_breakdown["e_adc"] / e, 3),
        }
    vals = [v["ideal_converts_per_mac"] for v in out.values()]
    assert vals == sorted(vals, reverse=True)
    return out


if __name__ == "__main__":
    for k, v in run().items():
        print(k, v)
