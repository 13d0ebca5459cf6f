"""Table 2: the Titanium Law — term-by-term ADC energy decomposition.

Port of the reference's ``benchmarks/table2_titanium.py`` on the port's
copy of the analytic model; no card work.
"""

from __future__ import annotations

from repro_torch.core import energy as en
from repro_torch.core import workloads as wl


def run() -> dict:
    out = {}
    layers = wl.resnet18()
    for arch in [en.ISAAC_8B, en.RAELLA]:
        rep = en.analyze_dnn(arch, layers, replicate=False)
        macs = rep.macs
        cpm = rep.converts_per_mac
        epc = en.adc_energy_per_convert(arch.adc_bits)
        util = sum(l.mapping.utilization * l.layer.macs
                   for l in rep.layers) / macs
        # the law: E = E/convert x converts/MAC x MACs x 1/util (the
        # converts already include the utilization inflation, so the
        # identity check passes 1 for the utilization)
        e_adc = rep.energy_breakdown["e_adc"]
        law = en.titanium_law(epc, cpm, macs, 1.0)
        out[arch.name] = {
            "energy_per_convert_pJ": epc,
            "converts_per_mac": cpm,
            "macs": macs,
            "mean_row_utilization": util,
            "adc_energy_uJ": e_adc / 1e6,
            "titanium_law_uJ": law / 1e6,
            "law_matches": abs(law - e_adc) / e_adc < 1e-6,
        }
    return out


if __name__ == "__main__":
    for k, v in run().items():
        print(k, v)
