"""Beyond the paper: the assigned LM architectures served on RAELLA silicon.

Port of the reference's ``benchmarks/lm_on_pim.py`` on the port's copy of
the analytic model and its registry (``configs.ASSIGNED``); no card work.
Maps every weight-static matmul of each assigned ArchConfig onto the
Titanium-Law model and reports RAELLA vs 8b-ISAAC serving efficiency /
throughput — extending the paper's BERT-feedforward experiment (§6.2) to
the modern LM zoo (GQA, MoE, Mamba, RWKV6). Signed activations use the
paper's two-cycle input processing throughout.
"""

from __future__ import annotations

import numpy as np

from repro_torch import configs
from repro_torch.core import energy as en
from repro_torch.core.lm_workloads import from_arch_config


def run(tokens: int = 1024) -> dict:
    out = {}
    ratios = []
    for arch in configs.ASSIGNED:
        layers = from_arch_config(configs.get(arch), tokens=tokens)
        ri = en.analyze_dnn(en.ISAAC_8B, layers, replicate=False)
        rr = en.analyze_dnn(en.RAELLA, layers, replicate=False)
        eff = ri.energy / rr.energy
        ratios.append(eff)
        out[arch] = {
            "pim_layers": len(layers),
            "macs_per_token": ri.macs // tokens,
            "raella_converts_per_mac": round(rr.converts_per_mac, 4),
            "efficiency_vs_isaac_x": round(eff, 2),
            "raella_uJ_per_token": round(rr.energy / tokens / 1e6, 2),
        }
    out["geomean_efficiency_x"] = round(
        float(np.exp(np.mean(np.log(ratios)))), 2)
    return out


if __name__ == "__main__":
    for k, v in run().items():
        print(k, v)
