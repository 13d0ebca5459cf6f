"""Fig. 3: column-sum distribution reshaping across RAELLA's strategies.

Port of the reference's ``benchmarks/fig3_column_sums.py``. Reports, for
each pipeline stage, the fraction of column sums representable in the 7b
ADC range and the resolution needed for the 99.9th percentile —
reproducing the 17b -> 7b narrative (paper: <=7b rates 59.2% / 82.1% /
98-99.9% and final saturation ~0.1%). The inputs come from numpy, so the
card reproduces the reference's numbers exactly; the end-to-end
saturation rate runs the speculation kernel (K2) at B = 16, R = 512, C =
64.

    python -m repro_torch.paper.fig3_column_sums [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import adc as adc_lib
from repro_torch.core import center_offset as co
from repro_torch.core import crossbar as xbar
from repro_torch.core import speculation as spec
from repro_torch.paper import common


def run(device=None) -> dict:
    dev = resolve_device(device)
    w_u, x = common.realistic_layer(np.random.default_rng(0), rows=512,
                                    cols=64, device=dev)
    adc = adc_lib.RAELLA_ADC
    out = {}

    def stats(enc, input_slicing):
        cs, in_range = xbar.column_sum_distribution(x, enc, input_slicing,
                                                    adc)
        p999 = np.percentile(np.abs(cs.cpu().numpy().astype(np.int64)),
                             99.9)
        bits = int(np.ceil(np.log2(max(p999, 1) + 1))) + 1
        return float(in_range), bits

    # stage 0: baseline — unsigned weights, 4b input x 4b weight slices
    r0, b0 = stats(co.encode(w_u, (4, 4), mode="unsigned"), (4, 4))
    out["baseline_unsigned_4b"] = {"le7b": r0, "p999_bits": b0}
    # stage 1: + Center+Offset (signed 2T2R, centered)
    r1, b1 = stats(co.encode(w_u, (4, 4), mode="center"), (4, 4))
    out["center_offset"] = {"le7b": r1, "p999_bits": b1}
    # stage 2: + Adaptive Weight Slicing (4b-2b-2b typical outcome)
    enc2 = co.encode(w_u, (4, 2, 2), mode="center")
    r2, b2 = stats(enc2, (4, 4))
    out["adaptive_slicing"] = {"le7b": r2, "p999_bits": b2}
    # stage 3: + Dynamic Input Slicing — speculation (4-2-2), recovery (1b)
    r3s, b3s = stats(enc2, (4, 2, 2))
    r3r, b3r = stats(enc2, (1,) * 8)
    out["speculation_cycles"] = {"le7b": r3s, "p999_bits": b3s}
    out["recovery_cycles"] = {"le7b": r3r, "p999_bits": b3r}
    # end-to-end saturation rate with everything on
    _, st = spec.forward(x, enc2)
    out["final_saturation_rate"] = float(st.failure_rate)
    assert r0 < r1 < r2 <= r3r, "pipeline must monotonically tighten sums"
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    for k, v in run(ap.parse_args().device).items():
        print(k, v)
