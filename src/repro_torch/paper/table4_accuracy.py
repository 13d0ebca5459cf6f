"""Table 4: Center+Offset vs Zero+Offset fidelity + accuracy, no retraining.

Port of the reference's ``benchmarks/table4_accuracy.py``. The paper's
ImageNet/SQuAD models are unavailable offline, so this reproduces the
mechanism end-to-end on a classifier trained here whose bias-free weights
carry per-channel offsets (the paper's Fig. 5 regime):

  - the §4.2.1 fidelity metric (mean |8b output error| on nonzero outputs,
    kernel K1 at 1b input slices), where Zero+Offset blows through the 0.09
    error budget and Center+Offset stays under it;
  - ADC speculation-failure and recovery-saturation rates (kernel K2), the
    causal chain behind Table 4's accuracy drops;
  - end-to-end accuracy through K2 on both layers. On this small,
    margin-rich task both encodings survive argmax (ReLU masks
    negative-side saturation); the paper's ImageNet compact models (1000
    classes, tight margins) lose up to 16.4 points with Zero+Offset — they
    are quoted alongside.

``run_device_corners`` reads both compiled encodings through ReRAM dies
(``core.backends.NonidealSim``, no kernel). The classifier trains from the
port's own keys, so its accuracies differ from the reference's; the
asserts hold the mechanism.

    python -m repro_torch.paper.table4_accuracy [--corners] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core import adaptive
from repro_torch.core import pim_linear as plin
from repro_torch.paper import common

PAPER = {  # (Center+Offset drop, Zero+Offset drop) from the paper's Table 4
    "ResNet18": (0.06, 0.16), "ResNet50": (-0.08, 0.30),
    "MobileNetV2": (0.03, 10.17), "ShuffleNetV2": (0.14, 16.36),
    "GoogLeNet": (-0.02, 1.53), "InceptionV3": (-0.03, 3.72),
    "BERT-Large": (0.12, 0.46),
}
MLP_SIZES = dict(d_in=512, hidden=512, n_classes=8)


def run(train_steps: int = 1500, eval_n: int = 2048, device=None) -> dict:
    dev = resolve_device(device)
    mlp, ds = common.trained_mlp(**MLP_SIZES, steps=train_steps, device=dev)
    acc_f = common.mlp_accuracy(mlp, ds, n=eval_n)
    out = {"float_accuracy": acc_f}
    x_cal, _ = ds.batch(77, 10)
    for mode in ["center", "zero"]:
        err = adaptive.measure_error(mlp.w1, x_cal, (4, 2, 2),
                                     encode_mode=mode)
        plan = plin.prepare(mlp.w1, x_cal, weight_slicing=(4, 2, 2),
                            speculation=True, encode_mode=mode)
        _, stats = plin.forward_exact(x_cal, plan, return_stats=True)
        st = stats[0]
        layer = common.pim_layer_fn(mlp, ds, encode_mode=mode,
                                    speculation=True)
        acc = common.mlp_accuracy(mlp, ds, n=eval_n, layer_fn=layer)
        out[mode] = {
            "sec4.2.1_error": round(err, 4),
            "under_budget_0.09": err < 0.09,
            "spec_failure_rate": round(float(st.failure_rate), 3),
            "recovery_saturations": int(st.recovery_saturations),
            "accuracy": acc,
            "accuracy_drop_pts": round(100 * (acc_f - acc), 2),
        }
    c, z = out["center"], out["zero"]
    assert c["sec4.2.1_error"] < 0.09, "C+O must satisfy the error budget"
    assert z["sec4.2.1_error"] > 3 * c["sec4.2.1_error"], \
        "Z+O fidelity error must blow up vs C+O (Table 4 mechanism)"
    assert z["spec_failure_rate"] > c["spec_failure_rate"]
    assert c["accuracy_drop_pts"] < 2.0
    out["paper_table4_drops_center_vs_zero"] = PAPER
    return out


def run_device_corners(corners: tuple = ("nominal", "3sigma"),
                       train_steps: int = 1500, eval_n: int = 2048,
                       die_seed: int = 0, device=None) -> dict:
    """Table-4 mechanism on nonideal dies, no retraining.

    Both encodings are compiled once (write-once), then each compiled
    image is read through every requested device corner. Center+Offset's
    headroom argument extends to device variation: the same per-column
    margins that absorb ADC saturation absorb conductance noise."""
    dev = resolve_device(device)
    mlp, ds = common.trained_mlp(**MLP_SIZES, steps=train_steps, device=dev)
    acc_f = common.mlp_accuracy(mlp, ds, n=eval_n)
    out = {"float_accuracy": acc_f}
    for mode in ["center", "zero"]:
        plans = common.build_pim_plans(mlp, ds, encode_mode=mode,
                                       speculation=False)
        row = {}
        for name in corners:
            layer = common.plans_layer_fn(
                plans, die=common.die(name, die_seed))
            acc = common.mlp_accuracy(mlp, ds, n=eval_n, layer_fn=layer)
            row[name] = {"accuracy": acc,
                         "drop_pts": round(100 * (acc_f - acc), 2)}
        out[mode] = row
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--corners", action="store_true",
                    help="the die-corner sweep instead of the table")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()
    res = (run_device_corners(device=args.device) if args.corners
           else run(device=args.device))
    for k, v in res.items():
        print(k, v)
