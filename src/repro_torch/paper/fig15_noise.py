"""Fig. 15: accuracy vs analog noise for the four ablation setups.

Port of the reference's ``benchmarks/fig15_noise.py``. Setups follow §7:
ISAAC-like (128-row unsigned crossbars, 8b unsigned ADC), +Center+Offset
(512-row 2T2R, 7b ADC), +Adaptive Weight Slicing (noise-aware slicing
choice, Algorithm 1), full RAELLA (speculation+recovery). Noise: N(mu,
(E*sqrt(N+ + N-))^2) added to column sums. Paper: ISAAC collapses by ~4%
noise; RAELLA's strategies hold accuracy to much higher noise.

At noise 0 the static-slicing arms run kernel K1 (ISAAC's at 128-row
segments) and RAELLA's arm K2; above 0 the noisy crossbar loops run. The
classifier trains from the port's own keys, so its accuracies differ from
the reference's.

    python -m repro_torch.paper.fig15_noise [--device-corner 3sigma]
        [--eval-n N] [--train-steps N] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core import adaptive
from repro_torch.core import adc as adc_lib
from repro_torch.core import backends as bk
from repro_torch.paper import common

NOISE_LEVELS = (0.0, 0.04, 0.08, 0.12)
ISAAC_ADC = adc_lib.ADCConfig(bits=8, signed=False)
ISAAC_ROWS = 128


def run(noise_levels: tuple = NOISE_LEVELS, eval_n: int = 2048,
        train_steps: int = 1500, device=None) -> dict:
    dev = resolve_device(device)
    mlp, ds = common.trained_mlp(steps=train_steps, device=dev)
    out = {"float_reference": common.mlp_accuracy(mlp, ds, n=eval_n)}
    x_cal, _ = ds.batch(77, 10)

    def acc(**kw):
        return common.mlp_accuracy(mlp, ds, n=eval_n,
                                   layer_fn=common.pim_layer_fn(mlp, ds, **kw))

    for level in noise_levels:
        row = {}
        # ISAAC: unsigned arithmetic, 128-row crossbars, 8b unsigned ADC
        row["isaac"] = acc(encode_mode="unsigned", weight_slicing=(2, 2, 2, 2),
                           adc=ISAAC_ADC, speculation=False,
                           noise_level=level, rows_per_xbar=ISAAC_ROWS)
        # + Center+Offset: 512-row 2T2R, 7b signed ADC
        row["center_offset"] = acc(encode_mode="center",
                                   weight_slicing=(2, 2, 2, 2),
                                   speculation=False, noise_level=level)
        # + Adaptive Weight Slicing (noise-aware choice on layer 1)
        choice = adaptive.find_best_slicing(
            mlp.w1, x_cal, noise_level=level, key=common.KEY(1))
        row["adaptive"] = acc(encode_mode="center",
                              weight_slicing=choice.slicing,
                              speculation=False, noise_level=level)
        row["adaptive_n_slices"] = choice.n_slices
        # full RAELLA (speculation + recovery)
        row["raella"] = acc(encode_mode="center",
                            weight_slicing=choice.slicing, speculation=True,
                            noise_level=level)
        out[f"noise_{level:.2f}"] = row
    return out


def run_device_corners(corners: tuple = ("nominal", "1sigma", "3sigma"),
                       eval_n: int = 2048, train_steps: int = 1500,
                       die_seeds: tuple = (0,), device=None) -> dict:
    """Accuracy vs ReRAM device corner on ONE compiled plan.

    The plan — Algorithm 1's slicing choice + Center+Offset encode — is
    compiled once at nominal; each corner then only swaps the analog array
    model (``core.backends.NonidealSim``: conductance program noise,
    retention drift, stuck-at fault maps, IR drop): does the *unmodified*
    programmed die image survive a 1-sigma / 3-sigma die? The ``nominal``
    corner is the all-zero magnitudes die, bit-exact with the ideal
    simulation, so its row doubles as the reference."""
    dev = resolve_device(device)
    mlp, ds = common.trained_mlp(steps=train_steps, device=dev)
    acc_f = common.mlp_accuracy(mlp, ds, n=eval_n)
    x_cal, _ = ds.batch(77, 10)
    choice = adaptive.find_best_slicing(mlp.w1, x_cal, key=common.KEY(1))
    plans = common.build_pim_plans(mlp, ds, encode_mode="center",
                                   weight_slicing=choice.slicing,
                                   speculation=False)
    out = {"float_reference": acc_f, "slicing": list(choice.slicing)}
    for name in corners:
        accs = [common.mlp_accuracy(
            mlp, ds, n=eval_n, layer_fn=common.plans_layer_fn(
                plans, die=common.die(name, seed))) for seed in die_seeds]
        a = sum(accs) / len(accs)
        out[f"corner_{name}"] = {"accuracy": a,
                                 "drop_pts": round(100 * (acc_f - a), 2),
                                 "dies": len(accs)}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device-corner", default=None, choices=tuple(bk.CORNERS),
                    help="sweep device corners (nominal..the named corner) "
                         "on one compiled plan instead of the noise figure")
    ap.add_argument("--eval-n", type=int, default=2048)
    ap.add_argument("--train-steps", type=int, default=1500)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    if args.device_corner is not None:
        names = tuple(bk.CORNERS)
        sweep = names[:names.index(args.device_corner) + 1]
        res = run_device_corners(corners=sweep, eval_n=args.eval_n,
                                 train_steps=args.train_steps,
                                 device=args.device)
    else:
        res = run(eval_n=args.eval_n, train_steps=args.train_steps,
                  device=args.device)
    for k, v in res.items():
        print(k, v)
    return res


if __name__ == "__main__":
    main()
