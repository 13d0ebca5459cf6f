#!/usr/bin/env python3
"""Time K1, K2 and K4 on one qwen1.5-0.5b decode step's shapes, for
comparing two trees of the port on one card.

    python3 tools/time_bitplane.py [--src DIR] [--rounds N]

imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds its kernels and times one decode step's calls at B = 4 on random
weights that are distinct per layer, as the model has them: K2 ((4,2,2)
speculation) and K1 (1b input slices) on 24 layers of q/k/v/o (1024 x
1024), up and gate (1024 x 2816) and down (2816 x 1024) plus the head
(1024 x 151936), two signed passes each (338 calls), at the lossless 24b
ADC; K4 (8 one-bit slices, 3 planes) at the four projection shapes, three
weight sets in turn so L2 holds none. Operands, the step timer
(``cuda_ms``, 5 steps a round) and the bit-for-bit check (first call of
each shape) are ``chip_smoke.py``'s. Prints one JSON line: the tree, the
card, and per kernel every round's mean step time (ms) with their
minimum, median and interquartile range. Runs only on an NVIDIA card.
Run both trees in turns (A, B, B, A) in one call to compare them; the
minimum is the statistic least moved by a busy card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAYERS, B = 24, 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts ROOT/src on the path: --src goes first
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("time_bitplane: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import sliced_crossbar as sx
    build.build(["fused_crossbar", "fused_spec_crossbar", "sliced_crossbar"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)
    shapes = [cs.SITE_SHAPES[n] for _ in range(LAYERS)
              for n in ("qkvo",) * 4 + ("up",) * 2 + ("down",)]
    k1, k2 = [], []
    for R, C in shapes + [cs.SITE_SHAPES["head"]]:
        _, planes, shifts, centers = cs.k2_inputs(B, R, C, gen)
        for _ in "+-":  # two signed passes on the weights, fresh codes
            x = torch.randint(0, 128, (B, R), generator=gen, device="cuda",
                              dtype=torch.int32)
            k2.append((x, *ops.spec_tables(planes, shifts, cs.SPEC),
                       centers))
            k1.append((x, *ops.crossbar_tables(planes, shifts, cs.ONE_BIT),
                       centers))
    k4 = [cs.k4_inputs(B, R, C, gen) for _ in range(cs.K4_SETS)
          for R, C in cs.SITE_SHAPES.values()]
    rows: list = []
    out = {}
    for name, mod, calls in (("fused_spec_crossbar", fs, k2),
                             ("fused_crossbar", fx, k1),
                             ("sliced_crossbar", sx, k4)):
        firsts = {tuple(a[1].shape): a for a in reversed(calls)}
        cs.check_step(rows, name, mod.launch, mod.plain,
                      [(str(s), a) for s, a in firsts.items()], "step", **kw)
        sets = cs.K4_SETS if mod is sx else 1  # K4: per set of 4 shapes
        rounds = [cs.cuda_ms(lambda: [mod.launch(*a, **kw) for a in calls],
                             5) / sets for _ in range(args.rounds)]
        q = statistics.quantiles(rounds, n=4)
        out[name] = dict(min=min(rounds), median=statistics.median(rounds),
                         iqr=q[2] - q[0], rounds=rounds,
                         calls=len(calls) // sets)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"src": args.src, "card": smi, "kernels": out,
                      "checked_shapes": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
