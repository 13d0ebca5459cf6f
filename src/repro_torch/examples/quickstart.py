"""Quickstart: RAELLA's arithmetic on one layer, end to end.

    python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper's pipeline on one 512x64 linear layer: 8b quantization,
Center+Offset encoding (Eq. 1/2), adaptive weight slicing (Algorithm 1,
whose search runs the static-slicing kernel ``fused_crossbar``),
speculative crossbar execution with a 7b ADC (``fused_spec_crossbar``) and
the centered int8 fast path (``centered_int8_matmul``), each against the
float product; then ResNet18 on RAELLA against an 8b ISAAC in the
analytic model. On the card every step runs the CUDA kernels; with
``--device cpu``, their plain PyTorch versions.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import adaptive
from repro_torch.core import energy as en
from repro_torch.core import pim_linear as plin
from repro_torch.core import workloads as wl


def where(dev: torch.device) -> str:
    """What ran the kernels: the CUDA kernel on the named card, or the
    plain versions on the CPU."""
    if dev.type == "cuda":
        return f"CUDA kernel on {torch.cuda.get_device_name(dev)}"
    return "plain PyTorch version on the CPU"


def rel_err(y: torch.Tensor, y_ref: torch.Tensor) -> float:
    return float(torch.linalg.norm(y - y_ref) / torch.linalg.norm(y_ref))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(0.01, 0.04, (512, 64)), dtype=torch.float32,
                     device=dev)
    x = torch.tensor(np.maximum(rng.normal(0.2, 0.4, (10, 512)), 0),
                     dtype=torch.float32, device=dev)
    y_ref = x @ w
    out: dict = {}

    print("=== Algorithm 1: adaptive weight slicing ===")
    choice = adaptive.find_best_slicing(w, x, error_budget=0.09)
    print(f"chose {choice.slicing} ({choice.n_slices} slices/weight), "
          f"measured error {choice.error:.4f} (budget 0.09)")
    out.update(slicing=tuple(choice.slicing), n_slices=choice.n_slices,
               search_error=float(choice.error))

    print("\n=== bit-exact accelerator simulation (7b ADC, speculation) ===")
    plan = plin.prepare(w, x, weight_slicing=choice.slicing, speculation=True)
    y_pim, stats = plin.forward_exact(x, plan, return_stats=True)
    st = stats[0]
    conv, base = int(st.adc_converts), int(st.no_spec_converts)
    out.update(exact_rel_err=rel_err(y_pim, y_ref), adc_converts=conv,
               no_spec_converts=base, converts_saved=1 - conv / base,
               spec_failures=int(st.spec_failures),
               spec_attempts=int(st.spec_attempts),
               failure_rate=float(st.failure_rate))
    print(f"rel error vs float: {out['exact_rel_err']:.4f}")
    print(f"ADC converts {conv} vs recovery-only {base} "
          f"({out['converts_saved']:.0%} saved), "
          f"speculation failure rate {out['failure_rate']:.1%}")

    print("\n=== fast path (Eq. 1 as centered int8 matmul) ===")
    out["fast_rel_err"] = rel_err(plin.forward_fast(x, plan), y_ref)
    print(f"rel error vs float: {out['fast_rel_err']:.4f} ({where(dev)})")

    print("\n=== Titanium Law: ResNet18 on RAELLA vs 8b ISAAC ===")
    layers = wl.resnet18()
    ri = en.analyze_dnn(en.ISAAC_8B, layers)
    rr = en.analyze_dnn(en.RAELLA, layers)
    out.update(isaac_converts_per_mac=ri.converts_per_mac,
               raella_converts_per_mac=rr.converts_per_mac,
               energy_x=ri.energy / rr.energy,
               throughput_x=ri.latency_ns / rr.latency_ns)
    print(f"converts/MAC {ri.converts_per_mac:.3f} -> "
          f"{rr.converts_per_mac:.3f}; energy {out['energy_x']:.1f}x "
          f"better, throughput {out['throughput_x']:.1f}x")
    return out


if __name__ == "__main__":
    main()
