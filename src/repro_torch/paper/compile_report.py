"""Per-site adaptive-slicing compile report (Algorithm 1 x Titanium Law).

Port of the reference's ``benchmarks/compile_report.py``. Compiles a
reduced architecture with ``pim_weight_slicing="adaptive"`` — the paper's
Algorithm 1 running once per projection site (per repeat, per MoE
expert, conservative 1b-per-slice lm_head), its error measured through
kernel K1 at the 16-row search shape — and prices every site with the
§2.5 energy model: converts/MAC, ADC energy share, and the slice-count
histogram (the paper's Fig. 7 and Fig. 12 story told for a modern hybrid
LM). The default arch is the Jamba-style hybrid (mamba + attention + MoE),
so the table exercises every projection family; ``--arch yi-6b`` gives
the small dense version.

    python -m repro_torch.paper.compile_report [--arch yi-6b] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs, resolve_device
from repro_torch.models import pim_compile
from repro_torch.models import transformer as T
from repro_torch.paper import common


def run(arch: str = "jamba-1.5-large-398b", mode: str = "exact",
        tokens: int = 4096, calib_batch: int = 2, calib_len: int = 8,
        seed: int = 0, device=None) -> dict:
    """Compile the ``reduced()`` twin of ``arch`` adaptively and return
    the per-site report: the parameters from ``T.init_params(seed=)``, the
    calibration tokens from ``KEY(seed + 1)``."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(configs.get(arch).reduced(), pim_mode=mode,
                              pim_weight_slicing="adaptive")
    params = T.init_params(cfg, seed=seed, device=dev)
    calib = common.KEY(seed + 1).randint(0, cfg.vocab_size,
                                         (calib_batch, calib_len), dev)
    return report(params, cfg, calib, tokens)


def report(params: dict, cfg, calib: torch.Tensor, tokens: int) -> dict:
    """Algorithm 1's compile of ``params`` on ``calib``, priced."""
    return pim_compile.compile_pim_params(params, cfg, calib).report(
        tokens=tokens)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="jamba-1.5-large-398b")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()
    out = run(arch=args.arch, device=args.device)
    for row in out["sites"]:
        print(f"{row['site']:40s} {'-'.join(map(str, row['slicing'])):16s} "
              f"cpm={row['converts_per_mac']:.4f} "
              f"adc_share={row['adc_share']:.3f}")
    print({k: v for k, v in out.items() if k != "sites"})
