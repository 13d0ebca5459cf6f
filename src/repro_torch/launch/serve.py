"""Serving launcher of the port: generation over a request trace.

  python -m repro_torch.launch.serve --arch qwen1.5-0.5b --pim exact

Runs on the CUDA card unless ``--device cpu`` is given (without a card the
default device raises). ``--engine continuous`` (default) drives the
slot-based scheduler on a mixed-length trace and reports decode-step
utilization next to throughput; ``--engine lockstep`` runs the fixed-batch
reference engine. ``--pim fast|exact|int8`` compiles PIM plans
(calibrated on ``np.random.default_rng(7)`` tokens; ``--pim-slicing`` pins
a slicing like ``4,2,2`` or, with ``adaptive``, runs Algorithm 1 per
projection site through the static-slicing crossbar kernel and prints the
per-site table) and routes every weight-static projection through the
centered int8 kernel (fast), the speculation/recovery crossbar kernel
(exact) or the ideal 8b-quantized reference (int8). Weights are random,
from seed 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import pim
from repro_torch.models import transformer as T
from repro_torch.serve import ContinuousServeEngine, Request, ServeEngine


def build_trace(n: int, *, prompt_len: int, steps: int, vocab: int,
                seed: int = 1) -> list[Request]:
    """Mixed-length trace: prompt lengths in [prompt_len/2, prompt_len],
    output lengths in [steps/4, steps]."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        plen = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        reqs.append(Request(
            uid=uid,
            prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(max(1, steps // 4), steps + 1))))
    return reqs


def calibration_tokens(cfg, prompt_len: int) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, max(prompt_len, 4))).astype(np.int32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.REGISTRY))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--engine", choices=("continuous", "lockstep"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=8,
                    help="trace length (continuous) / batch size (lockstep)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--pim", choices=("off", "fast", "exact", "int8"),
                    default="off")
    ap.add_argument("--pim-slicing", default=None,
                    help="'adaptive' (Algorithm 1 per site) or a comma "
                         "tuple like '4,2,2' pinning every site")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, pim_mode=args.pim)
    if args.pim_slicing is not None:
        slicing = args.pim_slicing if args.pim_slicing == "adaptive" \
            else tuple(int(b) for b in args.pim_slicing.split(","))
        cfg = dataclasses.replace(cfg, pim_weight_slicing=slicing)
    params = T.init_params(cfg, seed=0, device=dev)
    max_len = args.prompt_len + args.steps + 1

    plans = None
    if cfg.pim_mode != "off":
        t0 = time.monotonic()
        compiled = pim.compile_pim_params(
            params, cfg, calibration_tokens(cfg, args.prompt_len))
        plans = compiled.plans
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"compiled pim plans ({cfg.pim_mode}, "
              f"slicing={cfg.pim_weight_slicing}) in "
              f"{time.monotonic() - t0:.2f}s: {len(compiled.sites)} sites, "
              f"slice histogram {compiled.slice_histogram()}")
        if cfg.pim_weight_slicing == "adaptive":
            for sp in compiled.sites:
                err = "-" if sp.error is None else f"{sp.error:.4f}"
                print(f"  {sp.site:36s} {'-'.join(map(str, sp.slicing)):16s}"
                      f" err={err}")

    ops.reset_launch_counts()
    if args.engine == "lockstep":
        eng = ServeEngine(cfg, params, max_len=max_len,
                          temperature=args.temperature, plans=plans)
        prompts = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (args.requests, args.prompt_len))
        t0 = time.monotonic()
        res = eng.generate(prompts, steps=args.steps)
        dt = time.monotonic() - t0
        print(f"{cfg.name} lockstep on {dev}: generated {res.tokens.shape} "
              f"in {dt:.2f}s ({args.requests * args.steps / dt:.1f} tok/s)")
        print(res.tokens[:2])
        print(f"kernel launches {ops.launch_counts()}")
        return

    trace = [dataclasses.replace(r, temperature=args.temperature)
             for r in build_trace(args.requests, prompt_len=args.prompt_len,
                                  steps=args.steps, vocab=cfg.vocab_size)]
    eng = ContinuousServeEngine(cfg, params, n_slots=args.slots,
                                max_len=max_len,
                                prefill_chunk=args.prefill_chunk, plans=plans)
    t0 = time.monotonic()
    with L.collect_pim_stats() as sink:
        outs = eng.run(trace)
        totals = L.pim_stats_totals(sink)
    dt = time.monotonic() - t0
    total = sum(len(o.tokens) for o in outs)
    st = eng.stats
    print(f"{cfg.name} continuous on {dev}: {len(outs)} requests, {total} "
          f"tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
    print(f"decode utilization {st.decode_utilization:.2f} tokens/step over "
          f"{args.slots} slots ({st.decode_steps} decode steps, "
          f"{st.prefill_chunks} prefill chunks)")
    if cfg.pim_mode == "exact":
        print(f"adc converts/token {totals['adc_converts'] / max(total, 1):.1f}"
              f" (no-speculation baseline "
              f"{totals['no_spec_converts'] / max(total, 1):.1f}), "
              f"spec failures {totals['spec_failures']}")
    print(f"kernel launches {ops.launch_counts()}")
    print("first outputs:", {o.uid: o.tokens[:8].tolist() for o in outs[:2]})


if __name__ == "__main__":
    main()
