"""Serving launcher of the port: generation over a request trace.

  python -m repro_torch.launch.serve --arch qwen1.5-0.5b --pim exact

Runs on the CUDA card unless ``--device cpu`` is given (without a card the
default device raises). ``--engine continuous`` (default) drives the
slot-based scheduler on a mixed-length trace and reports decode-step
utilization next to throughput; ``--engine paged`` serves the same trace
from a paged KV block pool (``--block-size``/``--blocks``, see
``repro_torch.serve.PagedServeEngine``) and prints the pool's counters;
``--engine lockstep`` runs the fixed-batch reference engine.
``--pim fast|exact|int8`` compiles PIM plans (calibrated on
``np.random.default_rng(7)`` tokens; ``--pim-slicing`` pins a slicing like
``4,2,2`` or, with ``adaptive``, runs Algorithm 1 per projection site
through the static-slicing crossbar kernel and prints the per-site table)
and routes every weight-static projection through the
centered int8 kernel (fast), the speculation/recovery crossbar kernel
(exact) or the ideal 8b-quantized reference (int8). Weights are random,
from seed 0. The encoder-only archs (raella-bert-large, hubert-xlarge)
have no decode step: the launcher refuses them before building anything,
with the engines' error. The continuous and paged engines carry a
``repro_torch.obs.ServeTelemetry``: ``--metrics-out`` writes its metrics
(with the final ``ServeStats`` and, in exact mode, the decode steps' PIM
counters and pJ/token), ``--trace-out`` its Chrome trace of spans (the
reference's, and on a lane of their own the program spans of every engine
step: the engine's, the model's and the PIM layer's,
``repro_torch.obs.tracing``) and ``--profile-dir`` a ``torch.profiler``
trace of the run.
``--device-corner nominal|1sigma|3sigma`` (with ``--pim exact``) serves on
a nonideal ReRAM die of seed ``--device-seed``
(``repro_torch.core.backends.NonidealSim``): static input slicing, the
die's float32 reads and the ADC in the crossbar loop, no kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs, obs, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import pim
from repro_torch.models import transformer as T
from repro_torch.serve import (
    ContinuousServeEngine,
    PagedServeEngine,
    Request,
    ServeEngine,
)
from repro_torch.serve.engine import check_decoder


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
    ap.add_argument("--engine", choices=("continuous", "lockstep", "paged"),
                    default="continuous")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged engine: KV tokens per pool block")
    ap.add_argument("--blocks", type=int, default=None,
                    help="paged engine: pool size in blocks (default "
                         "slots * max_len/block_size — no memory pressure; "
                         "smaller values exercise queue-until-blocks-free "
                         "and eviction)")
    ap.add_argument("--requests", type=int, default=8,
                    help="trace length (continuous) / batch size (lockstep)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics snapshot here as JSON "
                         "(Prometheus text exposition included; "
                         "repro_torch.obs.export.write_metrics)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace (Perfetto-loadable) span "
                         "log of the run here, the engine's, model's and "
                         "PIM layer's program spans included")
    ap.add_argument("--profile-dir", default=None,
                    help="wrap the run in torch.profiler (CPU activity, "
                         "and CUDA activity on the card), writing its "
                         "Chrome trace into this directory")
    ap.add_argument("--pim", choices=("off", "fast", "exact", "int8"),
                    default="off")
    ap.add_argument("--pim-slicing", default=None,
                    help="'adaptive' (Algorithm 1 per site) or a comma "
                         "tuple like '4,2,2' pinning every site")
    ap.add_argument("--device-corner", default=None,
                    choices=("nominal", "1sigma", "3sigma"),
                    help="run --pim exact on a nonideal ReRAM die "
                         "(repro_torch.core.backends.NonidealSim): "
                         "conductance program noise, retention drift, "
                         "stuck-at fault maps, IR drop at the named corner. "
                         "'nominal' is the all-zero corner (bit-exact with "
                         "the ideal sim — the zero-corner contract)")
    ap.add_argument("--device-seed", type=int, default=0,
                    help="die seed for --device-corner fault/noise maps")
    args = ap.parse_args(argv)

    if args.engine == "lockstep" and (args.metrics_out or args.trace_out
                                      or args.profile_dir):
        ap.error("--metrics-out/--trace-out/--profile-dir instrument the "
                 "continuous/paged scheduler loops; the lockstep "
                 "reference engine has no request lifecycle to trace")
    if args.device_corner is not None and args.pim != "exact":
        ap.error("--device-corner requires --pim exact (only the "
                 "bit-exact accelerator simulation models the analog "
                 "array)")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(args.arch)
    check_decoder(cfg)  # before any weights are drawn or compiled
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, pim_mode=args.pim)
    if args.device_corner is not None:
        cfg = dataclasses.replace(cfg, pim_crossbar_backend="nonideal",
                                  pim_device_corner=args.device_corner,
                                  pim_device_seed=args.device_seed)
        print(f"device corner: {args.device_corner} "
              f"(die seed {args.device_seed}, nonideal ReRAM array)")
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

    tel = obs.ServeTelemetry(engine=args.engine,
                             tracing=args.trace_out is not None,
                             profile_dir=args.profile_dir)
    trace = [dataclasses.replace(r, temperature=args.temperature)
             for r in build_trace(args.requests, prompt_len=args.prompt_len,
                                  steps=args.steps, vocab=cfg.vocab_size)]
    if args.engine == "paged":
        max_len = -(-max_len // args.block_size) * args.block_size
        eng = PagedServeEngine(cfg, params, n_slots=args.slots,
                               max_len=max_len,
                               prefill_chunk=args.prefill_chunk,
                               block_size=args.block_size,
                               n_blocks=args.blocks, plans=plans,
                               telemetry=tel)
    else:
        eng = ContinuousServeEngine(cfg, params, n_slots=args.slots,
                                    max_len=max_len,
                                    prefill_chunk=args.prefill_chunk,
                                    plans=plans, telemetry=tel)
    t0 = time.monotonic()
    with tel.profile(dev), L.collect_pim_stats() as sink:
        outs = eng.run(trace)
        totals = L.pim_stats_totals(sink)
    dt = time.monotonic() - t0
    total = sum(len(o.tokens) for o in outs)
    st = eng.stats
    print(f"{cfg.name} {args.engine} on {dev}: {len(outs)} requests, "
          f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
    print(f"decode utilization {st.decode_utilization:.2f} tokens/step over "
          f"{args.slots} slots ({st.decode_steps} decode steps, "
          f"{st.prefill_chunks} prefill chunks)")
    if args.engine == "paged":
        print(f"block pool: peak {st.peak_blocks_in_use}/"
              f"{eng.alloc.n_blocks} blocks of {args.block_size}, "
              f"{st.prefix_block_hits} prefix hits, {st.evictions} "
              f"evictions, {st.admission_waits} admission waits")
    if cfg.pim_mode == "exact":
        print(f"adc converts/token {totals['adc_converts'] / max(total, 1):.1f}"
              f" (no-speculation baseline "
              f"{totals['no_spec_converts'] / max(total, 1):.1f}), "
              f"spec failures {totals['spec_failures']}")
    print(f"kernel launches {ops.launch_counts()}")
    tel.record_stats(st)
    if args.metrics_out:
        obs.write_metrics(tel.registry, args.metrics_out,
                          config={"arch": cfg.name, "engine": args.engine,
                                  "pim_mode": cfg.pim_mode,
                                  "requests": args.requests,
                                  "slots": args.slots},
                          stats=st.snapshot())
        print(f"metrics snapshot -> {args.metrics_out}")
    if args.trace_out:
        tel.tracer.write(args.trace_out)
        print(f"chrome trace ({len(tel.tracer.events())} events) -> "
              f"{args.trace_out}")
    if args.profile_dir:
        print(f"torch profiler trace -> {tel.profile_path()}")
    print("first outputs:", {o.uid: o.tokens[:8].tolist() for o in outs[:2]})


if __name__ == "__main__":
    main()
