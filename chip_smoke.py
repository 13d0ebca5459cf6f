#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the repository root, one NVIDIA card

Phases, one line each, every failure fatal (non-zero exit, no result line):

  build    compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
           (one ``nvcc`` per source, all started together);
  kernels  run each kernel at the main path's shapes and hold it against its
           plain PyTorch version bit for bit (K2 at the lossless 24b ADC and
           at the paper's 7b ADC, where failures and recovery must occur);
  serve    build qwen1.5-0.5b at its published size (random weights from a
           seed, bf16), compile its PIM plans and serve 4 requests through
           ``ContinuousServeEngine`` in ``exact``, ``int8`` and ``fast``
           mode; launch counts are zeroed before and read after each mode;
           exact tokens must equal int8 tokens at the 24b ADC;
  timing   one decode step's worth of kernel calls on the compiled plans
           (distinct weights per layer, as the model has them) against the
           plain versions and, for K3, ``torch._int_mm``.

Before the last line it prints one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen1.5-0.5b"
# H100 SXM published peaks (NVIDIA data sheet), used for bound_ms
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# the main path's (rows, cols) per projection of qwen1.5-0.5b
SITE_SHAPES = {"qkvo": (1024, 1024), "up": (1024, 2816), "down": (2816, 1024),
               "head": (1024, 151936)}
BATCHES = (1, 4, 64)
SPEC = (4, 2, 2)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls.

    CUDA events around each call, with the device held busy
    (``torch.cuda._sleep``) while the host enqueues it: the events then
    time the kernels back to back, not the host's launch overhead between
    them (which the serve phase's step times include). One call's launches
    must fit the device's launch queue (about a thousand) for this to hold.
    """
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        # ~2x the host's enqueue time, at most ~0.5 s
        torch.cuda._sleep(int(min(4e9 * host_s, 1e9)) + 1_000_000)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def toolchain(torch) -> str:
    """One line naming the host's toolchain as the port sees it."""
    import importlib.util
    from repro_torch.kernels import build
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("triton", "jax")}
    return (f"toolchain: python {sys.version.split()[0]} torch "
            f"{torch.__version__} (CUDA {torch.version.cuda}) nvcc "
            f"{nvcc[-1] if nvcc else '?'} triton={have['triton']} "
            f"jax={have['jax']} cutlass="
            f"{Path('/usr/local/cutlass/include').is_dir()}")


# ---------------------------------------------------------------- phases
def phase_build() -> None:
    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    secs = build.build(list(ops.KERNELS))
    say("build", ok=True, seconds=round(time.perf_counter() - t0, 3),
        per_kernel=json.dumps({k: round(v, 3) for k, v in secs.items()}))


def k2_inputs(B: int, R: int, C: int, gen):
    """Random operands with the value ranges of a (4,2,2) encoding and the
    unsigned codes of one signed pass (0..127)."""
    import torch
    dev = "cuda"
    n_seg = -(-R // 512)
    planes = torch.cat([
        torch.randint(-m, m + 1, (1, n_seg, 512, C), generator=gen,
                      device=dev, dtype=torch.int8) for m in (15, 3, 3)])
    planes[:, -1, R - 512 * (n_seg - 1):] = 0  # zero padding rows
    x = torch.randint(0, 128, (B, R), generator=gen, device=dev,
                      dtype=torch.int32)
    centers = torch.randint(1, 256, (n_seg, C), generator=gen, device=dev,
                            dtype=torch.int32)
    return x, planes, (4, 2, 0), centers


def phase_kernels(rows: list) -> None:
    import torch
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    for site, (R, C) in SITE_SHAPES.items():
        for B in BATCHES:
            # K3
            x = torch.randint(-127, 128, (B, R), generator=gen,
                              device="cuda", dtype=torch.int8)
            w = torch.randint(-127, 128, (R, C), generator=gen,
                              device="cuda", dtype=torch.int8)
            cen = torch.randint(-200, 200, (C,), generator=gen,
                                device="cuda", dtype=torch.int32)
            got = im.launch(x, w, cen)
            want = im.plain(x, w, cen)
            torch.cuda.synchronize()
            match = bool(torch.equal(got, want))
            row = dict(kernel="centered_int8_matmul", site=site, B=B, R=R,
                       C=C, match=match, tolerance=0,
                       max_abs_err=int((got.long() - want.long()).abs().max()))
            row["kernel_ms"] = cuda_ms(lambda: im.launch(x, w, cen), 5)
            row["plain_ms"] = cuda_ms(lambda: im.plain(x, w, cen), 2)
            row["library_ms"] = (cuda_ms(lambda: torch._int_mm(x, w), 5)
                                 if B > 16 else None)
            rows.append(row)
            say("kernels", **row)
            if not match:
                raise AssertionError(f"K3 mismatch at {site} B={B}")
            # K2 at the lossless and the paper's ADC
            xu, planes, shifts, centers = k2_inputs(B, R, C, gen)
            tables = ops.spec_tables(planes, shifts, SPEC)
            for bits in (24, 7):
                adc = adc_lib.ADCConfig(bits=bits)
                kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
                got = fs.launch(xu, *tables, centers, **kw)
                want = fs.plain(xu, *tables, centers, **kw)
                torch.cuda.synchronize()
                match = all(torch.equal(g, wv) for g, wv in zip(got, want))
                row = dict(kernel="fused_spec_crossbar", site=site, B=B, R=R,
                           C=C, adc_bits=bits, match=match, tolerance=0,
                           max_abs_err=int((got[0].long()
                                            - want[0].long()).abs().max()),
                           fails=got[1].tolist(), rsats=int(got[2]))
                if bits == 24:
                    row["kernel_ms"] = cuda_ms(
                        lambda: fs.launch(xu, *tables, centers, **kw), 5)
                    row["plain_ms"] = cuda_ms(
                        lambda: fs.plain(xu, *tables, centers, **kw), 1)
                rows.append(row)
                say("kernels", **row)
                if not match:
                    raise AssertionError(f"K2 mismatch at {site} B={B} "
                                         f"{bits}b: {got[1:]} vs {want[1:]}")
                if bits == 7 and not (int(got[1].sum()) > 0
                                      and int(got[2]) > 0):
                    raise AssertionError("7b ADC run had no failures or no "
                                         "recovery saturations")
            del xu, planes, centers
    summary = []
    for name, count in ops.launch_counts().items():
        mine = [r for r in rows if r["kernel"] == name]
        timed = [r for r in mine if "kernel_ms" in r]
        lib = [r for r in timed if r.get("library_ms") is not None]
        summary.append(dict(
            name=name, launches=count, match=all(r["match"] for r in mine),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            shapes=len(timed),
            kernel_ms=sum(r["kernel_ms"] for r in timed),
            plain_ms=sum(r["plain_ms"] for r in timed),
            # torch._int_mm takes only B > 16: compare on those shapes
            library_shapes=len(lib),
            library_ms=sum(r["library_ms"] for r in lib) if lib else None,
            kernel_ms_library_shapes=sum(r["kernel_ms"] for r in lib)
            if lib else None))
    say("kernels", ok=True, compared=len(rows), kernels=json.dumps(summary))


def serve_requests(vocab: int):
    """4 requests, prompts of 8..16 tokens, 8 new tokens each (seeded)."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(1)
    return [Request(uid=u, prompt=rng.integers(0, vocab, int(n)).astype(
        np.int32), max_new_tokens=8) for u, n in enumerate(
            rng.integers(8, 17, 4))]


def phase_serve(ctx: dict) -> None:
    """Serve qwen1.5-0.5b at full width in exact, int8 and fast mode."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import calibration_tokens
    from repro_torch.models import layers as L
    from repro_torch.models import pim
    from repro_torch.models import transformer as T
    from repro_torch.serve import ContinuousServeEngine
    cfg0 = configs.get(ARCH)
    t0 = time.perf_counter()
    params = T.init_params(cfg0, seed=0, device="cuda")
    torch.cuda.synchronize()
    say("serve", arch=ARCH, layers=cfg0.n_layers, d_model=cfg0.d_model,
        vocab=cfg0.vocab_size, dtype=cfg0.dtype,
        init_s=round(time.perf_counter() - t0, 3))
    reqs = serve_requests(cfg0.vocab_size)
    max_len = max(len(r.prompt) for r in reqs) + 8 + 1
    calib = calibration_tokens(cfg0, 16)
    tokens = {}
    for mode in ("exact", "int8", "fast"):
        cfg = dataclasses.replace(cfg0, pim_mode=mode)
        t0 = time.perf_counter()
        compiled = pim.compile_pim_params(params, cfg, calib)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        eng = ContinuousServeEngine(cfg, params, n_slots=4, max_len=max_len,
                                    prefill_chunk=64, plans=compiled.plans)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with L.collect_pim_stats() as sink:
            outs = eng.run(reqs)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            totals = L.pim_stats_totals(sink)
        st = eng.stats
        n_tok = sum(len(o.tokens) for o in outs)
        assert len(outs) == len(reqs) and all(
            o.finish_reason == "length" and len(o.tokens) == 8 for o in outs)
        assert all(0 <= int(t) < cfg0.vocab_size for o in outs
                   for t in o.tokens)
        calls = st.decode_steps + st.prefill_chunks
        k2, k3 = launches["fused_spec_crossbar"], launches["centered_int8_matmul"]
        if mode == "exact":
            # every projection, both signed passes, went through K2
            assert k2 == 2 * (7 * cfg0.n_layers + 1) * calls and k3 == 0, \
                launches
            ctx["k2_launches"] = k2
            ctx["exact_plans"] = compiled.plans
        elif mode == "fast":
            assert k3 == (7 * cfg0.n_layers + 1) * calls and k2 == 0, launches
            ctx["k3_launches"] = k3
            ctx["fast_plans"] = compiled.plans
        else:
            assert k2 == k3 == 0, launches
        tokens[mode] = [o.tokens.tolist() for o in outs]
        row = dict(mode=mode, compile_s=round(compile_s, 3),
                   serve_s=round(serve_s, 3),
                   prefill_s=round(st.prefill_seconds, 3),
                   decode_s=round(st.decode_seconds, 3),
                   tokens=n_tok, decode_steps=st.decode_steps,
                   prefill_chunks=st.prefill_chunks,
                   tok_per_s=round(n_tok / serve_s, 2),
                   decode_tok_per_s=round(
                       (n_tok - len(outs)) / st.decode_seconds, 2),
                   launches=json.dumps(launches),
                   launches_per_step=json.dumps(
                       {k: v / calls for k, v in launches.items()}))
        if mode == "exact":
            row.update(adc_converts_per_token=round(
                totals["adc_converts"] / n_tok, 1),
                no_spec_converts_per_token=round(
                    totals["no_spec_converts"] / n_tok, 1),
                spec_failures=totals["spec_failures"])
        say("serve", **row)
        del compiled, eng
    if tokens["exact"] != tokens["int8"]:
        raise AssertionError("exact tokens differ from int8 tokens at the "
                             f"24b ADC: {tokens['exact']} vs {tokens['int8']}")
    say("serve", ok=True, exact_equals_int8=True,
        first_tokens=json.dumps(tokens["exact"][0]))
    del params


def step_calls(plans: dict) -> list:
    """One decode step's projections, in the model's order: (name, leaf)
    per layer and projection, then the LM head."""
    out = []
    for lp in plans["layers"]:
        for g, names in (("core", ("wq", "wk", "wv", "wo")),
                         ("ffn", ("w1", "w3", "w2"))):
            out += [(n, lp[g][n]) for n in names]
    return out + [("head", plans["head"])]


def phase_timing(ctx: dict, rows: list) -> list:
    """Time one decode step's worth of each kernel's calls (B = 4 slots)
    on the compiled plans: distinct weights per layer, as the model has
    them, so the 50 MB L2 holds none of them between calls."""
    import torch
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ops
    B = 4
    gen = torch.Generator(device="cuda").manual_seed(1)
    # K2: two signed passes per projection, codes 0..127 per pass
    k2_calls, k2_bytes, k2_ops = [], 0, 0
    for _, leaf in step_calls(ctx["exact_plans"]):
        n_j, n_seg, rx, C = leaf["planes"].shape
        R = leaf["w_q"].shape[0]
        tables = ops.spec_tables(leaf["planes"], leaf["slice_shifts"], SPEC)
        for _ in range(2):
            x = torch.randint(0, 128, (B, R), generator=gen, device="cuda",
                              dtype=torch.int32)
            k2_calls.append((x, tables, leaf["enc_centers"].contiguous()))
            k2_bytes += (4 * B * R + n_j * n_seg * rx * C + 4 * len(SPEC) * n_j
                         + 4 * n_seg * C + 4 * B * C + 8 * (len(SPEC) + 1))
            k2_ops += 2 * B * n_seg * rx * C * n_j * len(SPEC)
    kw = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)  # the 24b ADC

    def k2_step(fn):
        return [fn(x, *t, c, **kw) for x, t, c in k2_calls]
    fails = sum(int(r[1].sum()) for r in k2_step(fs.launch))
    assert fails == 0  # no recovery work at 24b: the bound is the spec dots
    k2 = dict(ms=cuda_ms(lambda: k2_step(fs.launch), 5),
              plain_ms=cuda_ms(lambda: k2_step(fs.plain), 1, warmup=0),
              bound_ms=1e3 * max(k2_bytes / HBM_BYTES_PER_S,
                                 k2_ops / INT8_OPS_PER_S),
              bound_by="bytes" if k2_bytes / HBM_BYTES_PER_S
              >= k2_ops / INT8_OPS_PER_S else "operations",
              library_ms=None, calls=len(k2_calls), bytes=k2_bytes)
    # K3: one call per projection, int8 codes
    k3_calls, k3_bytes, k3_ops = [], 0, 0
    for _, leaf in step_calls(ctx["fast_plans"]):
        R, C = leaf["w_off"].shape
        x = torch.randint(-127, 128, (B, R), generator=gen, device="cuda",
                          dtype=torch.int8)
        k3_calls.append((x, leaf["w_off"], leaf["centers"]))
        k3_bytes += B * R + R * C + 4 * C + 4 * B * C
        k3_ops += 2 * B * R * C
    k3 = dict(ms=cuda_ms(lambda: [im.launch(*a) for a in k3_calls], 5),
              plain_ms=cuda_ms(lambda: [im.plain(*a) for a in k3_calls], 2),
              bound_ms=1e3 * max(k3_bytes / HBM_BYTES_PER_S,
                                 k3_ops / INT8_OPS_PER_S),
              bound_by="bytes" if k3_bytes / HBM_BYTES_PER_S
              >= k3_ops / INT8_OPS_PER_S else "operations",
              library_ms=None, calls=len(k3_calls), bytes=k3_bytes)
    for name, d in (("fused_spec_crossbar", k2), ("centered_int8_matmul", k3)):
        say("timing", kernel=name, scope="one decode step, B=4",
            **{k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in d.items()})

    def err(kernel):
        return max(r["max_abs_err"] for r in rows if r["kernel"] == kernel)
    return [
        dict(name="fused_spec_crossbar", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_spec_crossbar.cu",
             replaces="src/repro/kernels/fused_spec_crossbar.py:139",
             launches=ctx["k2_launches"],
             max_abs_err=err("fused_spec_crossbar"), ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
        dict(name="centered_int8_matmul", route="cuda",
             source="src/repro_torch/kernels/csrc/centered_int8_matmul.cu",
             replaces="src/repro/kernels/int8_matmul.py:51",
             launches=ctx["k3_launches"],
             max_abs_err=err("centered_int8_matmul"), ms=k3["ms"],
             plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=None)]


# ---------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,kernels,serve,timing",
                    help="comma list of phases to run (default: all)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(toolchain(torch), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows: list = []
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(rows)
    ctx: dict = {}
    kernels = None
    if "serve" in phases:
        phase_serve(ctx)
    if "timing" in phases:
        kernels = phase_timing(ctx, rows)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
