#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the repository root, one NVIDIA card

Phases, one line each, every failure fatal (non-zero exit, no result line):

  build    compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
           (one ``nvcc`` per source, all started together) and print K3's,
           K2's and K1's ``ptxas -v`` lines per instantiation (registers,
           spills, the shared memory their tile plans ask for);
  kernels  run each kernel at the main path's shapes and hold it against its
           plain PyTorch version bit for bit: K3 (timed beside its yardstick
           ``torch._int_mm`` on x padded to 17 rows; tail shapes, -128
           inputs and wrapping centers besides), K2 (at the lossless 24b
           ADC and at the paper's 7b ADC, where failures and recovery must
           occur, both timed; tails: B = 2, 3, 9, 17, 65, R = 1000, 1001 and
           2816, C = 1000 and 1008, 1 and 8 planes with a padded one, the
           (8,) spec slicing and centers across the int32 range), K1 with
           1b input slices at B = 1, 4, 16, 64 (7b runs must saturate),
           with (4,2,2), (8,) slicings and a ragged plane mask, and at
           K2's kind of tails (``K1_TAILS``); K1, K2, K1 launched back to
           back on one stream, each with its own counters; K4 with 8
           one-bit input slices and 3 planes;
  serve    build qwen1.5-0.5b at its published size (random weights from a
           seed, bf16), compile its PIM plans and serve 4 requests through
           ``ContinuousServeEngine`` in ``exact``, ``int8`` and ``fast``
           mode, then ``exact`` with speculation off (the static-slicing
           kernel K1 on the pinned plans) and ``exact`` with adaptive
           slicing (Algorithm 1 per site through K1 at compile time);
           launch counts are zeroed before and read after each run; every
           exact run's tokens must equal the int8 tokens at the 24b ADC;
           then Algorithm 1's compile again under ``torch.profiler`` (K1's
           device time in it), and a sampled request (temperature 1.0)
           whose stream must be the same in both engines for one seed;
  timing   one decode step's worth of kernel calls on the compiled plans
           (distinct weights per layer, as the model has them) against the
           plain versions and, for K3, ``torch._int_mm`` (x padded with zero
           rows); K2 also on Algorithm 1's adaptive plans; K4 at the four
           projection shapes; K1 at B = 16 with batch tiles of 1, 2 and 4
           rows.

Before the last line it prints one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import re
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
K1_BATCHES = (1, 4, 16, 64)  # 16: Algorithm 1's search rows
SPEC = (4, 2, 2)
ONE_BIT = (1,) * 8           # Algorithm 1's input slicing


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
    # K3, K2 and K1 per instantiation (batch tile, load path): ptxas -v
    # registers and spills, and the most dynamic shared memory their tile
    # plans ask for
    from repro_torch.kernels import bitplane
    from repro_torch.kernels import int8_matmul as im

    def bitplane_entry(m):
        return dict(bt=int(m[1]), cp_async=m[2] == "1",
                    smem_bytes_max=max(bitplane.smem_bytes(int(m[1]), c)
                                       for c in range(
                                           1, bitplane.MAX_CLUSTER + 1)))
    entries = {
        "centered_int8_matmul": (
            r"int8_kernelILi(\d)ELb([01])E",
            lambda m: dict(bt=8 * int(m[1]), cp_async=m[2] == "1",
                           smem_bytes_max=im.smem_bytes(8 * int(m[1]),
                                                        im.MAX_CLUSTER))),
        "fused_spec_crossbar": (r"spec_kernelILi(\d)ELb([01])E",
                                bitplane_entry),
        "fused_crossbar": (r"crossbar_kernelILi(\d)ELb([01])E",
                           bitplane_entry)}
    for name, (pattern, fields) in entries.items():
        entry = None
        for line in build.LOGS.get(name, "").splitlines():
            m = re.search("Compiling entry.*" + pattern, line)
            if m:
                entry = fields(m)
            elif entry is not None and "spill" in line:
                entry["spill_bytes"] = sum(map(int, re.findall(
                    r"(\d+) bytes spill", line)))
            elif entry is not None and "Used" in line:
                entry["registers"] = int(re.search(r"Used (\d+) reg",
                                                   line)[1])
                say("build", kernel=name, **entry)
                entry = None


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
            row = compare("centered_int8_matmul", im.launch(x, w, cen),
                          im.plain(x, w, cen), site=site, B=B, R=R, C=C)
            row["kernel_ms"] = cuda_ms(lambda: im.launch(x, w, cen), 5)
            row["plain_ms"] = cuda_ms(lambda: im.plain(x, w, cen), 2)
            xp = int_mm_operand(x)
            row["library_rows"] = xp.shape[0]
            row["library_ms"] = cuda_ms(lambda: torch._int_mm(xp, w), 5)
            rows.append(row)
            say("kernels", **row)
            # K2 at the lossless and the paper's ADC
            xu, planes, shifts, centers = k2_inputs(B, R, C, gen)
            tables = ops.spec_tables(planes, shifts, SPEC)
            for bits in (24, 7):
                adc = adc_lib.ADCConfig(bits=bits)
                kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
                got = fs.launch(xu, *tables, centers, **kw)
                row = compare("fused_spec_crossbar", got,
                              fs.plain(xu, *tables, centers, **kw),
                              site=site, B=B, R=R, C=C, adc_bits=bits,
                              fails=got[1].tolist(), rsats=int(got[2]))
                row["kernel_ms"] = cuda_ms(
                    lambda: fs.launch(xu, *tables, centers, **kw), 5)
                if bits == 24:
                    row["plain_ms"] = cuda_ms(
                        lambda: fs.plain(xu, *tables, centers, **kw), 1)
                elif not (int(got[1].sum()) > 0 and int(got[2]) > 0):
                    raise AssertionError("7b ADC run had no failures or no "
                                         "recovery saturations")
                rows.append(row)
                say("kernels", **row)
            del xu, planes, centers
    check_k3_tails(rows, gen)
    check_k2_tails(rows, gen)
    check_k1(rows, gen)
    check_k1_tails(rows, gen)
    check_interleaved(rows, gen)
    check_k4(rows, gen)
    summary = []
    for name, count in ops.launch_counts().items():
        mine = [r for r in rows if r["kernel"] == name]
        timed = [r for r in mine if "plain_ms" in r]
        lib = {B: [r for r in timed if r.get("library_ms") is not None
                   and r["B"] == B] for B in BATCHES}
        row = dict(
            name=name, launches=count, match=all(r["match"] for r in mine),
            checks=len(mine), max_abs_err=max(r["max_abs_err"] for r in mine),
            shapes=len(timed),
            kernel_ms=sum(r["kernel_ms"] for r in timed),
            plain_ms=sum(r["plain_ms"] for r in timed))
        for B, lrows in lib.items():  # K3 against torch._int_mm, per B
            if lrows:
                row[f"kernel_ms_B{B}"] = sum(r["kernel_ms"] for r in lrows)
                row[f"library_ms_B{B}"] = sum(r["library_ms"] for r in lrows)
        summary.append(row)
    say("kernels", ok=True, compared=len(rows), kernels=json.dumps(summary))


def compare(kernel: str, got, want, **fields) -> dict:
    """One bit-for-bit comparison row; raises on a mismatch."""
    import torch
    torch.cuda.synchronize()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    match = all(torch.equal(g, w) for g, w in zip(got, want))
    row = dict(kernel=kernel, **fields, match=match, tolerance=0,
               max_abs_err=int((got[0].long() - want[0].long()).abs().max()))
    if not match:
        say("kernels", **row)
        raise AssertionError(f"{kernel} mismatch: {fields}")
    return row


INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA needs more than 16 rows


def int_mm_operand(x):
    """x padded with zero rows to the fewest rows ``torch._int_mm`` takes:
    the library yardstick of K3. It computes x @ w without the center term,
    a lower bound for the library; the port never calls it."""
    import torch
    B, K = x.shape
    if B >= INT_MM_MIN_ROWS:
        return x
    xp = torch.zeros((INT_MM_MIN_ROWS, K), dtype=torch.int8, device=x.device)
    xp[:B] = x
    return xp


def check_k3_tails(rows: list, gen) -> None:
    """K3 past the site shapes: K and N off the tiles (1000 takes the
    word-load path, 1040 x 1008 the cp.async path with ragged edges),
    batches of 3, 9, 17 and 65 rows, and x full of -128 against centers
    near the int32 limits, where y wraps modulo 2^32."""
    import torch
    from repro_torch.kernels import int8_matmul as im
    for K, N, B, extreme in ((1000, 1000, 3, False), (1000, 1000, 17, False),
                             (1040, 1008, 9, False), (1040, 1008, 17, False),
                             (1024, 1024, 65, False), (1024, 1024, 4, True),
                             (1000, 1000, 9, True), (1024, 2816, 64, True)):
        x = torch.randint(-128, 128, (B, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        cen = torch.randint(-300, 300, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        if extreme:
            x[:, ::2] = -128
            cen = torch.randint(-2**31, 2**31 - 1, (N,), generator=gen,
                                device="cuda", dtype=torch.int32)
        row = compare("centered_int8_matmul", im.launch(x, w, cen),
                      im.plain(x, w, cen), site="tail", B=B, R=K, C=N,
                      extreme=extreme)
        rows.append(row)
        say("kernels", **row)


# K2 tails (B, R, C, n_j, spec slicing, padded last plane, wrapping
# centers): C = 1000 and R = 1001 take the word-load path, C = 1008 the
# cp.async path with a ragged column tile; 2816 and 1000 rows leave the
# last segment ragged; 8 planes give clusters of 8 ranks; B = 1 (the site
# rows), 2 and 3 take batch tiles of 1, 2 and 4 rows
K2_TAILS = ((3, 1000, 1000, 3, SPEC, False, False),
            (9, 2816, 1008, 3, SPEC, False, True),
            (17, 1000, 1008, 8, SPEC, True, False),
            (65, 2816, 1000, 1, (8,), False, True),
            (4, 1024, 1024, 8, (8,), True, True),
            (9, 1000, 1000, 1, SPEC, False, True),
            (5, 1001, 1008, 3, SPEC, False, False),
            (64, 1024, 2816, 3, (8,), False, True),
            (2, 2816, 1024, 3, SPEC, False, True))


def check_k2_tails(rows: list, gen) -> None:
    """K2 past the site shapes (``K2_TAILS``), full 8b codes, at 24b and at
    7b, where failures and recovery saturations must occur."""
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import ops
    for B, R, C, n_j, slicing, padded, wrap in K2_TAILS:
        xu, planes, shifts, valid, centers = tail_inputs(B, R, C, n_j, padded,
                                                         wrap, gen)
        tables = ops.spec_tables(planes, shifts, slicing, valid)
        for bits in (24, 7):
            adc = adc_lib.ADCConfig(bits=bits)
            kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
            got = fs.launch(xu, *tables, centers, **kw)
            row = compare("fused_spec_crossbar", got,
                          fs.plain(xu, *tables, centers, **kw), site="tail",
                          B=B, R=R, C=C, n_j=n_j, adc_bits=bits,
                          spec="-".join(map(str, slicing)), padded=padded,
                          wrap=wrap, fails=got[1].tolist(), rsats=int(got[2]))
            if bits == 7 and not (int(got[1].sum()) > 0 and int(got[2]) > 0):
                raise AssertionError(f"K2 tail {row} had no failures or no "
                                     "recovery saturations")
            rows.append(row)
            say("kernels", **row)
        del xu, planes, centers, tables


def check_k1(rows: list, gen) -> None:
    """K1 at Algorithm 1's input slicing over the site shapes and batch
    sizes (the search runs B = 16, nospec decode B = 4), then other input
    slicings and a ragged plane mask at one shape."""
    import torch
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import ops
    for site, (R, C) in SITE_SHAPES.items():
        for B in K1_BATCHES:
            xu, planes, shifts, centers = k2_inputs(B, R, C, gen)
            tables = ops.crossbar_tables(planes, shifts, ONE_BIT)
            for bits in (24, 7):
                adc = adc_lib.ADCConfig(bits=bits)
                kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
                got = fx.launch(xu, *tables, centers, **kw)
                row = compare("fused_crossbar", got,
                              fx.plain(xu, *tables, centers, **kw),
                              site=site, B=B, R=R, C=C, adc_bits=bits,
                              input_slicing="1x8", sats=int(got[1]))
                if bits == 24:
                    row["kernel_ms"] = cuda_ms(
                        lambda: fx.launch(xu, *tables, centers, **kw), 5)
                    row["plain_ms"] = cuda_ms(
                        lambda: fx.plain(xu, *tables, centers, **kw), 1)
                elif int(got[1]) == 0:
                    raise AssertionError("7b ADC run of K1 had no saturations")
                rows.append(row)
                say("kernels", **row)
            del xu, planes, centers, tables
    R, C = SITE_SHAPES["qkvo"]
    xu, planes, shifts, centers = k2_inputs(4, R, C, gen)
    xu = torch.randint(0, 256, xu.shape, generator=gen, device="cuda",
                       dtype=torch.int32)  # full 8b codes
    planes = torch.cat([planes, torch.full_like(planes[:1], 7)])
    valid = torch.tensor([True, True, True, False], device="cuda")
    shifts = torch.tensor([4, 2, 0, 6], dtype=torch.int32, device="cuda")
    for slicing in (SPEC, (8,)):
        tables = ops.crossbar_tables(planes, shifts, slicing, valid)
        for bits in (24, 7):
            adc = adc_lib.ADCConfig(bits=bits)
            kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
            got = fx.launch(xu, *tables, centers, **kw)
            row = compare("fused_crossbar", got,
                          fx.plain(xu, *tables, centers, **kw), site="qkvo",
                          B=4, R=R, C=C, adc_bits=bits,
                          input_slicing="-".join(map(str, slicing)),
                          valid="1110", sats=int(got[1]))
            rows.append(row)
            say("kernels", **row)


# K1 tails (B, R, C, n_j, input slicing, padded last plane, wrapping
# centers), full 8b codes: C = 1000 and R = 1001 take the word-load path,
# C = 1008 the cp.async path with a ragged column tile; 1000, 1001 and 2816
# rows leave the last segment ragged; 8 planes give clusters of 8 ranks and
# B = 16 with 8 planes is Algorithm 1's widest candidate at a layer site;
# B = 1, 2 and 3 take batch tiles of 1, 2 and 4 rows
K1_TAILS = ((3, 1000, 1000, 3, ONE_BIT, False, False),
            (9, 2816, 1008, 3, SPEC, False, True),
            (17, 1000, 1008, 8, ONE_BIT, True, False),
            (65, 2816, 1000, 1, (8,), False, True),
            (2, 1001, 1008, 3, (2, 2, 2, 2), False, True),
            (5, 1024, 1024, 8, (8,), True, True),
            (16, 1024, 2816, 8, ONE_BIT, True, False),
            (1, 2816, 1024, 3, (2, 2, 2, 2), False, False))


def tail_inputs(B: int, R: int, C: int, n_j: int, padded: bool, wrap: bool,
                gen):
    """Planes of up to 8 slices (zero padding rows; the last plane zeroed
    with mults 0 when ``padded``), their shifts and valid mask, full 8b
    codes and centers (across the int32 range when ``wrap``)."""
    import torch
    n_seg = -(-R // 512)
    planes = torch.cat([
        torch.randint(-m, m + 1, (1, n_seg, 512, C), generator=gen,
                      device="cuda", dtype=torch.int8)
        for m in (15, 3, 3, 1, 7, 3, 1, 15)[:n_j]])
    planes[:, -1, R - 512 * (n_seg - 1):] = 0  # zero padding rows
    shifts = torch.tensor([4, 2, 0, 6, 1, 3, 5, 7][:n_j],
                          dtype=torch.int32, device="cuda")
    valid = None
    if padded:  # the last plane pads a ragged plan: zeroed, mults 0
        valid = torch.ones(n_j, dtype=torch.bool, device="cuda")
        valid[-1] = False
    xu = torch.randint(0, 256, (B, R), generator=gen, device="cuda",
                       dtype=torch.int32)
    lo_hi = (-2**31, 2**31 - 1) if wrap else (1, 256)
    centers = torch.randint(*lo_hi, (n_seg, C), generator=gen,
                            device="cuda", dtype=torch.int32)
    return xu, planes, shifts, valid, centers


def check_k1_tails(rows: list, gen) -> None:
    """K1 past the site shapes (``K1_TAILS``) at 24b, timed, and at 7b,
    where it must saturate."""
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import ops
    for B, R, C, n_j, slicing, padded, wrap in K1_TAILS:
        xu, planes, shifts, valid, centers = tail_inputs(B, R, C, n_j, padded,
                                                         wrap, gen)
        tables = ops.crossbar_tables(planes, shifts, slicing, valid)
        for bits in (24, 7):
            adc = adc_lib.ADCConfig(bits=bits)
            kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
            got = fx.launch(xu, *tables, centers, **kw)
            row = compare("fused_crossbar", got,
                          fx.plain(xu, *tables, centers, **kw), site="tail",
                          B=B, R=R, C=C, n_j=n_j, adc_bits=bits,
                          input_slicing="-".join(map(str, slicing)),
                          padded=padded, wrap=wrap, sats=int(got[1]))
            if bits == 24:
                row["tail_ms"] = cuda_ms(
                    lambda: fx.launch(xu, *tables, centers, **kw), 3)
            elif int(got[1]) == 0:
                raise AssertionError(f"K1 tail {row} had no saturations")
            rows.append(row)
            say("kernels", **row)
        del xu, planes, centers, tables


def check_interleaved(rows: list, gen) -> None:
    """K1, K2, K1 launched back to back on one stream at the 7b ADC, read
    only after all three: each kernel's counters equal its plain version's,
    so neither adds into the other's counts buffer."""
    import torch
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import ops
    R, C = SITE_SHAPES["qkvo"]
    adc = adc_lib.ADCConfig(bits=7)
    kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
    calls = []
    for kernel in ("fused_crossbar", "fused_spec_crossbar", "fused_crossbar"):
        xu, planes, shifts, valid, centers = tail_inputs(4, R, C, 3, False,
                                                         False, gen)
        if kernel == "fused_crossbar":
            calls.append((kernel, fx, (xu, *ops.crossbar_tables(
                planes, shifts, ONE_BIT), centers)))
        else:
            calls.append((kernel, fs, (xu, *ops.spec_tables(
                planes, shifts, SPEC), centers)))
    got = [mod.launch(*args, **kw) for _, mod, args in calls]
    torch.cuda.synchronize()
    for (kernel, mod, args), g in zip(calls, got):
        row = compare(kernel, g, mod.plain(*args, **kw), site="interleaved",
                      B=4, R=R, C=C, adc_bits=7,
                      counts=json.dumps([int(t) for t in g[1:]]
                                        if kernel == "fused_crossbar"
                                        else g[1].tolist() + [int(g[2])]))
        if not int(g[1].sum()) > 0:
            raise AssertionError(f"interleaved {kernel} counted nothing")
        rows.append(row)
        say("kernels", **row)


def k4_inputs(B: int, R: int, C: int, gen):
    """8 one-bit slices of unsigned codes (0..127) and (4,2,2)-range
    planes with their recombination multipliers 2**(l_i + l_j)."""
    import torch
    x = torch.randint(0, 128, (B, R), generator=gen, device="cuda")
    xs = torch.stack([(x >> (7 - i)) & 1 for i in range(8)]).to(torch.int8)
    planes = torch.stack([
        torch.randint(-m, m + 1, (R, C), generator=gen, device="cuda",
                      dtype=torch.int8) for m in (15, 3, 3)])
    mults = torch.tensor([[1 << (7 - i + lj) for lj in (4, 2, 0)]
                          for i in range(8)], dtype=torch.int32,
                         device="cuda")
    return xs.contiguous(), planes, mults


def check_k4(rows: list, gen) -> None:
    """K4 at the four site shapes, B = 4, at 24b and 7b."""
    from repro_torch.core import adc as adc_lib
    from repro_torch.kernels import sliced_crossbar as sx
    for site, (R, C) in SITE_SHAPES.items():
        xs, planes, mults = k4_inputs(4, R, C, gen)
        for bits in (24, 7):
            adc = adc_lib.ADCConfig(bits=bits)
            kw = dict(adc_lo=adc.lo, adc_hi=adc.hi)
            row = compare("sliced_crossbar", sx.launch(xs, planes, mults,
                                                       **kw),
                          sx.plain(xs, planes, mults, **kw), site=site, B=4,
                          R=R, C=C, adc_bits=bits, n_i=8, n_j=3)
            if bits == 24:
                row["kernel_ms"] = cuda_ms(
                    lambda: sx.launch(xs, planes, mults, **kw), 5)
                row["plain_ms"] = cuda_ms(
                    lambda: sx.plain(xs, planes, mults, **kw), 1)
                row["bytes"] = 8 * 4 * R + 3 * R * C + 4 * 24 + 4 * 4 * C
                row["ops"] = 2 * 8 * 3 * 4 * R * C
            rows.append(row)
            say("kernels", **row)
        del xs, planes, mults


def serve_requests(vocab: int):
    """4 requests, prompts of 8..16 tokens, 8 new tokens each (seeded)."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(1)
    return [Request(uid=u, prompt=rng.integers(0, vocab, int(n)).astype(
        np.int32), max_new_tokens=8) for u, n in enumerate(
            rng.integers(8, 17, 4))]


def phase_serve(ctx: dict) -> None:
    """Serve qwen1.5-0.5b at full width in exact, int8 and fast mode, then
    exact with speculation off on the pinned exact plans, then exact with
    Algorithm 1's adaptive per-site plans."""
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
    n_proj = 7 * cfg0.n_layers + 1  # weight-static projections per call
    runs = (("exact", dict(pim_mode="exact")),
            ("int8", dict(pim_mode="int8")),
            ("fast", dict(pim_mode="fast")),
            ("exact-nospec", dict(pim_mode="exact", pim_speculation=False)),
            ("exact-adaptive", dict(pim_mode="exact",
                                    pim_weight_slicing="adaptive")))
    tokens, totals = {}, {}
    for run, over in runs:
        cfg = dataclasses.replace(cfg0, **over)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if run == "exact-nospec":  # the pinned exact plans, speculation off
            compiled = ctx["exact_compiled"]
        else:
            compiled = pim.compile_pim_params(params, cfg, calib)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        compile_launches = ops.launch_counts()
        eng = ContinuousServeEngine(cfg, params, n_slots=4, max_len=max_len,
                                    prefill_chunk=64, plans=compiled.plans)
        t0 = time.perf_counter()
        with L.collect_pim_stats() as sink:
            outs = eng.run(reqs)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            totals[run] = L.pim_stats_totals(sink)
        st = eng.stats
        n_tok = sum(len(o.tokens) for o in outs)
        assert len(outs) == len(reqs) and all(
            o.finish_reason == "length" and len(o.tokens) == 8 for o in outs)
        assert all(0 <= int(t) < cfg0.vocab_size for o in outs
                   for t in o.tokens)
        calls = st.decode_steps + st.prefill_chunks
        served = {k: launches[k] - compile_launches[k] for k in launches}
        k1, k2, k3, k4 = (served[k] for k in (
            "fused_crossbar", "fused_spec_crossbar", "centered_int8_matmul",
            "sliced_crossbar"))
        # every projection, both signed passes, through one kernel
        want = {"exact": (0, 2 * n_proj * calls, 0),
                "fast": (0, 0, n_proj * calls),
                "int8": (0, 0, 0),
                "exact-nospec": (2 * n_proj * calls, 0, 0),
                "exact-adaptive": (0, 2 * n_proj * calls, 0)}[run]
        assert (k1, k2, k3) == want and k4 == 0, (run, launches)
        tokens[run] = [o.tokens.tolist() for o in outs]
        row = dict(mode=run, compile_s=round(compile_s, 3),
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
                       {k: v / calls for k, v in served.items()}))
        if run.startswith("exact"):
            tot = totals[run]
            row.update(adc_converts_per_token=tot["adc_converts"] / n_tok,
                       no_spec_converts_per_token=tot["no_spec_converts"]
                       / n_tok, spec_failures=tot["spec_failures"])
        if run == "exact":
            ctx["k2_launches"] = k2
            ctx["exact_compiled"] = compiled
        elif run == "fast":
            ctx["k3_launches"] = k3
            ctx["fast_plans"] = compiled.plans
        elif run == "exact-nospec":
            # both count B * n_seg * C * 8 * n_j converts per pass
            assert tot["adc_converts"] == totals["exact"]["no_spec_converts"]
        elif run == "exact-adaptive":
            adaptive_cfg = cfg
            ctx["adaptive_plans"] = compiled.plans
            errs = [sp.error for sp in compiled.sites]
            ctx["k1_launches"] = launches["fused_crossbar"]
            ctx["adaptive_compile_s"] = compile_s
            row.update(
                search_k1_launches=compile_launches["fused_crossbar"],
                slice_histogram=json.dumps(compiled.slice_histogram()),
                distinct_slicings=json.dumps(
                    ["-".join(map(str, sl))
                     for sl in compiled.distinct_slicings()]),
                mean_site_error=sum(errs) / len(errs),
                max_site_error=max(errs))
            assert compile_launches["fused_crossbar"] > 0
        say("serve", **row)
        del compiled, eng
    ctx["k1_compile"] = k1_compile_device_time(params, adaptive_cfg, calib)
    say("serve", scope="Algorithm 1 compile again, under torch.profiler",
        **ctx["k1_compile"])
    sampled = check_sampling(dataclasses.replace(cfg0, pim_mode="exact"),
                             params, ctx["exact_compiled"].plans,
                             reqs[0].prompt)
    say("serve", **sampled)
    for run in ("exact", "exact-nospec", "exact-adaptive"):
        if tokens[run] != tokens["int8"]:
            raise AssertionError(
                f"{run} tokens differ from int8 tokens at the 24b ADC: "
                f"{tokens[run]} vs {tokens['int8']}")
    say("serve", ok=True, exact_equals_int8=True,
        first_tokens=json.dumps(tokens["exact"][0]))
    del params


def k1_compile_device_time(params, cfg, calib) -> dict:
    """Algorithm 1's full-width compile run again under ``torch.profiler``:
    K1's device time summed over its launches (CUPTI kernel records),
    beside every kernel's and the profiled wall time. The serve phase's
    ``compile_s`` is the unprofiled compile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.models import pim
    n0 = fx.KERNEL.launches
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        compiled = pim.compile_pim_params(params, cfg, calib)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fx.KERNEL.launches - n0

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)
    events = prof.key_averages()
    k1 = [e for e in events if "crossbar_kernel" in e.key
          and "sliced" not in e.key]
    kernels = [e for e in events if str(getattr(e, "device_type", "")).endswith(
        "CUDA") and dev_us(e) > 0]
    k1_ms = sum(dev_us(e) for e in k1) / 1e3
    k1_calls = sum(e.count for e in k1)
    if k1_calls != launches or k1_ms <= 0:
        raise AssertionError(f"profiler saw {k1_calls} K1 kernels with "
                             f"{k1_ms} ms; the compile launched {launches}")
    return dict(profiled_compile_s=round(wall_s, 3), k1_launches=launches,
                k1_device_ms=k1_ms,
                all_kernels_device_ms=sum(dev_us(e) for e in kernels) / 1e3,
                slice_histogram=json.dumps(compiled.slice_histogram()))


def check_sampling(cfg, params, plans, prompt) -> dict:
    """A sampled request (temperature 1.0, 8 new tokens) through the
    continuous engine draws the lockstep engine's B = 1 stream for its
    seed on the card; the same seed replays it, another seed does not."""
    import numpy as np
    from repro_torch.serve import ContinuousServeEngine, Request, ServeEngine
    n_new, seed = 8, 5
    max_len = len(prompt) + n_new + 1
    lock = ServeEngine(cfg, params, max_len=max_len, temperature=1.0,
                       plans=plans)
    want = lock.generate(prompt[None], steps=n_new, seed=seed).tokens[0]
    again = lock.generate(prompt[None], steps=n_new, seed=seed).tokens[0]
    other = lock.generate(prompt[None], steps=n_new, seed=seed + 1).tokens[0]
    eng = ContinuousServeEngine(cfg, params, n_slots=4, max_len=max_len,
                                prefill_chunk=64, plans=plans)
    [out] = eng.run([Request(uid=0, prompt=prompt, max_new_tokens=n_new,
                             temperature=1.0, seed=seed)])
    if not (np.array_equal(want, again) and np.array_equal(out.tokens, want)):
        raise AssertionError(
            f"sampled streams differ for seed {seed}: lockstep {want.tolist()}"
            f", replay {again.tolist()}, continuous {out.tokens.tolist()}")
    if np.array_equal(want, other):
        raise AssertionError(f"seeds {seed} and {seed + 1} drew one stream")
    return dict(sampled_mode=cfg.pim_mode, temperature=1.0, seed=seed,
                sampled_continuous_equals_lockstep=True,
                sampled_tokens=json.dumps(want.tolist()))


def step_calls(plans: dict) -> list:
    """One decode step's projections, in the model's order: (name, leaf)
    per layer and projection, then the LM head."""
    out = []
    for lp in plans["layers"]:
        for g, names in (("core", ("wq", "wk", "wv", "wo")),
                         ("ffn", ("w1", "w3", "w2"))):
            out += [(n, lp[g][n]) for n in names]
    return out + [("head", plans["head"])]


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    int8 operations over the tensor-core peak, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, ops=n_ops)


def crossbar_step(plans: dict, slicing: tuple, spec: bool, gen):
    """One decode step's crossbar calls (B = 4 slots, two signed passes per
    projection, codes 0..127) on compiled exact plans: K2's operands
    (``spec``) or K1's, with the bytes and int8 operations they need."""
    import torch
    from repro_torch.kernels import ops
    B, n_i = 4, len(slicing)
    tables_fn = ops.spec_tables if spec else ops.crossbar_tables
    n_counts = n_i + 1 if spec else 1  # int64 counters out
    calls, n_bytes, n_ops = [], 0, 0
    for _, leaf in step_calls(plans):
        n_j, n_seg, rx, C = leaf["planes"].shape
        R = leaf["w_q"].shape[0]
        tables = tables_fn(leaf["planes"], leaf["slice_shifts"], slicing)
        for _ in range(2):
            x = torch.randint(0, 128, (B, R), generator=gen, device="cuda",
                              dtype=torch.int32)
            calls.append((x, tables, leaf["enc_centers"].contiguous()))
            n_bytes += (4 * B * R + n_j * n_seg * rx * C + 4 * n_i * n_j
                        + 4 * n_seg * C + 4 * B * C + 8 * n_counts)
            n_ops += 2 * B * n_seg * rx * C * n_j * n_i
    return calls, n_bytes, n_ops


def k1_batch_tiles(gen) -> dict:
    """K1 at Algorithm 1's B = 16 (1b input slices, 3 planes, the four site
    shapes, 24b ADC) with batch tiles of 1, 2 and 4 rows forced: device
    time per call in µs, each plan held bit for bit against the plain
    version first."""
    import functools
    from repro_torch.kernels import bitplane, ops
    from repro_torch.kernels import fused_crossbar as fx
    kw = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)
    out = {}
    default = fx.tile_plan
    try:
        for site, (R, C) in SITE_SHAPES.items():
            xu, planes, shifts, centers = k2_inputs(16, R, C, gen)
            args = (xu, *ops.crossbar_tables(planes, shifts, ONE_BIT),
                    centers)
            want = fx.plain(*args, **kw)
            for bt in bitplane.BATCH_TILES:
                fx.tile_plan = functools.partial(bitplane.tile_plan, bt=bt)
                compare("fused_crossbar", fx.launch(*args, **kw), want,
                        site=site, B=16, bt=bt)
                out[f"{site}_bt{bt}_us"] = 1e3 * cuda_ms(
                    lambda: fx.launch(*args, **kw), 3)
            del xu, planes, centers, args, want
    finally:
        fx.tile_plan = default
    return out


def phase_timing(ctx: dict, rows: list) -> list:
    """Time one decode step's worth of each kernel's calls (B = 4 slots)
    on the compiled plans: distinct weights per layer, as the model has
    them, so the 50 MB L2 holds none of them between calls. K4, which no
    path calls, is timed at the four projection shapes."""
    import torch
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import fused_spec_crossbar as fs
    from repro_torch.kernels import int8_matmul as im
    gen = torch.Generator(device="cuda").manual_seed(1)
    exact_plans = ctx["exact_compiled"].plans
    kw = dict(adc_lo=-(1 << 23), adc_hi=(1 << 23) - 1)  # the 24b ADC
    # K2: the spec-on exact plans
    k2_calls, k2_bytes, k2_ops = crossbar_step(exact_plans, SPEC, True, gen)

    def k2_step(fn):
        return [fn(x, *t, c, **kw) for x, t, c in k2_calls]
    fails = sum(int(r[1].sum()) for r in k2_step(fs.launch))
    assert fails == 0  # no recovery work at 24b: the bound is the spec dots
    k2 = dict(ms=cuda_ms(lambda: k2_step(fs.launch), 5),
              plain_ms=cuda_ms(lambda: k2_step(fs.plain), 1, warmup=0),
              library_ms=None, calls=len(k2_calls),
              **bound(k2_bytes, k2_ops))
    del k2_calls
    # K2 on Algorithm 1's plans: 3 planes per layer site, 8 on the head
    ka_calls, ka_bytes, ka_ops = crossbar_step(ctx["adaptive_plans"], SPEC,
                                               True, gen)
    k2a = dict(ms=cuda_ms(lambda: [fs.launch(x, *t, c, **kw)
                                   for x, t, c in ka_calls], 5),
               plain_ms=cuda_ms(lambda: [fs.plain(x, *t, c, **kw)
                                         for x, t, c in ka_calls], 1,
                                warmup=0),
               library_ms=None, calls=len(ka_calls),
               **bound(ka_bytes, ka_ops))
    del ka_calls
    # K1: the same plans, speculation off (1b input slices)
    k1_calls, k1_bytes, k1_ops = crossbar_step(exact_plans, ONE_BIT, False,
                                               gen)

    def k1_step(fn):
        return [fn(x, *t, c, **kw) for x, t, c in k1_calls]
    k1 = dict(ms=cuda_ms(lambda: k1_step(fx.launch), 5),
              plain_ms=cuda_ms(lambda: k1_step(fx.plain), 1, warmup=0),
              library_ms=None, calls=len(k1_calls),
              **bound(k1_bytes, k1_ops))
    # K3: one call per projection, int8 codes
    k3_calls, k3_bytes, k3_ops = [], 0, 0
    for _, leaf in step_calls(ctx["fast_plans"]):
        R, C = leaf["w_off"].shape
        x = torch.randint(-127, 128, (4, R), generator=gen, device="cuda",
                          dtype=torch.int8)
        k3_calls.append((x, leaf["w_off"], leaf["centers"]))
        k3_bytes += 4 * R + R * C + 4 * C + 4 * 4 * C
        k3_ops += 2 * 4 * R * C
    lib_calls = [(int_mm_operand(x), w) for x, w, _ in k3_calls]
    k3 = dict(ms=cuda_ms(lambda: [im.launch(*a) for a in k3_calls], 5),
              plain_ms=cuda_ms(lambda: [im.plain(*a) for a in k3_calls], 2),
              # torch._int_mm on x padded with zero rows, no center term
              library_ms=cuda_ms(
                  lambda: [torch._int_mm(*a) for a in lib_calls], 5),
              library_rows=lib_calls[0][0].shape[0], calls=len(k3_calls),
              **bound(k3_bytes, k3_ops))
    # what as many back-to-back launches of an empty kernel take: the
    # share of the step that no kernel design removes
    z = torch.empty(1, device="cuda")
    k3["launch_floor_ms"] = cuda_ms(lambda: [z.zero_() for _ in k3_calls], 5)
    # K4: the kernels phase's four 24b site rows
    k4_rows = [r for r in rows if r["kernel"] == "sliced_crossbar"
               and "kernel_ms" in r]
    k4 = dict(ms=sum(r["kernel_ms"] for r in k4_rows),
              plain_ms=sum(r["plain_ms"] for r in k4_rows),
              library_ms=None, calls=len(k4_rows),
              **bound(sum(r["bytes"] for r in k4_rows),
                      sum(r["ops"] for r in k4_rows)))
    table = (("fused_crossbar", k1, "one decode step, B=4, speculation off"),
             ("fused_spec_crossbar", k2, "one decode step, B=4"),
             ("fused_spec_crossbar", k2a,
              "one decode step, B=4, Algorithm 1's plans"),
             ("centered_int8_matmul", k3, "one decode step, B=4"),
             ("sliced_crossbar", k4, "the four projection shapes, B=4"))
    for name, d, scope in table:
        say("timing", kernel=name, scope=scope, **d)
    say("timing", scope="K1 at B=16 by batch tile, per call",
        **k1_batch_tiles(gen))
    say("timing", scope="Algorithm 1 compile, full width",
        adaptive_compile_s=ctx["adaptive_compile_s"],
        search_k1_launches=ctx["k1_launches"],
        k1_device_ms_in_compile=ctx["k1_compile"]["k1_device_ms"],
        all_kernels_device_ms_in_compile=ctx["k1_compile"][
            "all_kernels_device_ms"],
        profiled_compile_s=ctx["k1_compile"]["profiled_compile_s"])

    def err(kernel):
        return max(r["max_abs_err"] for r in rows if r["kernel"] == kernel)
    meta = {
        "fused_crossbar": ("fused_crossbar.cu", "fused_crossbar.py:104",
                           ctx["k1_launches"]),
        "fused_spec_crossbar": ("fused_spec_crossbar.cu",
                                "fused_spec_crossbar.py:139",
                                ctx["k2_launches"]),
        "centered_int8_matmul": ("centered_int8_matmul.cu",
                                 "int8_matmul.py:51", ctx["k3_launches"]),
        # no caller under src/: never launched on a served path
        "sliced_crossbar": ("sliced_crossbar.cu", "sliced_crossbar.py:65",
                            0)}
    out = []
    for name, d, _ in table:
        if d is k2a:  # the kernels line keeps the main path's K2 step
            continue
        src, rep, launches = meta[name]
        out.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/{rep}", launches=launches,
            max_abs_err=err(name), ms=d["ms"], plain_ms=d["plain_ms"],
            bound_ms=d["bound_ms"], bound_by=d["bound_by"],
            library_ms=d["library_ms"]))
    return out


# ---------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,kernels,serve,timing",
                    help="comma list of phases to run (default: all)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if "timing" in phases and "serve" not in phases:
        ap.error("--phases timing needs serve: it times the plans that the "
                 "serve phase compiles")
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
    print(smi, flush=True)  # again, within the tail a log keeps
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
