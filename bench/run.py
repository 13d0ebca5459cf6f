#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``), on
a machine with the NVIDIA cards the cell asks for. The run makes its
weights and traffic from the seed, compiles the PIM plans, warms up the
cell's shapes (all of that is ``setup_s``), measures ``--seconds``, then
checks what the window produced against the plain reference
(``bench/reference``) and prints, as its last lines on standard error,
each compared number beside its limit, and as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced, the
``breakdown``; the compared numbers come last, under ``checks``.

It exits non-zero with no result when CUDA or the cell's cards are
missing, when the port is missing, and when the process has loaded JAX or
the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.core import env  # noqa: E402

env.prepare()

import torch  # noqa: E402

from bench.core import spec as specs, trace  # noqa: E402
from bench.reference import compare  # noqa: E402

COMPARED = ("top_gap", "converts_diff", "spec_failures")


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", control: bool = False, root: Path = ROOT,
             t_start: float | None = None, cell=None) -> dict:
    """Set up, measure and check one cell; returns the record, the
    compared numbers and the peak memory. The caller has checked for the
    cards (tests run it on the CPU at a small size)."""
    t_start = T_START if t_start is None else t_start
    cell = specs.cell(workload, root) if cell is None else cell
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    drv = specs.driver(cell.traffic["driver"], root).Driver(cell, seed,
                                                             device)
    info = drv.setup()
    setup_s = time.perf_counter() - t_start
    tracer = trace.Tracer(traced)
    rec = drv.window(seconds, tracer)
    rec.update(setup_s=setup_s, compile_s=info["compile_s"])
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    t0 = time.perf_counter()
    rec["trace"] = trace.summary(tracer, rec["spans"]) if traced else None
    if traced:
        rec["trace_s"] = {"stop": tracer.stop_s, "read": tracer.read_s,
                          "reduce": time.perf_counter() - t0,
                          "records": len(tracer.records)}
    loaded = env.forbidden_loaded()
    drv.release()
    numbers = drv.check(rec, control=control)
    return {"cell": cell, "rec": rec, "numbers": numbers,
            "failed": drv.failed(), "peak": peak, "forbidden": loaded}


def metrics(out: dict, traced: bool, root: Path = ROOT) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), each computed by its own file; a reader that finds nothing
    to read leaves its metric out."""
    cell, rec = out["cell"], out["rec"]
    result = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        if traced:
            value = specs.reader(m["name"], root).read(rec, cell)
        else:
            value = specs.e2e_module(m["name"], root).compute(rec, cell)
        if value is not None:
            result[m["name"]] = {"value": value, "unit": m["unit"]}
    return result


def result_line(out: dict, traced: bool, device: dict) -> tuple[dict, bool]:
    limits = out["cell"].limits
    numbers = {k: out["numbers"][k] for k in COMPARED}
    ok, checks = compare.verdict(numbers, limits)
    correct = ok and out["failed"] == 0
    line = {"correct": correct, "attempted": out["rec"]["attempted"],
            "failed": out["failed"], "metrics": metrics(out, traced),
            "device": device}
    if traced and out["rec"]["trace"] is not None:
        line["breakdown"] = out["rec"]["trace"]["breakdown"]
    line["checks"] = checks
    return line, correct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = specs.cell(args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no port at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    traced = bool(args.trace)
    out = run_cell(args.workload, args.seed, args.seconds, traced, cell=cell)
    if out["forbidden"] or env.forbidden_loaded():
        print("loaded forbidden modules: "
              f"{sorted(set(out['forbidden']) | set(env.forbidden_loaded()))}",
              file=sys.stderr)
        return 3
    rec = out["rec"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out["peak"]}
    if traced:
        busy = rec["trace"]["busy_s"] if rec["trace"] else 0.0
        device.update(busy_s=busy, window_s=rec["window_s"])
    line, correct = result_line(out, traced, device)
    extra = {k: v for k, v in out["numbers"].items() if k not in COMPARED}
    if "trace_s" in rec:
        extra["trace_s"] = rec["trace_s"]
    steps = sorted(rec.get("decode_only_step_s", []))
    if steps:
        extra["decode_only_step_ms_p10_p50_p90"] = [
            round(1e3 * steps[int(q * (len(steps) - 1))], 2)
            for q in (0.1, 0.5, 0.9)]
    print(f"window: {rec['window_s']:.3f} s, {rec['iterations']} iterations, "
          f"setup {rec['setup_s']:.3f} s (compile {rec['compile_s']:.3f} s), "
          f"{json.dumps(extra)}", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
