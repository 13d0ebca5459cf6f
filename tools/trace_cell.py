#!/usr/bin/env python3
"""One cell of the benchmark, traced, with the port's span recorder over
the window: the card's idle time named by the program's own spans.

    python3 tools/trace_cell.py --workload <name> --seed <n>
        [--seconds 30] [--windows on,off] [--check 1] [--dump DIR]

from the root of a checkout, on an NVIDIA card. Sets the cell up as
``bench/run.py`` does, then runs one traced window for each entry of
``--windows`` back to back (``on``: the recorder installed; ``off``: the
clock pairs alone, the window as ``bench/run.py --trace 1`` runs it;
``raw``: the recorder stamping with ``CLOCK_MONOTONIC_RAW``, the host's
clock without the time service's slewing, paired as the default one is;
only its copy checks count: the harness's spans and the window's start
are not on its map) and
reduces each with
``bench/core/program_trace.summary``. Prints one JSON
line a window: iterations and their rate; ``busy_s`` and the kernel times
of ``trace.summary`` and of the new summary and whether they are equal;
the cell's per-layer metrics read from the new summary; the program
readers (``idle_pim_host``, ``idle_engine_host``, ``pim_host_us``,
``host_syncs_per_iter``); idle seconds, syncs and mean host microseconds
by span; the breakdown's idle gaps; the token and logits copies against
the spans that issue them under three clock maps (the profiler's clock
pairs, Unix-clock pairs, the first device record's offset; the first two
are one where torch lacks the approximate clock's bindings), where each
copy outside its span lies, each token copy's end margin over the window,
and that offset's error at the window's start, where every copy record
lies by innermost span (a copy the profiler lost lies nowhere), and the
program readers with every span moved 300 us either way on the map.
``--dump DIR`` also writes each window's device intervals, copies and
spans there (``dump``). With ``--check 1`` the last
window's outputs are checked against the plain reference and ``correct``
is printed as ``bench/run.py`` prints it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.core import env  # noqa: E402

env.prepare()

import torch  # noqa: E402

from bench import run as harness  # noqa: E402
from bench.core import program_trace as pt  # noqa: E402
from bench.core import spec as specs, trace  # noqa: E402

READERS = {"idle_pim_host": pt.idle_pim_host,
           "idle_engine_host": pt.idle_engine_host,
           "pim_host_us": pt.pim_host_us,
           "host_syncs_per_iter": pt.host_syncs_per_iter}


class PairedTracer(pt.ProgramTracer):
    """``ProgramTracer`` that also pairs the host clock with the Unix
    clock, to compare that map with the profiler clock's."""

    def __enter__(self):
        super().__enter__()
        from repro_torch.obs import tracing
        self.unix = tracing.ProfilerClock(other=time.time_ns)
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            torch.cuda.synchronize()
            self.unix.read()
        return super().__exit__(*exc)


def by_span(program: dict) -> dict:
    """Count and mean host microseconds of the program's spans by name."""
    out: dict = {}
    for name, t0, t1, _, _ in program["spans"]:
        n, s = out.get(name, (0, 0))
        out[name] = (n + 1, s + t1 - t0)
    return {k: [n, round(s / n / 1e3, 3)] for k, (n, s) in out.items()}


def copy_misses(records: list, program: dict) -> dict:
    """Where the copies that ``program_trace.copy_checks`` misses lie: for
    each decode ``fetch`` and each ``h2d_tokens`` span, the nearest
    ``Memcpy DtoH`` end / ``Memcpy HtoD`` start to the span's end, in us
    past it (positive: after the span ended), with the span's place in the
    window (0 to 1); the copies' and the spans' counts."""
    import numpy as np
    prog = pt.mapped_spans(program)
    if not prog:
        return {}
    w0, w1 = prog[0][1], max(s[2] for s in prog)
    out = {}
    for kind, pat, col in (("fetch", pt.DTOH, 2), ("h2d_tokens", pt.HTOD, 1)):
        pts = np.sort(np.array([r[col] for r in records if pat.search(r[0])],
                               dtype=np.int64))
        rows = []
        for name, a, b, parent, _ in prog:
            if name != kind or (kind == "fetch"
                                and prog[parent][0] != "decode_step"):
                continue
            i = np.searchsorted(pts, b)
            near = [pts[j] for j in (i - 1, i) if 0 <= j < len(pts)]
            p = min(near, key=lambda x: abs(int(x) - b)) if near else None
            inside = p is not None and a <= p <= b
            rows.append((None if p is None else (int(p) - b) / 1e3,
                         (a - w0) / max(w1 - w0, 1), inside))
        miss = [r for r in rows if not r[2]]
        out[kind] = {"copies": int(len(pts)), "spans": len(rows),
                     "misses": len(miss),
                     "miss_us_place": [[None if m is None else round(m, 1),
                                        round(f, 3)] for m, f, _ in miss[:25]],
                     "inside_us_quartiles": np.percentile(
                         [r[0] for r in rows if r[2]], [0, 25, 50, 75, 100]
                     ).round(1).tolist() if any(r[2] for r in rows) else []}
    # the host's return after each token copy: the span's end less the
    # nearest HtoD record's end, by the span's place in the window; the
    # host blocks until the copy is done, so on an exact map this is
    # positive (on an H100, 15 us to 2.4 ms in windows the map held)
    ends = np.sort(np.array([r[2] for r in records if pt.HTOD.search(r[0])],
                            dtype=np.int64))
    margin = []
    for name, a, b, _, _ in prog:
        if name == "h2d_tokens" and len(ends):
            i = np.searchsorted(ends, b)
            j = min((k for k in (i - 1, i) if 0 <= k < len(ends)),
                    key=lambda k: abs(int(ends[k]) - b))
            margin.append([round((a - w0) / max(w1 - w0, 1), 4),
                           round((b - int(ends[j])) / 1e3, 1)])
    out["h2d_end_margin_us"] = margin
    return out


def shifted(tracer, rec: dict, cell, us: int) -> dict:
    """The program readers with every host span moved ``us`` on the
    device clock: how far a map that is off by that much moves them."""
    prog = rec["program"]
    moved = dict(prog, clock=[[h, d + us * 1000] for h, d in prog["clock"]])
    r = dict(rec, program=moved,
             trace=pt.summary(tracer, rec["spans"], moved, rec["window_s"]))
    return {k: f(r, cell) for k, f in READERS.items()}


def dump(path: str, tracer, rec: dict) -> None:
    """The window's reduction inputs, for study off the card: the merged
    device intervals and the copy records (``<path>.npz``), the program's
    and the harness's spans and the window (``<path>.json``)."""
    import numpy as np
    copies = [r for r in tracer.records if r[0].startswith("Memcpy")]
    np.savez_compressed(
        path + ".npz", busy=np.array(trace.merge(
            [(s, e) for _, s, e in tracer.records]), dtype=np.int64),
        copies=np.array([[s, e] for _, s, e in copies], dtype=np.int64))
    with open(path + ".json", "w") as f:
        json.dump({"copy_names": [r[0] for r in copies],
                   "program": rec["program"], "spans": rec["spans"],
                   "host_start_ns": tracer.host_start_ns,
                   "window_s": rec["window_s"]}, f)


def one_window(drv, cell, seconds: float, recorder: bool,
               info: dict, host_ns=None) -> tuple:
    tracer = PairedTracer(True, recorder=recorder, host_ns=host_ns)
    rec = drv.window(seconds, tracer)
    rec.update(info)
    rec["program"] = program = tracer.recorded()
    old = trace.summary(tracer, rec["spans"])
    new = pt.summary(tracer, rec["spans"], program, rec["window_s"])
    rec["trace"] = new
    err_ns = round(new["old_offset_error_us"] * 1e3)
    w0 = pt.clock_map(program)(tracer.host_start_ns)
    um = tracer.unix.map()
    unix = dict(program, clock=[[h, um(h)] for h, _ in (
        tracer.unix.pairs[0], tracer.unix.pairs[-1])])
    line = {
        "window": "on" if recorder else "off",
        "window_s": rec["window_s"], "iterations": rec["iterations"],
        "iterations_per_s": rec["iterations"] / rec["window_s"],
        "stop_s": tracer.stop_s, "read_s": tracer.read_s,
        "records": len(tracer.records),
        # the first record's start and the last one's end, in s from the
        # window's start on the map (the window ends at window_s)
        "records_cover_s": [(min(r[1] for r in tracer.records) - w0) / 1e9,
                            (max(r[2] for r in tracer.records) - w0) / 1e9],
        "busy_s": [old["busy_s"], new["busy_s"]],
        "same_busy_and_kernels": old["busy_s"] == new["busy_s"]
        and old["kernels"] == new["kernels"],
        "per_layer": {m["name"]: specs.reader(m["name"]).read(rec, cell)
                      for m in cell.per_layer},
        "program": {k: f(rec, cell) for k, f in READERS.items()},
        "counters": program["counters"],
        "spans": by_span(program),
        "idle_s_by_span": new["idle_by_span"],
        "syncs_by_span": new["syncs_by_span"],
        "idle_gaps": new["breakdown"]["idle_gaps"],
        "old_idle_gaps": old["breakdown"]["idle_gaps"],
        "old_offset_error_us": new["old_offset_error_us"],
        "unix_minus_profiler_us": (um(tracer.host_start_ns) - pt.clock_map(
            program)(tracer.host_start_ns)) / 1e3,
        "copies": pt.copy_checks(tracer.records, program),
        "copies_unix_pairs": pt.copy_checks(tracer.records, unix),
        "copies_old_offset": pt.copy_checks(tracer.records, program,
                                            shift_ns=err_ns),
        "copy_places": pt.copy_places(tracer.records, program),
        "readers_if_map_off_us": {str(us): shifted(tracer, rec, cell, us)
                                  for us in (-300, 300)},
        "copy_misses": copy_misses(tracer.records, program)}
    return rec, line, tracer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--windows", default="on,off")
    ap.add_argument("--check", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", default=None,
                    help="a directory to write each window's records to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    cell = specs.cell(args.workload)
    drv = specs.driver(cell.traffic["driver"]).Driver(cell, args.seed,
                                                      "cuda")
    t0 = time.perf_counter()
    info = {"compile_s": drv.setup()["compile_s"]}
    info["setup_s"] = time.perf_counter() - t0
    print(json.dumps({"workload": args.workload, "seed": args.seed, **info,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    rec = None
    for i, w in enumerate(args.windows.split(",")):
        # "raw": the recorder stamps with CLOCK_MONOTONIC_RAW
        host = ((lambda: time.clock_gettime_ns(time.CLOCK_MONOTONIC_RAW))
                if w == "raw" else None)
        rec, line, tracer = one_window(drv, cell, args.seconds, w != "off",
                                       info, host)
        line["window"] = w
        print(json.dumps(line), flush=True)
        if args.dump:
            dump(f"{args.dump}/{args.workload}.{args.seed}.{i}.{w}", tracer,
                 rec)
    if args.check:
        drv.release()
        out = {"cell": cell, "rec": rec, "numbers": drv.check(rec),
               "failed": drv.failed()}
        numbers = {k: out["numbers"][k] for k in harness.COMPARED}
        ok, checks = harness.compare.verdict(numbers, cell.limits)
        print(json.dumps({"correct": ok and out["failed"] == 0,
                          "failed": out["failed"], "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
