"""The reference's compiled program of one dry-run cell: its largest dots
and its collectives by result shape.

Lowers and compiles the cell exactly as ``repro.launch.dryrun.dryrun_cell``
does (the reference's own function, run unchanged; this script only keeps
the compiled HLO text that the function hands to its cost parser), then
walks the HLO from the entry computation, each while body weighted by its
trip count (``repro.launch.hlo_analysis``'s rule), and prints:

- the dots grouped by result type, largest total flops first: count per
  step, flops each and in all, share of the cell's dot flops;
- the all-gathers, all-reduces and reduce-scatters grouped by result type
  and group size: count per step and link bytes in all, with the
  reference's ring factors (``hlo_analysis._collective_link_bytes``).

It imports jax and the reference read-only and lives outside both
packages. Usage (seconds to minutes a cell on a CPU; a train cell
compiles its backward):

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ref_hlo_dots.py \\
      --arch qwen1.5-0.5b --shape prefill_32k [--top 12] [--multi-pod] \\
      [--licm]
"""

from __future__ import annotations

import argparse
import re
import sys
from collections import defaultdict


LICM_OFF = "--xla_disable_hlo_passes=while-loop-invariant-code-motion"


def compiled_text(arch: str, shape: str, multi_pod: bool,
                  licm: bool = False) -> tuple:
    """The reference's dry-run report of the cell and its compiled HLO.
    ``licm`` drops the flag by which the reference's dry run disables
    XLA's while-loop-invariant code motion (set at its import, read when
    jax's CPU backend starts), to show what that pass would hoist."""
    import os
    from repro.launch import dryrun as rdry  # sets XLA_FLAGS before jax
    if licm:
        os.environ["XLA_FLAGS"] = os.environ["XLA_FLAGS"].replace(
            LICM_OFF, "")
    texts = []
    parse = rdry.hlo.analyze

    def keep(txt, *a, **k):
        texts.append(txt)
        return parse(txt, *a, **k)
    rdry.hlo.analyze = keep
    try:
        report = rdry.dryrun_cell(arch, shape, multi_pod=multi_pod,
                                  verbose=False)
    finally:
        rdry.hlo.analyze = parse
    if not texts:
        raise SystemExit(f"{arch} {shape}: {report.get('status')} "
                         f"{report.get('reason', '')}")
    return report, texts[0]


def walk(txt: str) -> tuple[dict, dict]:
    """(dots, collectives): ``{type: [count, flops]}`` and ``{(kind,
    type, group): [count, link bytes]}`` per step, while bodies weighted
    by their trip counts."""
    from repro.launch import hlo_analysis as rhlo
    comps = rhlo.parse_computations(txt)
    m = re.search(r"^ENTRY %?([\w.\-]+)", txt, re.M)
    dots: dict = defaultdict(lambda: [0, 0.0])
    colls: dict = defaultdict(lambda: [0, 0.0])

    def visit(name: str, mult: int) -> None:
        comp = comps.get(name)
        if comp is None:
            return
        for ins in comp.instrs:
            if ins.op == "while":
                b, c = rhlo._BODY.search(ins.line), rhlo._COND.search(
                    ins.line)
                trips = rhlo._trip_count(comps, ins.line,
                                         c.group(1) if c else "")
                if b:
                    visit(b.group(1), mult * max(trips, 1))
                continue
            if ins.op in ("fusion", "call", "custom-call", "conditional",
                          "async-start"):
                for sub in rhlo._CALLS.findall(ins.line):
                    visit(sub, mult)
            if ins.op in ("dot", "convolution"):
                d = dots[ins.type_str.split("{")[0]]
                d[0] += mult
                d[1] += mult * rhlo._dot_flops(comp, ins)
            kind = next((k for k in ("all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all")
                         if ins.op.startswith(k)), None)
            if kind and not ins.op.endswith("-done"):
                _, link = rhlo._collective_link_bytes(ins)
                key = (kind, ins.type_str.split("{")[0],
                       rhlo._group_size(ins.line))
                colls[key][0] += mult
                colls[key][1] += mult * link
    visit(m.group(1) if m else next(iter(comps)), 1)
    return dict(dots), dict(colls)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--licm", action="store_true",
                    help="compile with while-loop-invariant code motion, "
                    "which the reference's dry run disables")
    args = ap.parse_args(argv)
    report, txt = compiled_text(args.arch, args.shape, args.multi_pod,
                                args.licm)
    dots, colls = walk(txt)
    total = sum(f for _, f in dots.values()) or 1.0
    print(f"# {args.arch} {args.shape} "
          f"{'2x16x16' if args.multi_pod else '16x16'}"
          f"{' (loop-invariant code motion on)' if args.licm else ''}: "
          f"{report['hlo_flops_per_device']:.4e} flops, "
          f"{report['collective_bytes_per_device']:.4e} collective B, "
          f"{report['per_device_gib']} GiB a device")
    print(f"## dots, {len(dots)} result types, largest first")
    print("| result | count | flops each | flops | share |")
    print("| --- | --- | --- | --- | --- |")
    for t, (n, f) in sorted(dots.items(), key=lambda kv: -kv[1][1])[
            :args.top]:
        print(f"| {t} | {n} | {f / n:.4e} | {f:.4e} | {f / total:.4f} |")
    print("## collectives by result type and group size, most bytes first")
    print("| kind | result | group | count | link bytes |")
    print("| --- | --- | --- | --- | --- |")
    for (k, t, g), (n, b) in sorted(colls.items(), key=lambda kv: -kv[1][1])[
            :args.top]:
        print(f"| {k} | {t} | {g} | {n} | {b:.4e} |")
    by_kind: dict = defaultdict(lambda: [0, 0.0])
    for (k, _, _), (n, b) in colls.items():
        by_kind[k][0] += n
        by_kind[k][1] += b
    print("## totals: " + ", ".join(
        f"{k} {n} calls {b:.4e} B" for k, (n, b) in sorted(by_kind.items())))


if __name__ == "__main__":
    sys.exit(main())
