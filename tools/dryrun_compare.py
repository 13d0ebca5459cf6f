"""The reference's and the port's dry-run reports side by side.

Reads the per-cell JSON reports that both packages' dry runs write with
``--out`` (``<arch>_<shape>_<sp|mp>.json``) and prints, for every cell in
the port's directory, a markdown row: per-device GiB and flops of each,
their ratios, whether the port's cell fits the H100's 80 GB, and the
port's bottleneck; then collective bytes per device of each, their
ratio, and each side's bottleneck computed with the H100's constants
(``repro_torch.launch.hlo_analysis.roofline_terms`` on the report's flops,
HBM bytes and collective bytes, as compute / memory / collective seconds:
the reference's own report prices them on TPU v5e). Cells missing from
the reference's directory, or not ``ok`` there, show "—".

Usage:
  PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun \\
      --arch yi-6b --shape train_4k --out ref/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --device cpu --out port/
  python tools/dryrun_compare.py ref/ port/
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def _load(d: Path) -> dict:
    out = {}
    for f in sorted(d.glob("*_*_[sm]p.json")):
        r = json.loads(f.read_text())
        out[(r["arch"], r["shape"], bool(r["multi_pod"]))] = r
    return out


def rows(ref_dir: str, port_dir: str) -> list[str]:
    ref, port = _load(Path(ref_dir)), _load(Path(port_dir))
    lines = ["| cell | mesh | ref GiB | port GiB | GiB ratio | ref flops "
             "| port flops | flops ratio | fits 80 GB | port bound "
             "| ref coll B | port coll B | coll ratio | ref bound (H100) "
             "| port bound (H100) |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- "
             "| --- | --- | --- | --- | --- |"]
    for key in sorted(port):
        p = port[key]
        if p.get("status") != "ok":
            continue
        r = ref.get(key, {})
        ok = r.get("status") == "ok"
        rg = f"{r['per_device_gib']}" if ok else "—"
        rf = f"{r['hlo_flops_per_device']:.4e}" if ok else "—"
        gr = (f"{p['per_device_bytes'] / r['per_device_bytes']:.2f}"
              if ok else "—")
        fr = (f"{p['hlo_flops_per_device'] / r['hlo_flops_per_device']:.3f}"
              if ok else "—")
        pc = p["collective_bytes_per_device"]
        rc = f"{r['collective_bytes_per_device']:.4e}" if ok else "—"
        cr = (f"{pc / r['collective_bytes_per_device']:.3f}"
              if ok and r["collective_bytes_per_device"] else "—")
        lines.append(
            f"| {key[0]} {key[1]} | {'2x16x16' if key[2] else '16x16'} "
            f"| {rg} | {p['per_device_gib']} | {gr} | {rf} "
            f"| {p['hlo_flops_per_device']:.4e} | {fr} | {p['fits_hbm']} "
            f"| {p['bottleneck']} | {rc} | {pc:.4e} | {cr} "
            f"| {_bound(r) if ok else '—'} | {_bound(p)} |")
    return lines


def _bound(r: dict) -> str:
    """The bottleneck of a report's counts on the H100's constants, and
    its three terms in seconds (compute / memory / collective)."""
    from repro_torch.launch import hlo_analysis as hlo
    t = hlo.roofline_terms(r["hlo_flops_per_device"],
                           r["hlo_bytes_per_device"],
                           r["collective_bytes_per_device"])
    return (f"{t['bottleneck']} {t['compute_s']:.3e} / {t['memory_s']:.3e}"
            f" / {t['collective_s']:.3e}")


if __name__ == "__main__":
    print("\n".join(rows(*sys.argv[1:3])))
