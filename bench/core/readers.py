"""What the per-layer metrics' readers share: each reads a run's record
(``drivers/*.window`` plus the traced window's summary) and returns its
number, or None when the record holds nothing to read (an untraced run,
no K2 record, no generated token). A share of a roofline or of a peak is
never made up as 0."""

from __future__ import annotations

import re

from bench.work import model as work

K2_KERNEL = r"\bspec_kernel\b"  # K2's CUDA kernel (fused_spec_crossbar.cu)


def k2_roofline(rec: dict, cell) -> float | None:
    """The least time the window's K2 work needs (``bench/work``) over
    K2's device time summed from the traced window's records, in %."""
    tr = rec.get("trace")
    if not tr:
        return None
    k2_s = sum(s for name, (_, s) in tr["kernels"].items()
               if re.search(K2_KERNEL, name))
    if k2_s <= 0:
        return None
    ops, nbytes = work.k2_work(cell.config["model"], cell.config["pim"],
                               rec["k2_calls"])
    return 100.0 * work.least_seconds(ops, nbytes) / k2_s


def device_idle(rec: dict, cell) -> float | None:
    """The share of the window in which no device record runs, in %."""
    tr = rec.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / rec["window_s"])


def mfu(rec: dict, cell) -> float | None:
    """The model's useful int8 operations over the window's seconds and
    the card's int8 peak, in %."""
    u = rec["useful"]
    ops = work.useful_ops(cell.config["model"], u["layer_rows"],
                          u["head_rows"], u["attn_context"])
    if ops <= 0:
        return None
    return 100.0 * ops / rec["window_s"] / work.INT8_OPS_PER_S


def pim_launches(rec: dict) -> int:
    return sum(rec["launches"].values())
