"""``pim_launches_per_kpos.input`` (PIM layer): the PIM kernels' launches over
the window (``kernels.ops.launch_counts()``) per 1,000 positions forwarded."""

from bench.core.readers import pim_launches


def read(rec: dict, cell) -> float | None:
    n = rec["input_positions"]
    return 1e3 * pim_launches(rec) / n if n else None
