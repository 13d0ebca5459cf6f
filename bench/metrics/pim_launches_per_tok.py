"""``pim_launches_per_tok`` (PIM layer): the PIM kernels' launches over
the window (``kernels.ops.launch_counts()``) per token generated."""

from bench.core.readers import pim_launches


def read(rec: dict, cell) -> float | None:
    return pim_launches(rec) / rec["tokens"] if rec["tokens"] else None
