"""``tpot_p95_ms``: the 95th percentile of every gap between consecutive
tokens of every request in the window, each token stamped at the return of
the ``step()`` that delivered it (host clock; two tokens of one step are 0
apart)."""

import numpy as np


def compute(rec: dict, cell) -> float | None:
    gaps = rec["token_gaps_s"]
    return 1e3 * float(np.percentile(gaps, 95)) if gaps else None
