"""The comparison that decides ``correct``.

``top_gap``: at each compared position, how far below the reference's best
logit the reference puts the token the program chose (served greedily, or
the program's own argmax), in units of the reference logits' standard
deviation at that position; the number compared is the widest such gap.
A sound program chooses the reference's best token, or one within
rounding of it on a near tie; a program that computes something else
chooses tokens the reference ranks lower.

The control reads the same gap for the token that the reference computed
one precision lower (``DenseReference(..., bits=4)``) puts first, at the
same positions of the same sequences.

``converts_diff`` and ``spec_failures``: the PIM layer's simulated
counters against what the configuration's arithmetic must bill
(``counters.py``), compared exactly.
"""

from __future__ import annotations

import torch


def top_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(n, V) reference logits and (n,) chosen ids -> (n,) gaps."""
    best = ref_logits.max(dim=-1).values
    chosen = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return (best - chosen) / ref_logits.std(dim=-1)


def widest(gaps: list) -> float:
    return float(max(float(g.max()) for g in gaps if g.numel()))


def control_gaps(ref_logits: torch.Tensor,
                 control_logits: torch.Tensor) -> torch.Tensor:
    return top_gaps(ref_logits, control_logits.argmax(dim=-1))


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit: a number
    passes when it is at most its limit (an exact comparison's limit is
    0)."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v is not None and v <= limits[k] for k, v in numbers.items())
    return ok, out
