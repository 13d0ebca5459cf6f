"""Table 1: slicing tradeoffs — bits/MAC vs ADC converts/MAC, exact.

Port of the reference's ``benchmarks/table1_slicing.py``: pure Python,
its asserts kept.
"""

from __future__ import annotations


def run() -> list[dict]:
    """2b input x 2b weight, every slicing combination (paper Table 1)."""
    cases = [
        ("unsliced", (2,), (2,)),
        ("input-sliced", (1, 1), (2,)),
        ("weight-sliced", (2,), (1, 1)),
        ("both-sliced", (1, 1), (1, 1)),
    ]
    rows = []
    for name, i_s, w_s in cases:
        rows.append({"case": name, "bits_per_mac": max(i_s) * max(w_s),
                     "converts_per_mac": len(i_s) * len(w_s),
                     "cycles": len(i_s), "columns": len(w_s)})
    # paper's numbers: bits/MAC 4,2,2,1 and converts/MAC 1(x4 scale),2,2,4
    assert [r["bits_per_mac"] for r in rows] == [4, 2, 2, 1]
    assert [r["converts_per_mac"] for r in rows] == [1, 2, 2, 4]
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
