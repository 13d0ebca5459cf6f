"""What the PIM layer's simulated counters must read for a window.

Plain arithmetic from the configuration (no import of the program). With
speculation on, each projection's signed input runs as two unsigned
passes; a pass attempts one conversion per row, 512-row segment, column,
speculation slice and weight slice, and a failed conversion adds one
recovery conversion per bit of its speculation slice (paper §4.3). At the
configuration's ADC no conversion can saturate when the largest column
sum a segment can produce lies inside the ADC's range, so failures are 0
and converts are the attempts.

The port bills its counters where the reference does: every projection
of a decode step, and of a prefill chunk or a full-sequence forward only
the LM head (their layer stacks run with the collector suspended). The
drivers hand the billed engine calls as ``(layer_rows, head_rows)``.
"""

from __future__ import annotations

import math

PASSES = 2


def attempts(B: int, R: int, C: int, pim: dict) -> int:
    n_seg = math.ceil(R / pim["rows_per_crossbar"])
    return (PASSES * B * n_seg * C * len(pim["spec_slicing"])
            * len(pim["pim_weight_slicing"]))


def max_column_sum(pim: dict) -> int:
    """The largest |column sum| one conversion can see: a segment's rows,
    each an input slice at its widest times a weight slice at its widest
    (a signed slice of w bits lies within 2 ** w)."""
    x_max = (1 << max(pim["spec_slicing"])) - 1
    w_max = 1 << max(pim["pim_weight_slicing"])
    return pim["rows_per_crossbar"] * x_max * w_max


def lossless(pim: dict) -> bool:
    """No conversion can saturate at the configuration's signed ADC."""
    return max_column_sum(pim) < (1 << (pim["pim_adc_bits"] - 1)) - 1


def expected(model: dict, pim: dict, billed) -> dict:
    """``adc_converts`` and ``spec_failures`` of the billed engine calls,
    at a lossless ADC."""
    if not lossless(pim):
        raise ValueError("the expected counters are known only at an ADC "
                         "that cannot saturate")
    d, f, hd = model["d_model"], model["d_ff"], model["head_dim"]
    h, kv = model["n_heads"], model["n_kv_heads"]
    layer = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d),
             (d, f), (d, f), (f, d)]
    head = (d, model["vocab_size"])
    total = 0
    for layer_rows, head_rows in billed:
        if layer_rows:
            total += model["n_layers"] * sum(
                attempts(layer_rows, R, C, pim) for R, C in layer)
        if head_rows:
            total += attempts(head_rows, *head, pim)
    return {"adc_converts": total, "spec_failures": 0}
