"""Work and bytes of a window, the single source of ``k2_roofline.*`` and
``mfu.*``.

Counted from the model's projection shapes, the rows the window processed
and the configuration's stated slicing, never from launches or call
arguments, so a program that fuses the two signed passes into one launch,
or batches prefill chunks, is held to the same count.

K2 (``fused_spec_crossbar``) executes each weight-static projection of an
engine call on that call's rows, in two signed passes. Per projection
execution at ``B`` rows of an ``R x C`` weight, with ``n_j`` weight slices
and ``n_i`` speculation slices (a frozen copy of ``chip_smoke.py``'s
``kernel_calls`` arithmetic, operations over the true R rows):

  operations  2 passes x 2 x B x R x C x n_j x n_i
  bytes       n_j x n_seg x 512 x C   the weight planes, read once
              + 4 B R                 the int32 input codes, read once
              + 4 n_seg C             the Center+Offset centers
              + 4 B C                 the int32 result

The model's useful operations (``mfu``) are those of the int8 products it
asks for, 2 x rows x R x C per projection executed on a useful row (a
decode step's live slots, a prefill chunk's positions, the head on the
rows whose logits are used), plus attention's two products, 4 x heads x
head_dim x context per query row and layer.
"""

from __future__ import annotations

import math

# H100 SXM published peaks (NVIDIA data sheet), dense
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
PASSES = 2  # signed inputs run as two unsigned passes (paper §5.1)


def layer_projections(model: dict) -> list[tuple[str, int, int]]:
    """``(name, R, C)`` of one layer's weight-static projections."""
    d, f, hd = model["d_model"], model["d_ff"], model["head_dim"]
    h, kv = model["n_heads"], model["n_kv_heads"]
    return [("wq", d, h * hd), ("wk", d, kv * hd), ("wv", d, kv * hd),
            ("wo", h * hd, d), ("w1", d, f), ("w3", d, f), ("w2", f, d)]


def head_projection(model: dict) -> tuple[int, int]:
    return model["d_model"], model["vocab_size"]


def slices(pim: dict) -> tuple[int, int]:
    """``(n_j, n_i)``: weight slices and speculation slices."""
    return len(pim["pim_weight_slicing"]), len(pim["spec_slicing"])


def k2_execution(B: int, R: int, C: int, n_j: int, n_i: int,
                 rows_per_xbar: int = 512) -> tuple[int, int]:
    """Operations and bytes of one projection executed at ``B`` rows."""
    n_seg = math.ceil(R / rows_per_xbar)
    ops = PASSES * 2 * B * R * C * n_j * n_i
    nbytes = (n_j * n_seg * rows_per_xbar * C + 4 * B * R + 4 * n_seg * C
              + 4 * B * C)
    return ops, nbytes


def k2_work_of(executions, pim: dict) -> tuple[int, int]:
    """Operations and bytes of ``(B, R, C)`` projection executions."""
    n_j, n_i = slices(pim)
    ops = nbytes = 0
    for B, R, C in executions:
        o, b = k2_execution(B, R, C, n_j, n_i, pim["rows_per_crossbar"])
        ops += o
        nbytes += b
    return ops, nbytes


def executions_of(launches) -> list[tuple[int, int, int]]:
    """The projection executions behind K2 launch records, each record a
    dict with the execution it served (``execution``) and its ``B``, ``R``,
    ``C``: one execution however many launches (one per signed pass, or
    one for both) it took."""
    seen: dict = {}
    for rec in launches:
        seen.setdefault(rec["execution"], (rec["B"], rec["R"], rec["C"]))
    return list(seen.values())


def window_executions(model: dict, calls: list[tuple[int, int]]
                      ) -> list[tuple[int, int, int]]:
    """Every projection execution of engine calls given as ``(layer_rows,
    head_rows)``: each layer projection at ``layer_rows``, the head at
    ``head_rows`` (0: the call ran no head)."""
    layer = layer_projections(model)
    R_h, C_h = head_projection(model)
    out = []
    for layer_rows, head_rows in calls:
        if layer_rows:
            out += [(layer_rows, R, C) for _ in range(model["n_layers"])
                    for _, R, C in layer]
        if head_rows:
            out.append((head_rows, R_h, C_h))
    return out


def k2_work(model: dict, pim: dict, calls) -> tuple[int, int]:
    """Operations and bytes of a window's engine calls, ``(layer_rows,
    head_rows)`` each, summed in closed form (a window holds thousands)."""
    n_j, n_i = slices(pim)
    rx = pim["rows_per_crossbar"]
    per_layer = [(R, C) for _, R, C in layer_projections(model)] \
        * model["n_layers"]
    head = head_projection(model)
    ops = nbytes = 0
    for shapes, rows in ((per_layer, [c[0] for c in calls]),
                         ([head], [c[1] for c in calls])):
        n_calls = sum(1 for r in rows if r)
        total = sum(rows)
        for R, C in shapes:
            n_seg = math.ceil(R / rx)
            ops += PASSES * 2 * total * R * C * n_j * n_i
            nbytes += (n_calls * (n_j * n_seg * rx * C + 4 * n_seg * C)
                       + total * (4 * R + 4 * C))
    return ops, nbytes


def useful_ops(model: dict, layer_rows: int, head_rows: int,
               attn_context: int) -> int:
    """The model's useful operations: ``layer_rows`` rows through every
    layer's projections, ``head_rows`` through the head, and attention over
    ``attn_context`` (the sum over query rows of the keys each attends)."""
    proj = sum(R * C for _, R, C in layer_projections(model))
    R_h, C_h = head_projection(model)
    attn = 4 * model["n_heads"] * model["head_dim"] * attn_context
    return (model["n_layers"] * (2 * layer_rows * proj + attn)
            + 2 * head_rows * R_h * C_h)


def least_seconds(ops: int, nbytes: int) -> float:
    """The least time the card could take: operations over the int8 peak
    or bytes over HBM bandwidth, whichever is larger."""
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
