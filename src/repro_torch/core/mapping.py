"""Layer -> crossbar/IMA/tile mapping (paper §5).

Maps DNN layers onto a PIM accelerator: filter segmentation over 512-row
crossbars, column packing (n_weight_slices columns per filter), utilization
accounting, partial-Toeplitz in-crossbar replication, and the greedy
cross-tile replication scheme ("while there are tiles left, the
lowest-throughput layer is replicated").

A copy of the JAX package's ``repro.core.mapping`` (the port imports nothing of
``repro``).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One weight-stationary layer of a DNN workload.

    filter_len: rows of one dot product (k*k*Cin for conv, d_in for FC).
    n_filters:  output channels / columns of the weight matrix.
    n_positions: output positions sharing the weights (H_out*W_out for conv,
                 tokens for FC/attention projections; 1 for a single MVM).
    signed_inputs: True -> two-cycle positive/negative input processing.
    depthwise:  depthwise conv — each filter sees only its own channel
                (n_filters independent k*k dot products).
    """
    name: str
    filter_len: int
    n_filters: int
    n_positions: int
    signed_inputs: bool = False
    depthwise: bool = False
    last_layer: bool = False
    row_positions: int = 0   # output positions per dataflow "row" (paper §5.5:
                             # tiles emit one output-tensor row at a time —
                             # this caps useful weight replication). 0 -> 1.

    @property
    def macs(self) -> int:
        return self.filter_len * self.n_filters * self.n_positions

    @property
    def weights(self) -> int:
        return self.filter_len * self.n_filters


@dataclasses.dataclass(frozen=True)
class LayerMapping:
    layer: LayerShape
    n_segments: int          # vertical filter splits across crossbars
    rows_used: int           # rows occupied in the (last) segment pattern
    utilization: float       # used rows / provisioned rows
    filters_per_xbar: int    # filters packed side by side in one crossbar
    toeplitz_positions: int  # output positions computed per crossbar pass
    n_crossbars: int         # crossbars to hold one copy of the layer
    replication: int = 1     # copies (greedy throughput replication)


def map_layer(layer: LayerShape, rows: int, cols: int,
              n_weight_slices: int) -> LayerMapping:
    """Pack one layer onto crossbars of (rows x cols) with spatial slicing."""
    flen = layer.filter_len
    n_seg = max(1, math.ceil(flen / rows))
    per_seg_rows = min(flen, rows)
    cols_per_filter = n_weight_slices
    filters_per_xbar = max(1, cols // cols_per_filter)

    # partial Toeplitz (paper §5.5, [11]): if a conv filter leaves row slack,
    # replicate the filter shifted in-crossbar to produce several output
    # positions per pass. FCs (n_positions==1 per token) get no benefit.
    toeplitz = 1
    if n_seg == 1 and layer.n_positions > 1 and not layer.depthwise:
        toeplitz = min(max(1, rows // flen), 8)  # diminishing returns cap
    rows_used = min(rows, per_seg_rows * toeplitz)

    if layer.depthwise:
        # each filter is its own tiny dot product; rows utilization is poor
        rows_used = min(rows, flen * toeplitz)
    n_xbars_for_filters = math.ceil(layer.n_filters / filters_per_xbar)
    n_crossbars = n_seg * n_xbars_for_filters
    util = (min(flen, rows * n_seg) / (rows * n_seg)) if not layer.depthwise \
        else min(1.0, rows_used / rows)
    return LayerMapping(
        layer=layer, n_segments=n_seg, rows_used=rows_used,
        utilization=util, filters_per_xbar=filters_per_xbar,
        toeplitz_positions=toeplitz, n_crossbars=n_crossbars)


def greedy_replicate(mappings: list[LayerMapping],
                     latencies: list[float],
                     total_crossbars: int) -> list[LayerMapping]:
    """Paper §5.5: while crossbars remain, replicate the slowest layer.

    Replication of layer i is capped at the number of output positions per
    dataflow row not already covered in-crossbar (row-synchronous pipeline:
    extra copies beyond one row of work sit idle).
    """
    base = sum(m.n_crossbars for m in mappings)
    if base > total_crossbars:
        return mappings  # does not fit with replication; single copy spill
    caps = [max(1, math.ceil(m.layer.n_positions / m.toeplitz_positions))
            for m in mappings]
    costs = [m.n_crossbars for m in mappings]

    def reps_for(target: float) -> list[int]:
        # copies needed so every layer's effective latency <= target
        return [max(1, min(cap, math.ceil(lat / max(target, 1e-9))))
                for lat, cap in zip(latencies, caps)]

    # water-filling via binary search on the bottleneck latency (equivalent
    # to the paper's greedy loop, but O(L log T) instead of O(copies * L))
    lo, hi = 0.0, max(latencies) if latencies else 0.0
    best = [1] * len(mappings)
    for _ in range(60):
        mid = (lo + hi) / 2 if hi > 0 else 0.0
        r = reps_for(mid)
        if sum(c * ri for c, ri in zip(costs, r)) <= total_crossbars:
            best, hi = r, mid
        else:
            lo = mid
    return [dataclasses.replace(m, replication=r)
            for m, r in zip(mappings, best)]
