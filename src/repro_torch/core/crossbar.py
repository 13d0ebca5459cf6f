"""Crossbar pieces the speculation path needs (paper §4.1.4, §5.1).

Port of the part of ``repro.core.crossbar`` that Dynamic Input Slicing
uses: segmenting inputs into 512-row crossbars, the signed (pos, neg)
column sums of one (input-slice, weight-slice) pair, and the work-stats
record. The static-slicing ``forward`` arrives with its kernel (K1).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.ref import _int_matmul


@dataclasses.dataclass
class CrossbarStats:
    """Fidelity / work counters for one static-slicing forward pass."""
    adc_converts: int                # ADC conversions performed
    saturations: torch.Tensor        # scalar int64 — saturated conversions
    conversions_possible: int        # converts a no-spec design needs
    macs: int                        # logical 8b MACs computed


def _segment_inputs(x_u8: torch.Tensor, n_seg: int,
                    rows_per_xbar: int) -> torch.Tensor:
    """(..., rows) -> (..., n_seg, rows_per_xbar) int32, zero-padded."""
    pad = n_seg * rows_per_xbar - x_u8.shape[-1]
    if pad < 0:
        raise ValueError(
            f"input rows {x_u8.shape[-1]} exceed the crossbar capacity "
            f"{n_seg} segments x {rows_per_xbar} rows = "
            f"{n_seg * rows_per_xbar}: the encoding was built for fewer "
            "rows than this input carries (shape mismatch between x and "
            "the EncodedWeights it is paired with)")
    xp = torch.nn.functional.pad(x_u8.to(torch.int32), (0, pad))
    return xp.reshape(x_u8.shape[:-1] + (n_seg, rows_per_xbar))


def column_sums(x_slice: torch.Tensor,
                plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed column sums of one (input-slice, weight-slice) pair.

    x_slice: (B, n_seg, R) int32 unsigned slice values.
    plane:   (n_seg, R, C) int8 signed slice values.
    Returns (pos, neg) int32 of shape (B, n_seg, C): the positive and
    negative sliced-product sums (their difference is the column sum).
    """
    p = plane.to(torch.int32)
    xs = x_slice.transpose(0, 1)  # (n_seg, B, R)
    pos = _int_matmul(xs, p.clamp_min(0)).transpose(0, 1)
    neg = _int_matmul(xs, (-p).clamp_min(0)).transpose(0, 1)
    return pos.to(torch.int32), neg.to(torch.int32)
