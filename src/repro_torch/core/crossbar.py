"""Functional 512-row 2T2R crossbar simulator (paper §4.1.4, §5.1).

Port of ``repro.core.crossbar`` at noise 0. Bit-exact integer model of
RAELLA's analog datapath:

  inputs (unsigned 8b, temporally sliced)  x  weights (Center+Offset encoded,
  spatially sliced, signed sign-magnitude planes)  ->  per-(input-slice,
  weight-slice) signed column sums over <=512 rows  ->  ADC (clamp)  ->
  digital shift+add  ->  int32 psums (+ the digital center term
  phi * sum(I)).

``forward`` runs the whole static-slicing datapath as ONE fused kernel op
(``kernels.ops.fused_crossbar_forward``, kernel K1) on the ideal device;
``backend='python'`` runs the loop below instead — the oracle the tests
hold the kernel to. Speculation (``core.speculation``) uses the segmenting
and column-sum pieces here. Analog noise and nonideal devices are not
ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import backends as bk
from repro_torch.core import center_offset as co
from repro_torch.core import slicing as sl
from repro_torch.kernels.ref import _int_matmul


@dataclasses.dataclass
class CrossbarStats:
    """Fidelity / work counters for one static-slicing forward pass.
    Shape-static counters are exact Python ints; ``saturations`` is an
    int64 tensor (the reference counts it in int32)."""
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
    return bk.IDEAL.read(bk.IDEAL.program(plane[None]), x_slice, 0)


def forward(x_u8: torch.Tensor,
            enc: co.EncodedWeights,
            input_slicing: Sequence[int] = (1,) * 8,
            adc: adc_lib.ADCConfig = adc_lib.RAELLA_ADC,
            *,
            noise_level: float = 0.0,
            ideal: bool = False,
            backend: str | None = None,
            device: bk.CrossbarBackend | None = None
            ) -> tuple[torch.Tensor, CrossbarStats]:
    """Full-fidelity crossbar forward (static input slicing, no
    speculation). x_u8: (B, rows) unsigned 8b inputs -> (psum (B, cols)
    int32, stats).

    ``ideal=True`` skips the ADC (infinite resolution). At noise 0 on the
    ideal device the datapath runs as the fused kernel op (K1);
    ``backend='python'`` and ideal runs take the loop. ``enc`` may carry
    all-zero padding planes (compiled per-site plans): they convert to 0
    and contribute nothing, but the work stats count every plane.
    """
    if backend not in (None, "python"):
        raise ValueError(f"backend must be None or 'python', got {backend!r}")
    if noise_level:
        raise NotImplementedError(
            "ADC noise is not ported yet (ROADMAP); noise_level must be 0")
    dev = bk.IDEAL if device is None else device
    if not isinstance(dev, bk.IdealSim):
        raise NotImplementedError(
            "nonideal crossbar devices are not ported yet (ROADMAP)")
    B = x_u8.shape[0]
    n_seg, R = enc.n_segments, enc.rows_per_xbar
    in_bounds = sl.slice_bounds(input_slicing, sl.INPUT_BITS)
    if not ideal:
        adc_lib.check_zero_preserving(adc)  # the padding contract
    # shape-static counters stay exact Python ints
    total = B * n_seg * enc.cols * len(in_bounds) * enc.n_slices
    macs = B * enc.rows * enc.cols

    if not ideal and backend is None:
        from repro_torch.kernels import ops as kops
        psum, sats = kops.fused_crossbar_forward(
            x_u8, enc.planes, enc.shifts, enc.centers,
            input_slicing=tuple(int(b) for b in input_slicing),
            adc_lo=adc.lo, adc_hi=adc.hi, rows_per_xbar=R)
        return psum, CrossbarStats(adc_converts=total, saturations=sats,
                                   conversions_possible=total, macs=macs)

    xs = _segment_inputs(x_u8, n_seg, R)  # (B, n_seg, R)
    prog = dev.program(enc.planes, rows=enc.rows)
    psum = co.center_term(x_u8, enc)
    shifts = [int(s) for s in enc.shifts]
    saturations = torch.zeros((), dtype=torch.int64, device=x_u8.device)
    for (hi, li) in in_bounds:
        x_sl = sl.crop_unsigned(xs, hi, li)
        for j in range(enc.n_slices):
            pos, neg = dev.read(prog, x_sl, j)
            val = pos - neg
            if not ideal:
                val, sat = adc_lib.convert(val, adc)
                saturations = saturations + sat.sum()
            psum = psum + (val.sum(dim=1) << (li + shifts[j]))
    stats = CrossbarStats(adc_converts=total, saturations=saturations,
                          conversions_possible=total, macs=macs)
    return psum.to(torch.int32), stats  # int64 sums; same value mod 2^32


def matmul_reference(x_u8: torch.Tensor, w_u8: torch.Tensor) -> torch.Tensor:
    """Ideal integer matmul in the unsigned-weight domain: x @ w, int32."""
    return _int_matmul(x_u8, w_u8).to(torch.int32)


def column_sum_distribution(x_u8: torch.Tensor,
                            enc: co.EncodedWeights,
                            input_slicing: Sequence[int],
                            adc: adc_lib.ADCConfig = adc_lib.RAELLA_ADC):
    """All raw (pre-ADC) column sums + fraction in ADC range (Fig. 3
    harness)."""
    xs = _segment_inputs(x_u8, enc.n_segments, enc.rows_per_xbar)
    sums = []
    for (hi, li) in sl.slice_bounds(input_slicing, sl.INPUT_BITS):
        x_sl = sl.crop_unsigned(xs, hi, li)
        for j in range(enc.n_slices):
            pos, neg = column_sums(x_sl, enc.planes[j])
            sums.append((pos - neg).reshape(-1))
    cs = torch.cat(sums)
    in_range = ((cs >= adc.lo) & (cs <= adc.hi)).to(torch.float32).mean()
    return cs, in_range
