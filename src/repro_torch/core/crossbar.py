"""Functional 512-row 2T2R crossbar simulator (paper §4.1.4, §5.1).

Port of ``repro.core.crossbar``. Bit-exact integer model of RAELLA's
analog datapath:

  inputs (unsigned 8b, temporally sliced)  x  weights (Center+Offset encoded,
  spatially sliced, signed sign-magnitude planes)  ->  per-(input-slice,
  weight-slice) signed column sums over <=512 rows  ->  ADC (7b clamp, with
  optional analog noise)  ->  digital shift+add  ->  int32 psums (+ the
  digital center term phi * sum(I)).

``forward`` runs the whole noiseless static-slicing datapath on the ideal
device as ONE fused kernel op (``kernels.ops.fused_crossbar_forward``,
kernel K1). Noisy runs, runs on a ``NonidealSim`` die, ``ideal=True`` and
``backend='python'`` take the loop below — the oracle the tests hold the
kernel to. Speculation (``core.speculation``) uses the segmenting and
column-sum pieces here.
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
            key=None,
            ideal: bool = False,
            backend: str | None = None,
            device: bk.CrossbarBackend | None = None
            ) -> tuple[torch.Tensor, CrossbarStats]:
    """Full-fidelity crossbar forward (static input slicing, no
    speculation). x_u8: (B, rows) unsigned 8b inputs -> (psum (B, cols)
    int32, stats).

    ``ideal=True`` skips the ADC (infinite resolution). At noise 0 on the
    ideal device the datapath runs as the fused kernel op (K1);
    ``backend='python'``, ideal runs, noisy runs (``noise_level`` > 0
    needs a ``key``, ``core.rng``) and a ``NonidealSim`` ``device`` take
    the loop. A die programs its planes once per call and reads float32
    column sums; at an all-zero corner that is bit-exact with the ideal
    path. ``enc`` may carry all-zero padding planes (compiled per-site
    plans): they convert to 0 and contribute nothing. The work stats count
    every plane and are the same for every device.
    """
    if backend not in (None, "python"):
        raise ValueError(f"backend must be None or 'python', got {backend!r}")
    if noise_level and key is None:
        raise ValueError(
            f"noise_level={noise_level} requires a key: pass key= "
            "(silently running noiseless would drop the requested noise)")
    dev = bk.IDEAL if device is None else device
    B = x_u8.shape[0]
    n_seg, R = enc.n_segments, enc.rows_per_xbar
    in_bounds = sl.slice_bounds(input_slicing, sl.INPUT_BITS)
    if not ideal:
        adc_lib.check_zero_preserving(adc)  # the padding contract
    # shape-static counters stay exact Python ints
    total = B * n_seg * enc.cols * len(in_bounds) * enc.n_slices
    macs = B * enc.rows * enc.cols

    if not ideal and noise_level == 0.0 and backend is None \
            and isinstance(dev, bk.IdealSim):
        from repro_torch.kernels import ops as kops
        psum, sats = kops.fused_crossbar_forward(
            x_u8, enc.planes, enc.shifts, enc.centers,
            input_slicing=tuple(int(b) for b in input_slicing),
            adc_lo=adc.lo, adc_hi=adc.hi, rows_per_xbar=R)
        return psum, CrossbarStats(adc_converts=total, saturations=sats,
                                   conversions_possible=total, macs=macs)

    xs = _segment_inputs(x_u8, n_seg, R)  # (B, n_seg, R)
    prog = dev.program(enc.planes, rows=enc.rows)
    # the input slices stacked on the batch axis: one read and one
    # conversion per plane cover them all, elementwise as one per slice
    x_all = torch.cat([sl.crop_unsigned(xs, hi, li) for hi, li in in_bounds])
    # one key per (input slice, plane), split in the reference's order
    keys = None if key is None else key.split(len(in_bounds) * enc.n_slices)
    psum = co.center_term(x_u8, enc)
    shifts = _shifts(enc)
    saturations = torch.zeros((), dtype=torch.int64, device=x_u8.device)
    for j in range(enc.n_slices):
        pos, neg = dev.read(prog, x_all, j)  # (n_in * B, n_seg, C)
        val = pos - neg
        if ideal:
            if val.is_floating_point():
                val = torch.round(val).to(torch.int32)
        else:
            k = None if keys is None else _SliceKeys(keys[j::enc.n_slices])
            val, sat = adc_lib.convert(val, adc, noise_level=noise_level,
                                       pos_sum=pos, neg_sum=neg, key=k)
            saturations = saturations + sat.sum()
        sums = val.sum(dim=1)  # (n_in * B, C)
        for i, (_, li) in enumerate(in_bounds):
            psum = psum + (sums[i * B:(i + 1) * B] << (li + shifts[j]))
    stats = CrossbarStats(adc_converts=total, saturations=saturations,
                          conversions_possible=total, macs=macs)
    return psum.to(torch.int32), stats  # int64 sums; same value mod 2^32


class _SliceKeys:
    """One plane's keys of the stacked input slices, as one key: block i
    of a draw (the rows of input slice i) comes from ``keys[i]`` at the
    block's own shape, so each slice's noise is what its own key draws."""

    def __init__(self, keys):
        self.keys = keys

    def normal(self, shape, device="cpu") -> torch.Tensor:
        block = (shape[0] // len(self.keys),) + tuple(shape[1:])
        return torch.cat([k.normal(block, device) for k in self.keys])


def _shifts(enc: co.EncodedWeights):
    """Each plane's recombination shift: Python ints for a layer's own
    encoding, a device int64 vector for compiled per-site plans (read
    element by element on the device: no host sync per call)."""
    if isinstance(enc.shifts, torch.Tensor):
        return enc.shifts.to(torch.int64)
    return [int(s) for s in enc.shifts]


def matmul_reference(x_u8: torch.Tensor, w_u8: torch.Tensor) -> torch.Tensor:
    """Ideal integer matmul in the unsigned-weight domain: x @ w, int32."""
    return _int_matmul(x_u8, w_u8).to(torch.int32)


def column_sum_distribution(x_u8: torch.Tensor,
                            enc: co.EncodedWeights,
                            input_slicing: Sequence[int],
                            adc: adc_lib.ADCConfig = adc_lib.RAELLA_ADC):
    """All raw (pre-ADC) column sums + fraction in ADC range (Fig. 3
    harness). The fraction is the reference's float32 mean: the exact
    count of in-range sums times the float32 reciprocal of their number,
    the same on every device."""
    xs = _segment_inputs(x_u8, enc.n_segments, enc.rows_per_xbar)
    sums = []
    for (hi, li) in sl.slice_bounds(input_slicing, sl.INPUT_BITS):
        x_sl = sl.crop_unsigned(xs, hi, li)
        for j in range(enc.n_slices):
            pos, neg = column_sums(x_sl, enc.planes[j])
            sums.append((pos - neg).reshape(-1))
    cs = torch.cat(sums)
    count = ((cs >= adc.lo) & (cs <= adc.hi)).sum().to(torch.float32)
    inv = torch.tensor(1.0 / cs.numel(), dtype=torch.float32,
                       device=cs.device)
    return cs, count * inv
