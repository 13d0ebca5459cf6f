"""Dynamic Input Slicing: speculation + recovery (paper §4.3).

Port of ``repro.core.speculation``. Speculation processes inputs
with an aggressive slicing (default 4b-2b-2b); any conversion that saturates
at the ADC bounds is flagged, and the failed (column x input-slice) results
are replaced by a recovery pass that re-slices that input slice into 1b
sub-slices. The crossbar always runs all recovery cycles, but ADCs only
convert — only count work — for columns that failed speculation.

At noise 0 the pass runs as ONE fused kernel op (``kernels.ops.
fused_spec_crossbar_forward``, kernel K2); recovery converts are billed
analytically from the per-spec-slice failure counts it returns,
``converts = attempts + sum_i width_i * failures_i`` (reference
``speculation.py:113-121``). ``backend='python'`` runs the loop below
instead — the oracle the tests hold the kernel to — and so does a noisy
pass (the ADC noise model, ``adc.convert``, draws per conversion from a
key). Data-dependent counters are int64 tensors; the shape-static ones are
Python ints.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import center_offset as co
from repro_torch.core import crossbar as xbar
from repro_torch.core import slicing as sl

SPEC_SLICING = (4, 2, 2)  # paper: three speculative slices of 2-4 bits


@functools.lru_cache(maxsize=None)
def _widths(widths: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Spec-slice widths as a device tensor, made once per device (a fresh
    host-to-device copy per call would stall the stream)."""
    return torch.tensor(widths, dtype=torch.int64, device=device)


@dataclasses.dataclass
class SpeculationStats:
    adc_converts: torch.Tensor         # converts performed (spec + recovery)
    no_spec_converts: int              # converts a recovery-only design needs
    spec_failures: torch.Tensor        # failed (column x spec-slice) converts
    spec_attempts: int
    recovery_saturations: torch.Tensor  # accepted fidelity losses
    cycles: int                        # crossbar cycles (3 spec + 8 rec = 11)
    macs: int

    @property
    def failure_rate(self):
        return self.spec_failures / max(self.spec_attempts, 1)


def forward(x_u8: torch.Tensor,
            enc: co.EncodedWeights,
            spec_slicing: Sequence[int] = SPEC_SLICING,
            adc: adc_lib.ADCConfig = adc_lib.RAELLA_ADC,
            *,
            noise_level: float = 0.0,
            key=None,
            backend: str | None = None,
            valid: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, SpeculationStats]:
    """Speculative crossbar forward. x_u8: (B, rows) -> (psum (B, cols)
    int32, stats).

    ``backend='python'`` and noisy runs (``noise_level`` > 0 needs a
    ``key``, ``core.rng``) take the reference loop; anything else the
    fused kernel op (dispatched by device). ``valid`` optionally masks
    padded slice planes: masked planes are zeroed, but the work stats
    still count every plane.
    """
    if backend not in (None, "python"):
        raise ValueError(f"backend must be None or 'python', got {backend!r}")
    if noise_level and key is None:
        raise ValueError(
            f"noise_level={noise_level} requires a key: pass key= "
            "(silently running noiseless would drop the requested noise)")
    adc_lib.check_zero_preserving(adc)  # the padding contract
    B = x_u8.shape[0]
    n_seg, R = enc.n_segments, enc.rows_per_xbar
    planes = enc.planes
    if valid is not None:
        planes = planes * valid[:, None, None, None].to(planes.dtype)
    spec_bounds = sl.slice_bounds(spec_slicing, sl.INPUT_BITS)
    dev = x_u8.device

    n_cols = B * n_seg * enc.cols
    attempts = n_cols * len(spec_bounds) * enc.n_slices
    no_spec = n_cols * sl.INPUT_BITS * enc.n_slices
    cycles = len(spec_slicing) + sl.INPUT_BITS
    macs = B * enc.rows * enc.cols

    if noise_level == 0.0 and backend is None:
        from repro_torch.kernels import ops as kops
        psum, fails, rec_sats = kops.fused_spec_crossbar_forward(
            x_u8, planes, enc.shifts, enc.centers,
            spec_slicing=tuple(int(b) for b in spec_slicing),
            adc_lo=adc.lo, adc_hi=adc.hi, rows_per_xbar=R)
        widths = _widths(tuple(hi - lo + 1 for (hi, lo) in spec_bounds), dev)
        stats = SpeculationStats(
            adc_converts=attempts + (widths * fails).sum(),
            no_spec_converts=no_spec,
            spec_failures=fails.sum(),
            spec_attempts=attempts,
            recovery_saturations=rec_sats,
            cycles=cycles, macs=macs)
        return psum, stats

    xs = xbar._segment_inputs(x_u8, n_seg, R)
    psum = co.center_term(x_u8, enc)
    shifts = xbar._shifts(enc)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    rec_converts, failures, rec_sats = zero, zero, zero
    # one key per conversion pass: each spec slice's, then its recovery
    # bits' from high to low
    n_keys = sum(1 + w for w in spec_slicing) * enc.n_slices
    keys = iter(key.split(n_keys) if key is not None else [None] * n_keys)
    for (hi, li) in spec_bounds:
        width = hi - li + 1
        x_spec = sl.crop_unsigned(xs, hi, li)
        for j in range(enc.n_slices):
            pos, neg = xbar.column_sums(x_spec, planes[j])
            spec_val, spec_sat = adc_lib.convert(
                pos - neg, adc, noise_level=noise_level, pos_sum=pos,
                neg_sum=neg, key=next(keys))
            rec_total = torch.zeros_like(spec_val)
            for b in range(width - 1, -1, -1):  # local bit positions
                x_bit = sl.crop_unsigned(xs, li + b, li + b)
                rpos, rneg = xbar.column_sums(x_bit, planes[j])
                rval, rsat = adc_lib.convert(
                    rpos - rneg, adc, noise_level=noise_level, pos_sum=rpos,
                    neg_sum=rneg, key=next(keys))
                rec_total = rec_total + (rval << b)
                rec_sats = rec_sats + (rsat & spec_sat).sum()
            value = torch.where(spec_sat, rec_total, spec_val)
            psum = psum + (value.sum(dim=1) << (li + shifts[j]))
            failures = failures + spec_sat.sum()
            rec_converts = rec_converts + width * spec_sat.sum()
    psum = psum.to(torch.int32)  # int64 row sums; same value mod 2^32
    stats = SpeculationStats(
        adc_converts=attempts + rec_converts,
        no_spec_converts=no_spec,
        spec_failures=failures,
        spec_attempts=attempts,
        recovery_saturations=rec_sats,
        cycles=cycles,
        macs=macs)
    return psum, stats
