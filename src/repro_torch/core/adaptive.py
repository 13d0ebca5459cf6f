"""Adaptive Weight Slicing — the paper's Algorithm 1 (§4.2).

Port of ``repro.core.adaptive``. For each DNN layer, pick the weight slicing
with the *fewest slices* whose measured error is under the error budget
(0.09: "one in eleven 8b outputs off by one on average"), tie-broken by
lower error. Error is measured empirically: run the calibration inputs
through the bit-exact static-slicing crossbar (1b input slices, speculation
off — kernel K1), requantize to 8b output codes, and compare against the
ideal 8b-quantized layer on nonzero expected outputs.

``find_best_slicing`` evaluates one slice-count group of candidates at a
time; ``measure_errors`` queues every candidate's device work before one
host sync, so the per-site compile (``models.pim_compile``) does not stall
on a round trip per candidate. A nonzero ``noise_level`` raises: ADC noise
is not ported yet.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import pim_linear as pl
from repro_torch.core import slicing as sl

ERROR_BUDGET = 0.09  # paper §4.2.1


@dataclasses.dataclass
class SlicingChoice:
    slicing: tuple[int, ...]
    error: float
    n_slices: int
    all_errors: dict  # slicing -> measured error (for the tried subset)


def _error_value(w: torch.Tensor, x_cal: torch.Tensor,
                 weight_slicing: Sequence[int], *,
                 adc: adc_lib.ADCConfig, encode_mode: str,
                 noise_level: float, relu_out: bool,
                 signed_inputs: bool | None = None) -> torch.Tensor:
    """Device-side §4.2.1 error (scalar float32 tensor, no host sync)."""
    plan = pl.prepare(w, x_cal, weight_slicing=weight_slicing, adc=adc,
                      speculation=False, encode_mode=encode_mode,
                      relu_out=relu_out, signed_inputs=signed_inputs)
    # paper: 1b input slices while comparing weight slicings
    y_sim = pl.forward_exact(x_cal, plan, input_slicing=(1,) * sl.INPUT_BITS,
                             noise_level=noise_level)
    y_ref = pl.forward_int_reference(x_cal, plan)
    out_sim = pl.output_codes(y_sim, plan, relu=relu_out)
    out_ref = pl.output_codes(y_ref, plan, relu=relu_out)
    nz = out_ref != 0
    err = (out_sim - out_ref).abs().to(torch.float32)
    denom = nz.sum().clamp_min(1).to(torch.float32)
    return torch.where(nz, err, 0.0).sum() / denom


def measure_error(w: torch.Tensor, x_cal: torch.Tensor,
                  weight_slicing: Sequence[int], *,
                  adc: adc_lib.ADCConfig = adc_lib.RAELLA_ADC,
                  encode_mode: str = "center",
                  noise_level: float = 0.0,
                  relu_out: bool = False) -> float:
    """Mean |8b-output error| on nonzero expected outputs (paper §4.2.1)."""
    return float(measure_errors(w, x_cal, [weight_slicing], adc=adc,
                                encode_mode=encode_mode,
                                noise_level=noise_level,
                                relu_out=relu_out)[0])


def measure_errors(w: torch.Tensor, x_cal: torch.Tensor,
                   slicings: Sequence[Sequence[int]], *,
                   adc: adc_lib.ADCConfig = adc_lib.RAELLA_ADC,
                   encode_mode: str = "center",
                   noise_level: float = 0.0,
                   relu_out: bool = False) -> np.ndarray:
    """``measure_error`` over many candidate slicings, one host sync for
    all their errors: every candidate's work is queued first. The inputs'
    signedness (which ``prepare`` would infer per candidate) is read
    once."""
    if not slicings:
        return np.zeros((0,), np.float32)
    signed = bool((x_cal < 0).any())
    vals = [_error_value(w, x_cal, s, adc=adc, encode_mode=encode_mode,
                         noise_level=noise_level, relu_out=relu_out,
                         signed_inputs=signed)
            for s in slicings]
    return torch.stack(vals).cpu().numpy()


def candidate_slicings(max_slices: int = 8,
                       full_search: bool = False) -> tuple[tuple[int, ...], ...]:
    """Slicings ordered by (n_slices, MSB-heaviness).

    full_search=True iterates all 108 (paper). Otherwise a pruned front:
    for each slice count, the non-increasing (MSB-first-largest) layouts —
    high-order weight bits are sparse after centering (Fig. 8), so giving
    the MSB slice the most bits is the efficient direction.
    """
    all_s = sl.enumerate_slicings()
    if full_search:
        return tuple(sorted(all_s, key=lambda s: (len(s), [-b for b in s])))
    pruned = [s for s in all_s if list(s) == sorted(s, reverse=True)]
    return tuple(sorted(pruned, key=lambda s: (len(s), [-b for b in s])))


def find_best_slicing(w: torch.Tensor, x_cal: torch.Tensor, *,
                      error_budget: float = ERROR_BUDGET,
                      adc: adc_lib.ADCConfig = adc_lib.RAELLA_ADC,
                      encode_mode: str = "center",
                      noise_level: float = 0.0,
                      relu_out: bool = False,
                      full_search: bool = False,
                      last_layer: bool = False) -> SlicingChoice:
    """Algorithm 1's FindBestSlicing.

    last_layer=True forces the most conservative 1b-per-slice slicing
    (paper: the last layer has an outsized accuracy effect). Candidates are
    evaluated a slice-count group at a time (fewest slices first); the
    first group with an under-budget member wins, tie-broken by lower
    error within the group. Each group is fetched with one host sync.
    """
    kwargs = dict(adc=adc, encode_mode=encode_mode, noise_level=noise_level,
                  relu_out=relu_out)
    conservative = (1,) * sl.WEIGHT_BITS
    if last_layer:
        e = measure_error(w, x_cal, conservative, **kwargs)
        return SlicingChoice(conservative, e, len(conservative),
                             {conservative: e})
    errors: dict = {}
    cands = candidate_slicings(full_search=full_search)
    for _, group in itertools.groupby(cands, key=len):
        group = tuple(group)
        errs = measure_errors(w, x_cal, group, **kwargs)
        best: tuple[float, tuple[int, ...]] | None = None
        for s, e in zip(group, errs):
            errors[s] = float(e)
            if e < error_budget and (best is None or e < best[0]):
                best = (float(e), s)
        if best is not None:
            e, s = best
            return SlicingChoice(slicing=s, error=e, n_slices=len(s),
                                 all_errors=errors)
    # nothing under budget: fall back to the most conservative slicing
    e = errors.get(conservative)
    if e is None:
        e = measure_error(w, x_cal, conservative, **kwargs)
        errors[conservative] = e
    return SlicingChoice(slicing=conservative, error=e,
                         n_slices=len(conservative), all_errors=errors)
