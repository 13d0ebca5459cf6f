"""Bit-slicing arithmetic (paper §2.3, §4.1.3, §4.2.2).

A *slicing* of an M-bit operand is a tuple of slice widths ``(s_0, ..., s_k)``,
MSB-first, with ``sum(s_i) == M`` and every ``s_i <= 4`` (ReRAM device bits). Slice
``i`` covers the inclusive bit range ``[h_i .. l_i]``. Port of
``repro.core.slicing`` (the subset the serve path and Algorithm 1 need).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

WEIGHT_BITS = 8
INPUT_BITS = 8
MAX_DEVICE_BITS = 4  # ReRAMs programmable up to 4b in RAELLA (5b shown feasible)


@functools.lru_cache(maxsize=None)
def enumerate_slicings(total_bits: int = WEIGHT_BITS,
                       max_bits: int = MAX_DEVICE_BITS
                       ) -> tuple[tuple[int, ...], ...]:
    """All compositions of ``total_bits`` into parts of size 1..max_bits,
    MSB-first. For 8 bits and <=4b devices: the paper's 108 slicings."""
    if total_bits == 0:
        return ((),)
    out = []
    for first in range(1, min(max_bits, total_bits) + 1):
        for rest in enumerate_slicings(total_bits - first, max_bits):
            out.append((first,) + rest)
    return tuple(out)


def slice_bounds(slicing: Sequence[int],
                 total_bits: int | None = None) -> tuple[tuple[int, int], ...]:
    """Inclusive (h, l) bit bounds per slice, MSB-first.

    ``slicing=(4,2,2)`` over 8 bits -> ((7,4), (3,2), (1,0)).
    """
    total = sum(slicing) if total_bits is None else total_bits
    if total_bits is not None and sum(slicing) != total_bits:
        raise ValueError(f"slicing {slicing} does not cover {total_bits} bits")
    bounds = []
    h = total - 1
    for s in slicing:
        bounds.append((h, h - s + 1))
        h -= s
    return tuple(bounds)


def crop_unsigned(x: torch.Tensor, h: int, l: int) -> torch.Tensor:
    """Bits [h..l] of a non-negative integer tensor, shifted down by l."""
    mask = (1 << (h - l + 1)) - 1
    return (x.to(torch.int32) >> l) & mask


def slice_shifts(slicing: Sequence[int],
                 total_bits: int | None = None) -> tuple[int, ...]:
    """Power-of-two shift (2**l) applied when recombining each slice."""
    return tuple(l for _, l in slice_bounds(slicing, total_bits))
