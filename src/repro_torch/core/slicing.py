"""Bit-slicing arithmetic (paper §2.3, §4.1.3, §4.2.2).

A *slicing* of an M-bit operand is a tuple of slice widths ``(s_0, ..., s_k)``,
MSB-first, with ``sum(s_i) == M`` and every ``s_i <= 4`` (ReRAM device bits). Slice
``i`` covers the inclusive bit range ``[h_i .. l_i]``. Port of
``repro.core.slicing``, on integer tensors.

The paper's ``D(h, l, x)`` crops a *signed* integer to the bits ``[h..l]`` of
its magnitude, preserving the sign (sign-magnitude slicing: how offsets are
programmed into the positive/negative ReRAM of a 2T2R pair).
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


def crop_signed(x: torch.Tensor, h: int, l: int) -> torch.Tensor:
    """The paper's D(h, l, x): bits [h..l] of |x|, shifted down by l,
    signed (int32)."""
    mask = (1 << (h - l + 1)) - 1
    mag = x.abs().to(torch.int32)
    return torch.sign(x).to(torch.int32) * ((mag >> l) & mask)


def crop_unsigned(x: torch.Tensor, h: int, l: int) -> torch.Tensor:
    """Bits [h..l] of a non-negative integer tensor, shifted down by l."""
    mask = (1 << (h - l + 1)) - 1
    return (x.to(torch.int32) >> l) & mask


def slice_signed(x: torch.Tensor, slicing: Sequence[int],
                 total_bits: int = WEIGHT_BITS) -> list[torch.Tensor]:
    """Sign-magnitude slices of signed x, MSB-first: int32 tensors."""
    return [crop_signed(x, h, l) for h, l in slice_bounds(slicing, total_bits)]


def slice_unsigned(x: torch.Tensor, slicing: Sequence[int],
                   total_bits: int = INPUT_BITS) -> list[torch.Tensor]:
    """Unsigned slices of non-negative x, MSB-first: int32 tensors."""
    return [crop_unsigned(x, h, l)
            for h, l in slice_bounds(slicing, total_bits)]


def slice_shifts(slicing: Sequence[int],
                 total_bits: int | None = None) -> tuple[int, ...]:
    """Power-of-two shift (2**l) applied when recombining each slice."""
    return tuple(l for _, l in slice_bounds(slicing, total_bits))


def reconstruct(slices, slicing: Sequence[int],
                total_bits: int | None = None) -> torch.Tensor:
    """Inverse of slice_signed / slice_unsigned: sum_i 2**l_i * slice_i."""
    out = 0
    for s, (_, l) in zip(slices, slice_bounds(slicing, total_bits)):
        out = out + (s.to(torch.int32) << l)
    return out


def reslice_to_1b(slice_val: torch.Tensor, width: int) -> list[torch.Tensor]:
    """Re-slice one signed slice (width bits) into ``width`` 1b sub-slices,
    MSB-first (local shifts width-1 .. 0): recovery's re-processing of a
    failed speculative input slice (paper §4.3)."""
    return [crop_signed(slice_val, b, b) for b in range(width - 1, -1, -1)]


def to_unsigned_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """Signed int8 weights in the unsigned 8b domain used on-crossbar:
    w + 128 in [0, 255], int32 (the -128 folds into the digital center
    term)."""
    return w_int8.to(torch.int32) + 128


def np_enumerate_slicings_count() -> int:
    return len(enumerate_slicings())
