"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes exactly what its kernel computes, with ordinary
tensor operations, on any device. The CPU tests hold them against the
reference's oracles (``repro.kernels.ref``) and Pallas kernels;
``chip_smoke.py`` holds each CUDA kernel against them on the card.

CUDA has no integer matrix product, so every integer contraction here runs
as a float64 product, which is exact: every operand and every partial sum
is an integer far below 2**53 (a 512-row column sum of 4b x 4b slices is
below 2**17; an int8 x int8 row of 2816 terms below 2**26).
"""

from __future__ import annotations

from typing import Sequence

import torch


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` (broadcasting like ``torch.matmul``) as an
    int64 tensor, through float64."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64)


def centered_int8_matmul(x_q: torch.Tensor, w_off: torch.Tensor,
                         centers: torch.Tensor) -> torch.Tensor:
    """y = x_q @ w_off + rowsum(x_q) * centers   (int32, wrapping).

    x_q: (B, K) int8; w_off: (K, N) int8; centers: (N,) int32.
    """
    acc = _int_matmul(x_q, w_off)
    xsum = x_q.to(torch.int64).sum(dim=-1, keepdim=True)
    return (acc + xsum * centers.to(torch.int64)[None, :]).to(torch.int32)


def sliced_crossbar_matmul(x_slices: torch.Tensor, w_planes: torch.Tensor,
                           mults: torch.Tensor, *, rows_per_xbar: int = 512,
                           adc_lo: int = -64, adc_hi: int = 63
                           ) -> torch.Tensor:
    """Crossbar contraction of pre-sliced inputs with a per-segment ADC.

    x_slices (n_i, B, R) int8 input-slice values; w_planes (n_j, R, C) int8
    signed weight-slice values (any R: rows past it read as zero); mults
    (n_i, n_j) int32 recombination multipliers. Per segment each
    (i, j) column sum is clamped to [adc_lo, adc_hi] before the digital
    shift+add. Returns (B, C) int32 (no center term).
    """
    n_i, B, R = x_slices.shape
    n_j, R2, C = w_planes.shape
    if R2 != R:
        raise ValueError(f"x_slices rows {R} != w_planes rows {R2}")
    n_seg = -(-R // rows_per_xbar)
    pad = n_seg * rows_per_xbar - R
    xs = torch.nn.functional.pad(x_slices.to(torch.int32), (0, pad))
    xs = xs.reshape(n_i, B, n_seg, rows_per_xbar).transpose(1, 2)
    ws = torch.nn.functional.pad(w_planes.to(torch.int32), (0, 0, 0, pad))
    ws = ws.reshape(n_j, n_seg, rows_per_xbar, C)
    out = torch.zeros((B, C), dtype=torch.int64, device=x_slices.device)
    for i in range(n_i):
        for j in range(n_j):
            cs = _int_matmul(xs[i], ws[j]).clamp(adc_lo, adc_hi)  # (s, B, C)
            out += cs.sum(0) * mults[i, j].to(torch.int64)
    return out.to(torch.int32)


def fused_crossbar(x_u8: torch.Tensor, w_planes: torch.Tensor,
                   in_li: Sequence[int], in_mask: Sequence[int],
                   mults: torch.Tensor, centers: torch.Tensor, *,
                   rows_per_xbar: int = 512,
                   adc_lo: int = -64, adc_hi: int = 63
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The static-slicing exact datapath over every ``rows_per_xbar``-row
    segment.

    x_u8 (B, R) int32 unsigned 8b codes; w_planes (n_j, Rp, C) int8 with Rp
    a ``rows_per_xbar`` multiple >= R; in_li / in_mask (n_i,) each input
    slice's low bit and mask; mults (n_i, n_j) int32 recombination
    multipliers (0 kills a padded plane); centers (n_seg, C) int32.

    Input slice i is ``(x >> li) & mask``; per segment and plane j its
    column sum is clamped to [adc_lo, adc_hi] (a clamp on either bound is
    a saturation) and weighted by ``mults[i, j]``. Returns (psum (B, C)
    int32 including the center term, saturations () int64).
    """
    B, R = x_u8.shape
    n_j, Rp, C = w_planes.shape
    if Rp % rows_per_xbar or Rp < R:
        raise ValueError(f"w_planes rows {Rp} do not hold x rows {R} in "
                         f"{rows_per_xbar}-row segments")
    n_seg = Rp // rows_per_xbar
    xs = torch.nn.functional.pad(x_u8.to(torch.int32), (0, Rp - R))
    xs = xs.reshape(B, n_seg, rows_per_xbar).transpose(0, 1)  # (s, B, r)
    ws = w_planes.reshape(n_j, n_seg, rows_per_xbar, C)
    out = (xs.to(torch.int64).sum(-1)[:, :, None]
           * centers.to(torch.int64)[:, None, :]).sum(0)  # center term
    sats = torch.zeros((), dtype=torch.int64, device=x_u8.device)
    for i, (li, mask) in enumerate(zip(in_li, in_mask)):
        x_i = (xs >> li) & mask
        for j in range(n_j):
            cs = _int_matmul(x_i, ws[j]).clamp(adc_lo, adc_hi)  # (s, B, C)
            sats += ((cs == adc_lo) | (cs == adc_hi)).sum()
            out += cs.sum(0) * mults[i, j].to(torch.int64)
    return out.to(torch.int32), sats


def fused_spec_crossbar(x_u8: torch.Tensor, w_planes: torch.Tensor,
                        spec_li: Sequence[int], spec_mask: Sequence[int],
                        mults: torch.Tensor,
                        rmults: Sequence[Sequence[int]],
                        centers: torch.Tensor, *,
                        rows_per_xbar: int = 512,
                        adc_lo: int = -64, adc_hi: int = 63
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculation + recovery (paper §4.3) over every ``rows_per_xbar``-row
    segment.

    x_u8 (B, R) int32 unsigned 8b codes; w_planes (n_j, Rp, C) int8 with Rp
    a ``rows_per_xbar`` multiple >= R; spec_li / spec_mask (n_i,) the spec
    slices' low bit and mask; mults (n_i, n_j) int32 recombination
    multipliers (0 kills a padded plane); rmults (n_i, max_w) recovery
    multipliers (``1 << t`` below the slice's width, 0 past it); centers
    (n_seg, C) int32.

    Each spec slice i is converted once per plane j; a conversion that
    clamps at either ADC bound is a failure, replaced by the 1b recovery
    recombination ``sum_t clip(bit_t(x) @ w_j) * rmults[i, t]``. Returns
    (psum (B, C) int32 including the center term, failures per spec slice
    (n_i,) int64, recovery saturations where recovery ran () int64).
    """
    B, R = x_u8.shape
    n_j, Rp, C = w_planes.shape
    if Rp % rows_per_xbar or Rp < R:
        raise ValueError(f"w_planes rows {Rp} do not hold x rows {R} in "
                         f"{rows_per_xbar}-row segments")
    n_seg = Rp // rows_per_xbar
    dev = x_u8.device
    xs = torch.nn.functional.pad(x_u8.to(torch.int32), (0, Rp - R))
    xs = xs.reshape(B, n_seg, rows_per_xbar).transpose(0, 1)  # (s, B, r)
    ws = w_planes.reshape(n_j, n_seg, rows_per_xbar, C)
    out = (xs.to(torch.int64).sum(-1)[:, :, None]
           * centers.to(torch.int64)[:, None, :]).sum(0)  # center term
    fails = torch.zeros(len(spec_li), dtype=torch.int64, device=dev)
    rsats = torch.zeros((), dtype=torch.int64, device=dev)
    for i, (li, mask) in enumerate(zip(spec_li, spec_mask)):
        x_i = (xs >> li) & mask
        for j in range(n_j):
            cs = _int_matmul(x_i, ws[j]).clamp(adc_lo, adc_hi)  # (s, B, C)
            sat = (cs == adc_lo) | (cs == adc_hi)
            fails[i] += sat.sum()
            rec = torch.zeros_like(cs)
            for t, rm in enumerate(rmults[i]):
                x_b = (xs >> (li + t)) & 1
                rcs = _int_matmul(x_b, ws[j]).clamp(adc_lo, adc_hi)
                rec += rcs * rm
                if rm > 0:
                    rsats += (((rcs == adc_lo) | (rcs == adc_hi)) & sat).sum()
            value = torch.where(sat, rec, cs)
            out += value.sum(0) * mults[i, j].to(torch.int64)
    return out.to(torch.int32), fails, rsats
