"""Public wrappers of the PIM kernels: tables, device dispatch, counts.

Port of ``repro/kernels/ops.py``. The wrappers build the kernels' tables
exactly as the reference does (``ops.py:124-246``): the input (or spec)
slices' low bits ``li`` and masks, ``mults = valid_j << (l_i + l_j)`` and
the recovery multipliers ``rmults``. There is no backend registry: a
kernel runs where its tensors are — the plain PyTorch version for CPU
tensors, the CUDA kernel for CUDA tensors, and an error for anything else.
No path falls back from a CUDA tensor to the plain version.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import fused_crossbar as _fx
from repro_torch.kernels import fused_spec_crossbar as _fs
from repro_torch.kernels import int8_matmul as _im
from repro_torch.kernels import sliced_crossbar as _sx

KERNELS = {"fused_crossbar": _fx, "fused_spec_crossbar": _fs,
           "centered_int8_matmul": _im, "sliced_crossbar": _sx}


def launch_counts() -> dict[str, int]:
    """CUDA launches per kernel since the last reset."""
    return {name: mod.KERNEL.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.KERNEL.launches = 0


def centered_int8_matmul(x_q: torch.Tensor, w_off: torch.Tensor,
                         centers: torch.Tensor) -> torch.Tensor:
    """y_int32 = x_q @ w_off + rowsum(x_q) * centers (Eq. 1 fast path)."""
    return _im.forward(x_q.contiguous(), w_off.contiguous(),
                       centers.to(torch.int32).contiguous())


def input_bounds(input_slicing: tuple[int, ...],
                 total_bits: int = 8) -> list[tuple[int, int]]:
    """MSB-first (hi, lo) bit bounds of an input slicing."""
    if sum(input_slicing) != total_bits:
        raise ValueError(f"input slicing {input_slicing} must cover "
                         f"{total_bits} bits")
    out, hi = [], total_bits - 1
    for w in input_slicing:
        out.append((hi, hi - w + 1))
        hi -= w
    return out


@functools.lru_cache(maxsize=None)
def _li_tensor(spec_li: tuple[int, ...], device: torch.device):
    return torch.tensor(spec_li, dtype=torch.int32, device=device)


def crossbar_tables(planes: torch.Tensor, shifts, slicing: tuple[int, ...],
                    valid: torch.Tensor | None = None,
                    rows_per_xbar: int = 512):
    """K1's operands from an encoding (K2 shares them): the flat
    ``(n_j, Rp, C)`` planes (zeroed where ``valid`` is False), the input
    slices' low bits and masks, and ``mults = valid_j << (l_i + l_j)`` on
    the planes' device."""
    bounds = input_bounds(tuple(int(b) for b in slicing))
    n_j, n_seg, rx, C = planes.shape
    if rx != rows_per_xbar:
        raise ValueError(f"planes rows {rx} != rows_per_xbar {rows_per_xbar}")
    dev = planes.device
    if valid is not None:
        planes = planes * valid[:, None, None, None].to(planes.dtype)
    w_flat = planes.reshape(n_j, n_seg * rows_per_xbar, C).contiguous()
    li = tuple(lo for (_, lo) in bounds)
    mask = tuple((1 << (hi - lo + 1)) - 1 for (hi, lo) in bounds)
    shifts_t = torch.as_tensor(shifts, dtype=torch.int32, device=dev)
    mults = torch.bitwise_left_shift(
        torch.ones((len(bounds), n_j), dtype=torch.int32, device=dev),
        _li_tensor(li, dev)[:, None] + shifts_t[None, :])
    if valid is not None:
        mults = mults * valid.to(torch.int32)[None, :]
    return w_flat, li, mask, mults.contiguous()


def spec_tables(planes: torch.Tensor, shifts, spec_slicing: tuple[int, ...],
                valid: torch.Tensor | None = None,
                rows_per_xbar: int = 512):
    """K2's operands: ``crossbar_tables`` over the spec slices, plus the
    recovery multipliers ``rmults``."""
    w_flat, spec_li, spec_mask, mults = crossbar_tables(
        planes, shifts, spec_slicing, valid, rows_per_xbar)
    widths = [m.bit_length() for m in spec_mask]
    max_w = max(widths)
    rmults = tuple(tuple((1 << t) if t < w else 0 for t in range(max_w))
                   for w in widths)
    return w_flat, spec_li, spec_mask, mults, rmults


def fused_crossbar_forward(x_u8: torch.Tensor, planes: torch.Tensor,
                           shifts, centers: torch.Tensor, *,
                           input_slicing: tuple[int, ...],
                           adc_lo: int, adc_hi: int,
                           valid: torch.Tensor | None = None,
                           rows_per_xbar: int = 512
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused static-slicing exact datapath (paper §4.1.4): in-kernel input
    slicing, slice-plane column sums, per-segment ADC clamp, shift+add and
    the center term, one launch.

    x_u8:     (B, R) unsigned 8b input codes (any int dtype).
    planes:   (n_j, n_seg, rows_per_xbar, C) int8 signed slice planes.
    shifts:   (n_j,) per-slice recombination shifts — a tuple of ints or
              an int32 tensor (compiled per-site plans).
    centers:  (n_seg, C) int32 Center+Offset phi.
    valid:    optional (n_j,) bool mask of padded slice planes; masked
              planes are zeroed and their multipliers killed.

    Returns (psum (B, C) int32 including the center term, ADC saturations
    () int64).
    """
    w_flat, in_li, in_mask, mults = crossbar_tables(
        planes, shifts, input_slicing, valid, rows_per_xbar)
    return _fx.forward(x_u8.to(torch.int32).contiguous(), w_flat, in_li,
                       in_mask, mults, centers.to(torch.int32).contiguous(),
                       rows_per_xbar=rows_per_xbar, adc_lo=adc_lo,
                       adc_hi=adc_hi)


def sliced_crossbar_matmul(x_slices: torch.Tensor, w_planes: torch.Tensor,
                           mults: torch.Tensor, *, adc_lo: int = -64,
                           adc_hi: int = 63,
                           rows_per_xbar: int = 512) -> torch.Tensor:
    """Crossbar contraction of pre-sliced inputs with a per-segment ADC
    clamp (no center term): x_slices (n_i, B, R) int8, w_planes
    (n_j, R, C) int8, mults (n_i, n_j) -> (B, C) int32."""
    return _sx.forward(x_slices.contiguous(), w_planes.contiguous(),
                       mults.to(torch.int32).contiguous(),
                       rows_per_xbar=rows_per_xbar, adc_lo=adc_lo,
                       adc_hi=adc_hi)


def fused_spec_crossbar_forward(x_u8: torch.Tensor, planes: torch.Tensor,
                                shifts, centers: torch.Tensor, *,
                                spec_slicing: tuple[int, ...],
                                adc_lo: int, adc_hi: int,
                                valid: torch.Tensor | None = None,
                                rows_per_xbar: int = 512
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Fused speculation/recovery forward (paper §4.3).

    x_u8:     (B, R) unsigned 8b input codes (any int dtype).
    planes:   (n_j, n_seg, rows_per_xbar, C) int8 signed slice planes.
    shifts:   (n_j,) per-slice recombination shifts — a tuple of ints or
              an int32 tensor (compiled per-site plans).
    centers:  (n_seg, C) int32 Center+Offset phi.
    valid:    optional (n_j,) bool mask of padded slice planes; masked
              planes are zeroed and their multipliers killed.

    Returns (psum (B, C) int32 including the center term, spec failures
    (n_i,) int64, recovery saturations () int64).
    """
    w_flat, spec_li, spec_mask, mults, rmults = spec_tables(
        planes, shifts, spec_slicing, valid, rows_per_xbar)
    return _fs.forward(x_u8.to(torch.int32).contiguous(), w_flat, spec_li,
                       spec_mask, mults, rmults,
                       centers.to(torch.int32).contiguous(),
                       rows_per_xbar=rows_per_xbar, adc_lo=adc_lo,
                       adc_hi=adc_hi)
