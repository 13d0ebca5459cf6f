"""K4: crossbar contraction of pre-sliced inputs in one CUDA launch.

Replaces the Pallas TPU kernel ``repro/kernels/sliced_crossbar.py``
(``sliced_crossbar_matmul``): K1's per-segment clamp and shift+add on inputs
that arrive already sliced, without the center term or counters. The CUDA
source is ``csrc/sliced_crossbar.cu``: the int8 GEMM that K1 and K2 share
(``csrc/bitplane_gemm.cuh``) with the slice operand in place of the bit
planes and K4's own epilogue. ``plain`` (``ref.sliced_crossbar_matmul``)
is its plain PyTorch version. ``forward`` takes ``plain`` for CPU tensors
only; on CUDA tensors it launches the kernel or raises. ``tile_plan``
sizes the launch in plain Python, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bitplane, build, ref
from repro_torch.kernels.bitplane import MAX_SLICES, ROWS_PER_XBAR, TilePlan

plain = ref.sliced_crossbar_matmul

_c = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = build.CudaKernel(
    "sliced_crossbar", [_p, _p, _p, _p, *[_c] * 16, _p])


def tile_plan(B: int, R: int, C: int, n_j: int,
              rows_per_xbar: int = ROWS_PER_XBAR) -> TilePlan:
    """Launch plan of K4 for x slices (n_i, B, R) and planes (n_j, R, C)
    over segments of ``rows_per_xbar`` rows: the shared GEMM's
    (``bitplane.tile_plan``) with the slice operand's stage."""
    return bitplane.tile_plan(B, R, C, n_j, x="slices",
                              rows_per_xbar=rows_per_xbar)


def launch(x_slices: torch.Tensor, w_planes: torch.Tensor,
           mults: torch.Tensor, *, rows_per_xbar: int = ROWS_PER_XBAR,
           adc_lo: int = -64, adc_hi: int = 63) -> torch.Tensor:
    """Run the CUDA kernel. Same contract and result as ``plain``."""
    dev = x_slices.device
    if dev.type != "cuda":
        raise ValueError(f"sliced_crossbar kernel needs CUDA tensors, "
                         f"got {dev}")
    bitplane.check_rows(rows_per_xbar)
    build.check_operand(x_slices, "x_slices", torch.int8, 3, dev)
    build.check_operand(w_planes, "w_planes", torch.int8, 3, dev)
    build.check_operand(mults, "mults", torch.int32, 2, dev)
    n_i, B, R = x_slices.shape
    n_j, R2, C = w_planes.shape
    if R2 != R or tuple(mults.shape) != (n_i, n_j) or R == 0 or B == 0 \
            or C == 0 or not (1 <= n_i <= MAX_SLICES and
                              1 <= n_j <= MAX_SLICES):
        raise ValueError(f"shapes x_slices {tuple(x_slices.shape)}, w_planes "
                         f"{tuple(w_planes.shape)}, mults "
                         f"{tuple(mults.shape)} do not chain (1..{MAX_SLICES} "
                         "slices, non-empty)")
    n_seg = -(-R // rows_per_xbar)
    plan = tile_plan(B, R, C, n_j, rows_per_xbar=rows_per_xbar)
    out = torch.empty((B, C), dtype=torch.int32, device=dev)
    KERNEL.launch(build.ptr(x_slices), build.ptr(w_planes), build.ptr(mults),
                  build.ptr(out), B, R, C, n_seg, rows_per_xbar, n_j, n_i,
                  adc_lo, adc_hi,
                  plan.bn, plan.bk, plan.stages, plan.bt, plan.cluster,
                  plan.pairs_per_rank, plan.smem_bytes)
    return out


def forward(x_slices, w_planes, mults, *, rows_per_xbar: int = ROWS_PER_XBAR,
            adc_lo: int = -64, adc_hi: int = 63):
    """Dispatch by device: ``plain`` on the CPU, the kernel on CUDA."""
    fn = {"cpu": plain, "cuda": launch}.get(x_slices.device.type)
    if fn is None:
        raise ValueError(f"no sliced_crossbar_matmul for device "
                         f"{x_slices.device}")
    return fn(x_slices, w_planes, mults, rows_per_xbar=rows_per_xbar,
              adc_lo=adc_lo, adc_hi=adc_hi)
