"""K1: the static-slicing exact datapath in one CUDA launch (paper §4.1.4).

Replaces the Pallas TPU kernel ``repro/kernels/fused_crossbar.py``
(``fused_crossbar``). The CUDA source is ``csrc/fused_crossbar.cu``: K2's
bit-plane int8 GEMM (``csrc/bitplane_gemm.cuh``, whose header says what
bounds it on the card and what its design does about it) with K1's own
epilogue. ``plain`` (``ref.fused_crossbar``) is its plain PyTorch version.
``forward`` takes ``plain`` for CPU tensors only; on CUDA tensors it
launches the kernel or raises. ``tile_plan`` sizes the launch in plain
Python, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import bitplane, build, ref
from repro_torch.kernels.bitplane import MAX_SLICES, ROWS_PER_XBAR, TilePlan

plain = ref.fused_crossbar
COUNT_SLOTS = 1  # counts buffer: the saturations

_c = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = build.CudaKernel(
    "fused_crossbar",
    [_p, _p, _p, _p, _p, _p, _p, _c, _c, _c, _c, _c, _c, _p, _p,
     *[_c] * 9, _p])


def check_tables(in_li: Sequence[int], in_mask: Sequence[int]) -> None:
    """The kernel computes the 8 bit-plane dots of the input codes and
    derives every input slice's dot from them: each slice must lie inside
    bits 0..7."""
    bitplane.check_slices(in_li, in_mask, "input")


def tile_plan(B: int, R: int, C: int, n_j: int,
              n_seg: int | None = None) -> TilePlan:
    """Launch plan of K1 for x (B, R) and planes (n_j, n_seg * 512, C):
    K2's (``bitplane.tile_plan``). At Algorithm 1's B = 16 that is four
    4-row batch tiles, which measured faster than 2- or 1-row tiles
    (``csrc/fused_crossbar.cu`` says by how much)."""
    return bitplane.tile_plan(B, R, C, n_j, n_seg)


def launch(x_u8: torch.Tensor, w_planes: torch.Tensor,
           in_li: Sequence[int], in_mask: Sequence[int],
           mults: torch.Tensor, centers: torch.Tensor, *,
           rows_per_xbar: int = ROWS_PER_XBAR,
           adc_lo: int = -64, adc_hi: int = 63
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel. Same contract and results as ``plain``."""
    dev = x_u8.device
    if dev.type != "cuda":
        raise ValueError(f"fused_crossbar kernel needs CUDA tensors, got {dev}")
    n_i = len(in_li)
    check_tables(in_li, in_mask)
    B, R, C, n_j, n_seg = bitplane.check_operands(
        x_u8, w_planes, n_i, mults, centers, rows_per_xbar, dev)
    plan = tile_plan(B, R, C, n_j, n_seg)
    out = torch.empty((B, C), dtype=torch.int32, device=dev)
    key, counts, next_counts = bitplane.counts_buffers(
        KERNEL.name, dev, COUNT_SLOTS)
    KERNEL.launch(
        build.ptr(x_u8), build.ptr(w_planes), build.ptr(mults),
        build.ptr(centers), build.ptr(out), build.ptr(counts),
        build.ptr(next_counts), B, R, C, n_seg, n_j, n_i,
        (ctypes.c_int * n_i)(*in_li), (ctypes.c_int * n_i)(*in_mask),
        adc_lo, adc_hi, plan.bn, plan.bk, plan.stages, plan.bt,
        plan.cluster, plan.pairs_per_rank, plan.smem_bytes)
    bitplane.queue_counts(key, next_counts)
    return out, counts[0]


def forward(x_u8, w_planes, in_li, in_mask, mults, centers, *,
            rows_per_xbar: int = ROWS_PER_XBAR, adc_lo: int = -64,
            adc_hi: int = 63):
    """Dispatch by device: ``plain`` on the CPU, the kernel on CUDA."""
    fn = {"cpu": plain, "cuda": launch}.get(x_u8.device.type)
    if fn is None:
        raise ValueError(f"no fused_crossbar for device {x_u8.device}")
    return fn(x_u8, w_planes, in_li, in_mask, mults, centers,
              rows_per_xbar=rows_per_xbar, adc_lo=adc_lo, adc_hi=adc_hi)
