"""K2: speculation + recovery in one CUDA launch (paper §4.3).

Replaces the Pallas TPU kernel ``repro/kernels/fused_spec_crossbar.py``
(``fused_spec_crossbar``). The CUDA source is ``csrc/fused_spec_crossbar.cu``
on the bit-plane GEMM of ``csrc/bitplane_gemm.cuh``, whose header says what
bounds it on the card and what its design does about it; ``plain``
(``ref.fused_spec_crossbar``) is its plain PyTorch version. ``forward``
takes ``plain`` for CPU tensors only; on CUDA tensors it launches the
kernel or raises. ``tile_plan`` (``bitplane.tile_plan``) sizes the launch
in plain Python, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import bitplane, build, ref
from repro_torch.kernels.bitplane import MAX_SLICES, ROWS_PER_XBAR, tile_plan

plain = ref.fused_spec_crossbar
COUNT_SLOTS = MAX_SLICES + 1  # counts buffer: n_i failures + recovery sats

_c = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = build.CudaKernel(
    "fused_spec_crossbar",
    [_p, _p, _p, _p, _p, _p, _p, _c, _c, _c, _c, _c, _c, _c,
     _p, _p, _p, *[_c] * 9, _p])


def check_tables(spec_li: Sequence[int], spec_mask: Sequence[int],
                 rmults: Sequence[Sequence[int]]) -> None:
    """The kernel computes the 8 bit-plane dots of the input codes and
    derives every speculative and recovery dot from them: each spec slice
    and each weighted recovery bit must lie inside bits 0..7."""
    bitplane.check_slices(spec_li, spec_mask, "spec")
    max_w = len(rmults[0])
    if not 1 <= max_w <= MAX_SLICES or any(len(r) != max_w for r in rmults):
        raise ValueError(f"rmults rows must share one width in 1..{MAX_SLICES}")
    for li, rm in zip(spec_li, rmults):
        if any(r != 0 and li + t >= 8 for t, r in enumerate(rm)):
            raise ValueError(f"recovery bits past bit 7 weighted: li={li}, "
                             f"rmults={list(rm)}")


def launch(x_u8: torch.Tensor, w_planes: torch.Tensor,
           spec_li: Sequence[int], spec_mask: Sequence[int],
           mults: torch.Tensor, rmults: Sequence[Sequence[int]],
           centers: torch.Tensor, *, rows_per_xbar: int = ROWS_PER_XBAR,
           adc_lo: int = -64, adc_hi: int = 63
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel. Same contract and results as ``plain``."""
    dev = x_u8.device
    if dev.type != "cuda":
        raise ValueError(f"fused_spec_crossbar kernel needs CUDA tensors, "
                         f"got {dev}")
    n_i = len(spec_li)
    check_tables(spec_li, spec_mask, rmults)
    B, R, C, n_j, n_seg = bitplane.check_operands(
        x_u8, w_planes, n_i, mults, centers, rows_per_xbar, dev)
    max_w = len(rmults[0])
    plan = tile_plan(B, R, C, n_j, n_seg)
    out = torch.empty((B, C), dtype=torch.int32, device=dev)
    key, counts, next_counts = bitplane.counts_buffers(
        KERNEL.name, dev, COUNT_SLOTS)
    KERNEL.launch(
        build.ptr(x_u8), build.ptr(w_planes), build.ptr(mults),
        build.ptr(centers), build.ptr(out), build.ptr(counts),
        build.ptr(next_counts),
        B, R, C, n_seg, n_j, n_i, max_w,
        (ctypes.c_int * n_i)(*spec_li), (ctypes.c_int * n_i)(*spec_mask),
        (ctypes.c_int * (n_i * max_w))(*[v for r in rmults for v in r]),
        adc_lo, adc_hi, plan.bn, plan.bk, plan.stages, plan.bt,
        plan.cluster, plan.pairs_per_rank, plan.smem_bytes)
    bitplane.queue_counts(key, next_counts)
    return out, counts[:n_i], counts[n_i]


def forward(x_u8, w_planes, spec_li, spec_mask, mults, rmults, centers, *,
            rows_per_xbar: int = ROWS_PER_XBAR, adc_lo: int = -64,
            adc_hi: int = 63):
    """Dispatch by device: ``plain`` on the CPU, the kernel on CUDA."""
    fn = {"cpu": plain, "cuda": launch}.get(x_u8.device.type)
    if fn is None:
        raise ValueError(f"no fused_spec_crossbar for device {x_u8.device}")
    return fn(x_u8, w_planes, spec_li, spec_mask, mults, rmults, centers,
              rows_per_xbar=rows_per_xbar, adc_lo=adc_lo, adc_hi=adc_hi)
