"""K1: the static-slicing exact datapath in one CUDA launch (paper §4.1.4).

Replaces the Pallas TPU kernel ``repro/kernels/fused_crossbar.py``
(``fused_crossbar``). The CUDA source is ``csrc/fused_crossbar.cu``, whose
header says what bounds it on the card and what its design does about it;
``plain`` (``ref.fused_crossbar``) is its plain PyTorch version. ``forward``
takes ``plain`` for CPU tensors only; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build, ref

plain = ref.fused_crossbar
ROWS_PER_XBAR = 512  # the segment length the kernel is compiled for
MAX_SLICES = 8       # input slices and planes per launch
MAX_BM = 8           # batch rows per block

_c = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = build.CudaKernel(
    "fused_crossbar",
    [_p, _p, _p, _p, _p, _p, _c, _c, _c, _c, _c, _c, _p, _p, _c, _c, _c, _p])


def check_tables(in_li: Sequence[int], in_mask: Sequence[int]) -> None:
    """The kernel computes the 8 bit-plane dots of the input codes and
    derives every input slice's dot from them: each slice must lie inside
    bits 0..7."""
    if not 1 <= len(in_li) <= MAX_SLICES or len(in_mask) != len(in_li):
        raise ValueError(f"need 1..{MAX_SLICES} input slices, got "
                         f"{len(in_li)} (masks {len(in_mask)})")
    for li, mask in zip(in_li, in_mask):
        if li < 0 or mask < 0 or li + mask.bit_length() > 8:
            raise ValueError(f"input slice (li={li}, mask={mask}) leaves the "
                             "8 input bits")


def batch_tile(B: int) -> int:
    """Batch rows per block: the next power of two of B, at most 8."""
    return min(MAX_BM, 1 << (B - 1).bit_length())


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
    if rows_per_xbar != ROWS_PER_XBAR:
        raise ValueError(f"kernel is built for {ROWS_PER_XBAR}-row segments, "
                         f"got rows_per_xbar={rows_per_xbar}")
    build.check_operand(x_u8, "x_u8", torch.int32, 2, dev)
    build.check_operand(w_planes, "w_planes", torch.int8, 3, dev)
    B, R = x_u8.shape
    n_j, Rp, C = w_planes.shape
    n_i = len(in_li)
    check_tables(in_li, in_mask)
    if Rp % ROWS_PER_XBAR or Rp < R or not 1 <= n_j <= MAX_SLICES:
        raise ValueError(f"w_planes {tuple(w_planes.shape)} does not fit "
                         f"x rows {R} in {ROWS_PER_XBAR}-row segments "
                         f"with 1..{MAX_SLICES} planes")
    n_seg = Rp // ROWS_PER_XBAR
    build.check_operand(mults, "mults", torch.int32, 2, dev)
    build.check_operand(centers, "centers", torch.int32, 2, dev)
    if tuple(mults.shape) != (n_i, n_j) or tuple(centers.shape) != (n_seg, C):
        raise ValueError(f"mults {tuple(mults.shape)} / centers "
                         f"{tuple(centers.shape)} != {(n_i, n_j)} / "
                         f"{(n_seg, C)}")
    if B == 0 or C == 0:
        raise ValueError(f"empty operands: B={B}, C={C}")
    out = torch.zeros((B, C), dtype=torch.int32, device=dev)
    sats = torch.zeros((), dtype=torch.int64, device=dev)
    KERNEL.launch(
        build.ptr(x_u8), build.ptr(w_planes), build.ptr(mults),
        build.ptr(centers), build.ptr(out), build.ptr(sats),
        B, R, C, n_seg, n_j, n_i,
        (ctypes.c_int * n_i)(*in_li), (ctypes.c_int * n_i)(*in_mask),
        adc_lo, adc_hi, batch_tile(B))
    return out, sats


def forward(x_u8, w_planes, in_li, in_mask, mults, centers, *,
            rows_per_xbar: int = ROWS_PER_XBAR, adc_lo: int = -64,
            adc_hi: int = 63):
    """Dispatch by device: ``plain`` on the CPU, the kernel on CUDA."""
    fn = {"cpu": plain, "cuda": launch}.get(x_u8.device.type)
    if fn is None:
        raise ValueError(f"no fused_crossbar for device {x_u8.device}")
    return fn(x_u8, w_planes, in_li, in_mask, mults, centers,
              rows_per_xbar=rows_per_xbar, adc_lo=adc_lo, adc_hi=adc_hi)
