"""K2: speculation + recovery in one CUDA launch (paper §4.3).

Replaces the Pallas TPU kernel ``repro/kernels/fused_spec_crossbar.py``
(``fused_spec_crossbar``). The CUDA source is ``csrc/fused_spec_crossbar.cu``,
whose header says what bounds it on the card and what its design does about
it; ``plain`` (``ref.fused_spec_crossbar``) is its plain PyTorch version.
``forward`` takes ``plain`` for CPU tensors only; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build, ref

plain = ref.fused_spec_crossbar
ROWS_PER_XBAR = 512  # the segment length the kernel is compiled for
MAX_SLICES = 8       # spec slices, recovery unroll and planes per launch

_c = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = build.CudaKernel(
    "fused_spec_crossbar",
    [_p, _p, _p, _p, _p, _p, _c, _c, _c, _c, _c, _c, _c,
     _p, _p, _p, _c, _c, _c, _p])


def check_tables(spec_li: Sequence[int], spec_mask: Sequence[int],
                 rmults: Sequence[Sequence[int]]) -> None:
    """The kernel computes the 8 bit-plane dots of the input codes and
    derives every speculative and recovery dot from them: each spec slice
    and each weighted recovery bit must lie inside bits 0..7."""
    if not 1 <= len(spec_li) <= MAX_SLICES or len(spec_mask) != len(spec_li):
        raise ValueError(f"need 1..{MAX_SLICES} spec slices, got "
                         f"{len(spec_li)} (masks {len(spec_mask)})")
    max_w = len(rmults[0])
    if not 1 <= max_w <= MAX_SLICES or any(len(r) != max_w for r in rmults):
        raise ValueError(f"rmults rows must share one width in 1..{MAX_SLICES}")
    for li, mask, rm in zip(spec_li, spec_mask, rmults):
        if li < 0 or mask < 0 or li + mask.bit_length() > 8:
            raise ValueError(f"spec slice (li={li}, mask={mask}) leaves the "
                             "8 input bits")
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
    if rows_per_xbar != ROWS_PER_XBAR:
        raise ValueError(f"kernel is built for {ROWS_PER_XBAR}-row segments, "
                         f"got rows_per_xbar={rows_per_xbar}")
    build.check_operand(x_u8, "x_u8", torch.int32, 2, dev)
    build.check_operand(w_planes, "w_planes", torch.int8, 3, dev)
    B, R = x_u8.shape
    n_j, Rp, C = w_planes.shape
    n_i = len(spec_li)
    check_tables(spec_li, spec_mask, rmults)
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
    max_w = len(rmults[0])
    out = torch.zeros((B, C), dtype=torch.int32, device=dev)
    counts = torch.zeros(n_i + 1, dtype=torch.int64, device=dev)
    bm = min(4, 1 << (B - 1).bit_length())  # batch rows per block
    KERNEL.launch(
        build.ptr(x_u8), build.ptr(w_planes), build.ptr(mults),
        build.ptr(centers), build.ptr(out), build.ptr(counts),
        B, R, C, n_seg, n_j, n_i, max_w,
        (ctypes.c_int * n_i)(*spec_li), (ctypes.c_int * n_i)(*spec_mask),
        (ctypes.c_int * (n_i * max_w))(*[v for r in rmults for v in r]),
        adc_lo, adc_hi, bm)
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
