"""K3: centered int8 matmul in one CUDA launch (paper Eq. 1).

Replaces the Pallas TPU kernel ``repro/kernels/int8_matmul.py``
(``centered_int8_matmul``). The CUDA source is
``csrc/centered_int8_matmul.cu``, whose header says what bounds it on the
card and what its design does about it; ``plain``
(``ref.centered_int8_matmul``) is its plain PyTorch version. ``forward``
takes ``plain`` for CPU tensors only; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

plain = ref.centered_int8_matmul

_c = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = build.CudaKernel("centered_int8_matmul",
                          [_p, _p, _p, _p, _c, _c, _c, _c, _c, _p])


TARGET_BLOCKS = 264  # two blocks per SM of an H100


def k_split(B: int, K: int, N: int, bm: int) -> int:
    """K ranges per column tile: enough blocks to fill the card at decode
    shapes, with at least 64 rows of K per block."""
    tiles = -(-N // 128) * -(-B // bm)
    return max(1, min(-(-TARGET_BLOCKS // tiles), K // 64))


def launch(x_q: torch.Tensor, w_off: torch.Tensor,
           centers: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel. Same contract and result as ``plain``."""
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError(f"centered_int8_matmul kernel needs CUDA tensors, "
                         f"got {dev}")
    build.check_operand(x_q, "x_q", torch.int8, 2, dev)
    build.check_operand(w_off, "w_off", torch.int8, 2, dev)
    build.check_operand(centers, "centers", torch.int32, 1, dev)
    B, K = x_q.shape
    K2, N = w_off.shape
    if K2 != K or tuple(centers.shape) != (N,):
        raise ValueError(f"shapes x {tuple(x_q.shape)}, w_off "
                         f"{tuple(w_off.shape)}, centers "
                         f"{tuple(centers.shape)} do not chain")
    if B == 0 or N == 0 or K == 0:
        raise ValueError(f"empty operands: B={B}, K={K}, N={N}")
    out = torch.zeros((B, N), dtype=torch.int32, device=dev)
    bm = min(8, 1 << (B - 1).bit_length())  # batch rows per block
    KERNEL.launch(build.ptr(x_q), build.ptr(w_off), build.ptr(centers),
                  build.ptr(out), B, K, N, bm, k_split(B, K, N, bm))
    return out


def forward(x_q: torch.Tensor, w_off: torch.Tensor,
            centers: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: ``plain`` on the CPU, the kernel on CUDA."""
    fn = {"cpu": plain, "cuda": launch}.get(x_q.device.type)
    if fn is None:
        raise ValueError(f"no centered_int8_matmul for device {x_q.device}")
    return fn(x_q, w_off, centers)
