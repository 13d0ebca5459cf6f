"""K3: centered int8 matmul in one CUDA launch (paper Eq. 1).

Replaces the Pallas TPU kernel ``repro/kernels/int8_matmul.py``
(``centered_int8_matmul``). The CUDA source is
``csrc/centered_int8_matmul.cu``, whose header says what bounds it on the
card and what its design does about it; ``plain``
(``ref.centered_int8_matmul``) is its plain PyTorch version. ``forward``
takes ``plain`` for CPU tensors only; on CUDA tensors it launches the
kernel or raises. ``tile_plan`` sizes the launch in plain Python, so the
CPU tests reach it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

plain = ref.centered_int8_matmul

_c = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = build.CudaKernel("centered_int8_matmul",
                          [_p, _p, _p, _p, *[_c] * 10, _p])

# the CUDA source's constants; its launcher refuses a plan that differs
BN, BK, STAGES, WARPS = 64, 128, 4, 4
X_STRIDE = BK + 16          # staged x row stride in bytes
MAX_CLUSTER = 8             # portable thread-block cluster size
TARGET_BLOCKS = 2 * 132     # blocks per call to aim for: two per H100 SM
MIN_RANK_K = 64             # fewest K rows worth a cluster rank


class TilePlan(NamedTuple):
    bt: int           # batch rows per block: 8 per mma n8 tile
    bn: int           # output columns per block (4 m16 tiles per warp)
    bk: int           # K rows per shared-memory stage (32 per warp)
    stages: int       # depth of the cp.async ring
    cluster: int      # blocks of a cluster, splitting K (1, 2, 4, 8)
    k_per_rank: int   # K rows per cluster rank, a multiple of 32
    smem_bytes: int   # dynamic shared memory per block
    grid: tuple[int, int]  # (column tiles * cluster, batch tiles)


def smem_bytes(bt: int, cluster: int) -> int:
    """The ring of stages (w_off tile + padded x rows), reused after the K
    loop for the warps' int32 partial tiles; in a cluster of 2 or more the
    reduction's inbox (one int32 tile; a lone block reduces in place); the
    pushed row sums (``MAX_CLUSTER`` x bt) and the warps' (``WARPS`` x bt)."""
    ring = STAGES * (BK * BN + bt * X_STRIDE)
    inbox = bt * BN * 4 if cluster > 1 else 0
    return (max(ring, WARPS * bt * BN * 4) + inbox
            + (MAX_CLUSTER + WARPS) * bt * 4)


def tile_plan(B: int, K: int, N: int) -> TilePlan:
    """Launch plan of K3 for x (B, K) and w_off (K, N).

    The batch tile is the fewest n8 mma tiles (1, 2, 4 or 8) that hold B
    rows, at most 64; K is split across a cluster of 1, 2, 4 or 8 blocks,
    the most that keeps the call near ``TARGET_BLOCKS`` blocks and each
    rank at ``MIN_RANK_K`` rows or more. Rank r covers K rows
    [r * k_per_rank, (r + 1) * k_per_rank), a multiple of 32; a rank past K
    adds zeros.
    """
    if min(B, K, N) < 1:
        raise ValueError(f"empty operands: B={B}, K={K}, N={N}")
    bt = 8 * next(n for n in (1, 2, 4, 8) if 8 * n >= min(B, 64))
    tiles = -(-N // BN) * -(-B // bt)
    want = max(1, min(MAX_CLUSTER, -(-TARGET_BLOCKS // tiles),
                      K // MIN_RANK_K))
    cluster = 1 << (want.bit_length() - 1)  # 1, 2, 4 or 8
    k_per_rank = -(-K // (32 * cluster)) * 32
    return TilePlan(bt, BN, BK, STAGES, cluster, k_per_rank,
                    smem_bytes(bt, cluster),
                    (-(-N // BN) * cluster, -(-B // bt)))


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
    plan = tile_plan(B, K, N)
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    KERNEL.launch(build.ptr(x_q), build.ptr(w_off), build.ptr(centers),
                  build.ptr(out), B, K, N, plan.bn, plan.bk, plan.stages,
                  plan.bt, plan.cluster, plan.k_per_rank, plan.smem_bytes)
    return out


def forward(x_q: torch.Tensor, w_off: torch.Tensor,
            centers: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: ``plain`` on the CPU, the kernel on CUDA."""
    fn = {"cpu": plain, "cuda": launch}.get(x_q.device.type)
    if fn is None:
        raise ValueError(f"no centered_int8_matmul for device {x_q.device}")
    return fn(x_q, w_off, centers)
