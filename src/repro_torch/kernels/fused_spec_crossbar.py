"""K2: speculation + recovery in one CUDA launch (paper §4.3).

Replaces the Pallas TPU kernel ``repro/kernels/fused_spec_crossbar.py``
(``fused_spec_crossbar``). The CUDA source is ``csrc/fused_spec_crossbar.cu``,
whose header says what bounds it on the card and what its design does about
it; ``plain`` (``ref.fused_spec_crossbar``) is its plain PyTorch version.
``forward`` takes ``plain`` for CPU tensors only; on CUDA tensors it
launches the kernel or raises. ``tile_plan`` sizes the launch in plain
Python, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import build, ref

plain = ref.fused_spec_crossbar
ROWS_PER_XBAR = 512  # the segment length the kernel is compiled for
MAX_SLICES = 8       # spec slices, recovery unroll and planes per launch

_c = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = build.CudaKernel(
    "fused_spec_crossbar",
    [_p, _p, _p, _p, _p, _p, _p, _c, _c, _c, _c, _c, _c, _c,
     _p, _p, _p, *[_c] * 9, _p])

# the CUDA source's constants; its launcher refuses a plan that differs
BN, BK, STAGES = 64, 128, 4
BITS = 8                    # input code bits: the bit planes of the GEMM
BATCH_TILES = (1, 2, 4)     # batch rows per block: one n8 tile each
X_STRIDE = 4 * BK + 16      # staged x row stride in bytes (int32 codes)
SLAB_STRIDE = BN + 1        # int32 per (row, bit plane) of the slab
XSUM_BYTES = 32             # two parities of 4 x row sums
MAX_CLUSTER = 8             # portable thread-block cluster size
TABLE_BYTES = 336           # mults (8 x 8 int32) and 9 int64 counters
TARGET_BLOCKS = 2 * 132     # blocks per call to aim for: two per H100 SM
COUNT_SLOTS = MAX_SLICES + 1  # counts buffer: n_i failures + recovery sats
_NEXT_COUNTS: dict[tuple, torch.Tensor] = {}  # per (device, stream)


class TilePlan(NamedTuple):
    bt: int           # batch rows per block (1, 2 or 4): one n8 tile each
    bn: int           # output columns per block (4 m16 tiles)
    bk: int           # plane rows per shared-memory stage (4 k32 steps)
    stages: int       # depth of the cp.async ring
    cluster: int      # blocks of a cluster, splitting the pairs (1..8)
    pairs_per_rank: int  # (segment, plane) pairs per cluster rank
    smem_bytes: int   # dynamic shared memory per block
    grid: tuple[int, int]  # (batch tiles * cluster, column tiles)


def smem_bytes(bt: int, cluster: int) -> int:
    """The ring of stages (plane tile + padded int32 x rows); the slab the
    warps reduce into (bt x 8 rows of ``SLAB_STRIDE`` int32) and the x row
    sums; in a cluster of 2 or more the reduction's inbox (cluster slots of
    ceil(bt * BN / cluster) uint32); mults and the block's counters; each
    part rounded up to 16 bytes."""
    def r16(n):
        return -(-n // 16) * 16
    ring = STAGES * (BK * BN + bt * X_STRIDE)
    slab = r16(bt * BITS * SLAB_STRIDE * 4)
    inbox = cluster * -(-bt * BN // cluster) * 4 if cluster > 1 else 0
    return ring + slab + XSUM_BYTES + r16(inbox) + TABLE_BYTES


def tile_plan(B: int, R: int, C: int, n_j: int,
              n_seg: int | None = None) -> TilePlan:
    """Launch plan of K2 for x (B, R) and planes (n_j, n_seg * 512, C)
    (``n_seg`` defaults to the fewest segments that hold R).

    The batch tile is the fewest rows of 1, 2 or 4 (one n8 tile per row)
    that hold B, at most 4. The P = n_seg * n_j (segment, plane) pairs of
    a column tile are split across a cluster of up to 8 blocks, the most
    that keeps the call near ``TARGET_BLOCKS``; rank r owns pairs
    [r * ppr, (r + 1) * ppr), and the cluster has ceil(P / ppr) ranks, so
    none is empty (the size need not be a power of two).
    """
    if min(B, R, C, n_j) < 1:
        raise ValueError(f"empty operands: B={B}, R={R}, C={C}, n_j={n_j}")
    n_seg = -(-R // ROWS_PER_XBAR) if n_seg is None else n_seg
    if n_seg * ROWS_PER_XBAR < R:
        raise ValueError(f"{n_seg} segments do not hold {R} rows")
    bt = next(b for b in BATCH_TILES if b >= min(B, BATCH_TILES[-1]))
    batch_tiles, col_tiles = -(-B // bt), -(-C // BN)
    if col_tiles > 65535:
        raise ValueError(f"C={C} needs {col_tiles} column tiles, more than "
                         "the grid's 65535")
    n_pairs = n_seg * n_j
    want = max(1, min(MAX_CLUSTER, n_pairs,
                      -(-TARGET_BLOCKS // (batch_tiles * col_tiles))))
    ppr = -(-n_pairs // want)
    cluster = -(-n_pairs // ppr)
    return TilePlan(bt, BN, BK, STAGES, cluster, ppr,
                    smem_bytes(bt, cluster),
                    (batch_tiles * cluster, col_tiles))


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


def counts_buffers(dev: torch.device) -> tuple[tuple, torch.Tensor,
                                               torch.Tensor]:
    """This launch's counts (zero: the previous launch on ``dev``'s current
    stream zeroed it, or it is new) and the next launch's, which this
    launch zeroes; both int64 (``COUNT_SLOTS``,). The kernel adds into the
    first, so no launch needs a memset of its own. Also returns the
    (device, stream) key under which the second is kept."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    counts = _NEXT_COUNTS.get(key)
    if counts is None:
        counts = torch.zeros(COUNT_SLOTS, dtype=torch.int64, device=dev)
    return key, counts, torch.empty(COUNT_SLOTS, dtype=torch.int64,
                                    device=dev)


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
    plan = tile_plan(B, R, C, n_j, n_seg)
    out = torch.empty((B, C), dtype=torch.int32, device=dev)
    key, counts, next_counts = counts_buffers(dev)
    KERNEL.launch(
        build.ptr(x_u8), build.ptr(w_planes), build.ptr(mults),
        build.ptr(centers), build.ptr(out), build.ptr(counts),
        build.ptr(next_counts),
        B, R, C, n_seg, n_j, n_i, max_w,
        (ctypes.c_int * n_i)(*spec_li), (ctypes.c_int * n_i)(*spec_mask),
        (ctypes.c_int * (n_i * max_w))(*[v for r in rmults for v in r]),
        adc_lo, adc_hi, plan.bn, plan.bk, plan.stages, plan.bt,
        plan.cluster, plan.pairs_per_rank, plan.smem_bytes)
    # only now: a refused launch zeroed nothing, and its counts stay queued
    _NEXT_COUNTS[key] = next_counts
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
