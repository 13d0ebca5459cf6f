"""The launch plan of the int8 GEMM that K1, K2 and K4 share.

Python mirror of ``csrc/bitplane_gemm.cuh``: its constants, the shared
memory a block asks for under each x operand (``X_ROW_BYTES``: K1's and
K2's int32 codes, K4's int8 slices), the tile plan (batch tile, cluster,
pairs per rank, grid) and the counts buffers that each launch zeroes for
the next launch of the same kernel. Plain Python, so the CPU tests reach
it; the C launchers refuse a plan whose constants differ from the
header's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

ROWS_PER_XBAR = 512  # RAELLA's segment length, the kernels' default
# the segment lengths the kernels are instantiated for: 1..4 stages of BK
# rows (the reference's kernels take any; ISAAC's crossbars have 128)
SEGMENT_ROWS = (128, 256, 384, 512)
MAX_SLICES = 8       # input (or spec) slices and planes per launch
BN, BK, STAGES = 64, 128, 4
BITS = 8                    # B fragment columns: bit planes or slices
BATCH_TILES = (1, 2, 4)     # batch rows per block: one n8 tile each
SLICE_STRIDE = BK + 16      # staged bytes a slice of a batch row (K4)
# staged x bytes a batch row per x operand (bitplane::CodesX, SlicesX):
# int32 codes with 16 bytes of padding, or 8 padded int8 slices
X_ROW_BYTES = {"codes": 4 * BK + 16, "slices": MAX_SLICES * SLICE_STRIDE}
SLAB_STRIDE = BN + 1        # int32 per (row, bit plane) of the slab
XSUM_BYTES = 32             # two parities of 4 x row sums
MAX_CLUSTER = 8             # portable thread-block cluster size
TABLE_BYTES = 336           # mults (8 x 8 int32) and 9 int64 counters
TARGET_BLOCKS = 2 * 132     # blocks per call to aim for: two per H100 SM
_NEXT_COUNTS: dict[tuple, torch.Tensor] = {}  # per (kernel, device, stream)


class TilePlan(NamedTuple):
    bt: int           # batch rows per block (1, 2 or 4): one n8 tile each
    bn: int           # output columns per block (4 m16 tiles)
    bk: int           # plane rows per shared-memory stage (4 k32 steps)
    stages: int       # depth of the cp.async ring
    cluster: int      # blocks of a cluster, splitting the pairs (1..8)
    pairs_per_rank: int  # (segment, plane) pairs per cluster rank
    smem_bytes: int   # dynamic shared memory per block
    grid: tuple[int, int]  # (batch tiles * cluster, column tiles)


def smem_bytes(bt: int, cluster: int, x: str = "codes") -> int:
    """The ring of stages (plane tile + the x operand's padded rows,
    ``X_ROW_BYTES[x]`` a batch row); the slab the warps reduce into (bt x
    8 rows of ``SLAB_STRIDE`` int32) and the x row sums; in a cluster of 2
    or more the reduction's inbox (cluster slots of ceil(bt * BN /
    cluster) uint32); mults and the block's counters; each part rounded up
    to 16 bytes."""
    def r16(n):
        return -(-n // 16) * 16
    ring = STAGES * (BK * BN + bt * X_ROW_BYTES[x])
    slab = r16(bt * BITS * SLAB_STRIDE * 4)
    inbox = cluster * -(-bt * BN // cluster) * 4 if cluster > 1 else 0
    return ring + slab + XSUM_BYTES + r16(inbox) + TABLE_BYTES


def check_rows(rows_per_xbar: int) -> None:
    """Refuse a segment length the kernels are not instantiated for."""
    if rows_per_xbar not in SEGMENT_ROWS:
        raise ValueError(
            f"the crossbar kernels take segments of {SEGMENT_ROWS} rows "
            f"(1 to 4 stages of {BK}), got rows_per_xbar={rows_per_xbar}; "
            "the plain versions take any")


def tile_plan(B: int, R: int, C: int, n_j: int, n_seg: int | None = None,
              bt: int | None = None, x: str = "codes",
              rows_per_xbar: int = ROWS_PER_XBAR) -> TilePlan:
    """Launch plan for B batch rows of R rows against planes (n_j, n_seg *
    rows_per_xbar, C) (``n_seg`` defaults to the fewest segments that hold
    R), x being the operand ``x`` ("codes" or "slices", which sizes its
    stage). The segment length sets the stages a pair takes, not the plan.

    The batch tile is the fewest rows of 1, 2 or 4 (one n8 tile per row)
    that hold B, at most 4 (``bt`` forces one of them instead, for
    measuring the others). The P = n_seg * n_j (segment, plane) pairs of
    a column tile are split across a cluster of up to 8 blocks, the most
    that keeps the call near ``TARGET_BLOCKS``; rank r owns pairs
    [r * ppr, (r + 1) * ppr), and the cluster has ceil(P / ppr) ranks, so
    none is empty (the size need not be a power of two).
    """
    if min(B, R, C, n_j) < 1:
        raise ValueError(f"empty operands: B={B}, R={R}, C={C}, n_j={n_j}")
    check_rows(rows_per_xbar)
    n_seg = -(-R // rows_per_xbar) if n_seg is None else n_seg
    if n_seg * rows_per_xbar < R:
        raise ValueError(f"{n_seg} segments do not hold {R} rows")
    if bt is None:
        bt = next(b for b in BATCH_TILES if b >= min(B, BATCH_TILES[-1]))
    elif bt not in BATCH_TILES:
        raise ValueError(f"batch tile {bt} is none of {BATCH_TILES}")
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
                    smem_bytes(bt, cluster, x),
                    (batch_tiles * cluster, col_tiles))


def check_slices(li_seq, mask_seq, what: str) -> None:
    """The kernels compute the 8 bit-plane dots of the input codes and
    derive every slice's dot from them: 1..8 slices, each inside bits
    0..7."""
    if not 1 <= len(li_seq) <= MAX_SLICES or len(mask_seq) != len(li_seq):
        raise ValueError(f"need 1..{MAX_SLICES} {what} slices, got "
                         f"{len(li_seq)} (masks {len(mask_seq)})")
    for li, mask in zip(li_seq, mask_seq):
        if li < 0 or mask < 0 or li + mask.bit_length() > BITS:
            raise ValueError(f"{what} slice (li={li}, mask={mask}) leaves "
                             "the 8 input bits")


def counts_buffers(kernel: str, dev: torch.device, slots: int
                   ) -> tuple[tuple, torch.Tensor, torch.Tensor]:
    """``kernel``'s counts for this launch (zero: its previous launch on
    ``dev``'s current stream zeroed it, or it is new) and for its next
    launch, which this launch zeroes; both int64 (``slots``,). The kernel
    adds into the first, so no launch needs a memset of its own; each
    kernel keeps its own chain, so interleaved launches of two kernels on
    one stream never add into each other's counts. Also returns the key
    under which the wrapper queues the second once the launch went out."""
    key = (kernel, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    counts = _NEXT_COUNTS.get(key)
    if counts is None:
        counts = torch.zeros(slots, dtype=torch.int64, device=dev)
    return key, counts, torch.empty(slots, dtype=torch.int64, device=dev)


def queue_counts(key: tuple, next_counts: torch.Tensor) -> None:
    """After a launch that went out: its zeroed buffer is the next
    launch's counts (a refused launch zeroed nothing, and the counts it
    would have used stay queued)."""
    _NEXT_COUNTS[key] = next_counts


def check_operands(x_u8: torch.Tensor, w_planes: torch.Tensor,
                   n_i: int, mults: torch.Tensor, centers: torch.Tensor,
                   rows_per_xbar: int, dev) -> tuple[int, int, int, int, int]:
    """What the C launchers read as raw pointers, checked: x (B, R) int32,
    planes (n_j, n_seg * rows_per_xbar, C) int8 holding R, mults (n_i, n_j)
    and centers (n_seg, C) int32, all contiguous on ``dev``; a segment
    length of ``SEGMENT_ROWS``. Returns (B, R, C, n_j, n_seg)."""
    check_rows(rows_per_xbar)
    build.check_operand(x_u8, "x_u8", torch.int32, 2, dev)
    build.check_operand(w_planes, "w_planes", torch.int8, 3, dev)
    B, R = x_u8.shape
    n_j, Rp, C = w_planes.shape
    if Rp % rows_per_xbar or Rp < R or not 1 <= n_j <= MAX_SLICES:
        raise ValueError(f"w_planes {tuple(w_planes.shape)} does not fit "
                         f"x rows {R} in {rows_per_xbar}-row segments "
                         f"with 1..{MAX_SLICES} planes")
    n_seg = Rp // rows_per_xbar
    build.check_operand(mults, "mults", torch.int32, 2, dev)
    build.check_operand(centers, "centers", torch.int32, 2, dev)
    if tuple(mults.shape) != (n_i, n_j) or tuple(centers.shape) != (n_seg, C):
        raise ValueError(f"mults {tuple(mults.shape)} / centers "
                         f"{tuple(centers.shape)} != {(n_i, n_j)} / "
                         f"{(n_seg, C)}")
    if B == 0 or C == 0:
        raise ValueError(f"empty operands: B={B}, C={C}")
    return B, R, C, n_j, n_seg
