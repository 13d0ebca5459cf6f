"""Center+Offset weight encoding (paper §4.1).

Port of ``repro.core.center_offset``. Weights live in the unsigned 8b domain
[0, 255] on-crossbar (signed int8 weights shifted by +128). For each
*filter segment* — the rows of one dot product that fit in a single 512-row
crossbar — we pick an integer center ``phi in {1..255}`` minimizing Eq. 2:

    argmin_phi  sum_j 2^{l_j} * ( sum_w D(h_j, l_j, w - phi) )^4

Eq. 2's inner sum depends only on the per-column histogram of weight values,
so all 255 candidates are scored with one (cols, 256) x (256, 255) product
per slice. The reference does this in numpy on the host; here it runs on
the tensors' device (``torch.bincount`` histograms, float64 products), which
keeps the full-width compile within seconds on the card. The centers stay
identical to the reference's: histogram counts and column sums are exact
integers in float64, ``col_sum**4 <= (512*15)**4 < 2**53`` is computed
exactly as ``(c*c)*(c*c)``, the ``2**l`` factor is exact, the slices are
summed in ``slice_bounds`` order like the reference (the only rounding
step), and ``argmin`` returns the first minimum as ``np.argmin`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import slicing as sl

ROWS_PER_CROSSBAR = 512
N_CANDIDATES = 255  # paper: phi in {1..255}


def _d_table(h: int, l: int, device) -> torch.Tensor:
    """D(h, l, w - phi) for all (phi in 1..255, w in 0..255): (255, 256)."""
    phi = torch.arange(1, 256, device=device)[:, None]
    w = torch.arange(256, device=device)[None, :]
    r = w - phi
    mask = (1 << (h - l + 1)) - 1
    return torch.sign(r) * ((r.abs() >> l) & mask)


def column_histograms(w_u8: torch.Tensor,
                      row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-column 256-bin histograms. w_u8: (rows, cols) in [0,255] ->
    (cols, 256) int64."""
    w = w_u8.to(torch.int64)
    if row_mask is not None:
        w = w[row_mask]
    cols = w.shape[1]
    idx = torch.arange(cols, device=w.device)[None, :] * 256 + w
    return torch.bincount(idx.reshape(-1),
                          minlength=cols * 256).reshape(cols, 256)


def eq2_costs(hist: torch.Tensor, slicing: Sequence[int]) -> torch.Tensor:
    """Eq. 2 cost for every candidate center. hist: (cols, 256) ->
    (cols, 255) float64."""
    costs = torch.zeros((hist.shape[0], N_CANDIDATES), dtype=torch.float64,
                        device=hist.device)
    h64 = hist.to(torch.float64)
    for (h, l) in sl.slice_bounds(slicing, sl.WEIGHT_BITS):
        col_sum = h64 @ _d_table(h, l, hist.device).T.to(torch.float64)
        sq = col_sum * col_sum
        costs += (2.0 ** l) * (sq * sq)
    return costs


def solve_centers(w_u8: torch.Tensor, slicing: Sequence[int],
                  row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Optimal per-column center phi. w_u8: (rows<=512, cols) -> (cols,)
    int32."""
    costs = eq2_costs(column_histograms(w_u8, row_mask), slicing)
    return (torch.argmin(costs, dim=1) + 1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class EncodedWeights:
    """A layer's weights, Center+Offset encoded and sliced for crossbars.

    planes:   (n_slices, n_seg, ROWS, cols) int8 — signed sign-magnitude
              slice values in [-(2^b-1), 2^b-1]; zero-padded rows contribute
              nothing.
    centers:  (n_seg, cols) int32 — per filter-segment centers.
    slicing:  weight slicing tuple, MSB-first (None for compiled per-site
              plans, whose ``shifts`` is an int32 tensor).
    shifts:   per-slice recombination shift 2**l.
    rows:     true (unpadded) input length.
    """
    planes: torch.Tensor
    centers: torch.Tensor
    slicing: tuple[int, ...] | None
    shifts: tuple[int, ...] | torch.Tensor
    rows: int
    rows_per_xbar: int = ROWS_PER_CROSSBAR

    @property
    def n_slices(self) -> int:
        return int(self.planes.shape[0])

    @property
    def n_segments(self) -> int:
        return int(self.planes.shape[1])

    @property
    def cols(self) -> int:
        return int(self.planes.shape[3])


def encode(w_u8: torch.Tensor, slicing: Sequence[int],
           mode: str = "center",
           rows_per_xbar: int = ROWS_PER_CROSSBAR) -> EncodedWeights:
    """Encode unsigned 8b weights (rows, cols) for the crossbar.

    mode='center': Center+Offset (Eq. 2 optimal centers).
    mode='zero':   Zero+Offset differential (center fixed at 128).
    mode='unsigned': ISAAC-style raw unsigned weights (center 0).
    """
    w_u8 = w_u8.to(torch.int64)
    if w_u8.ndim != 2:
        raise ValueError("expected (rows, cols) weight matrix")
    rows, cols = w_u8.shape
    n_seg = -(-rows // rows_per_xbar)
    pad = n_seg * rows_per_xbar - rows
    segs = torch.nn.functional.pad(w_u8, (0, 0, 0, pad)).reshape(
        n_seg, rows_per_xbar, cols)
    seg_mask = torch.nn.functional.pad(
        torch.ones(rows, dtype=torch.bool, device=w_u8.device),
        (0, pad)).reshape(n_seg, rows_per_xbar)
    centers = torch.zeros((n_seg, cols), dtype=torch.int32,
                          device=w_u8.device)
    planes = torch.zeros((len(slicing), n_seg, rows_per_xbar, cols),
                         dtype=torch.int8, device=w_u8.device)
    bounds = sl.slice_bounds(slicing, sl.WEIGHT_BITS)
    for s in range(n_seg):
        if mode == "center":
            centers[s] = solve_centers(segs[s], slicing, row_mask=seg_mask[s])
        elif mode == "zero":
            centers[s] = 128
        elif mode == "unsigned":
            centers[s] = 0
        else:
            raise ValueError(f"unknown encode mode {mode!r}")
        r = segs[s] - centers[s][None, :].to(torch.int64)
        r = torch.where(seg_mask[s][:, None], r, 0)  # padded rows: no offsets
        for j, (h, l) in enumerate(bounds):
            mask = (1 << (h - l + 1)) - 1
            planes[j, s] = (torch.sign(r) * ((r.abs() >> l) & mask)).to(
                torch.int8)
    return EncodedWeights(
        planes=planes, centers=centers, slicing=tuple(slicing),
        shifts=sl.slice_shifts(slicing, sl.WEIGHT_BITS), rows=int(rows),
        rows_per_xbar=rows_per_xbar)


def center_term(x_u8: torch.Tensor, enc: EncodedWeights) -> torch.Tensor:
    """The digital term phi * sum(I) of Eq. 1, per segment, summed.

    x_u8: (..., rows) unsigned 8b inputs -> (..., cols) int32. An int64
    broadcast-sum over the few segments: CUDA has no integer matmul.
    """
    rows_pad = enc.n_segments * enc.rows_per_xbar
    xp = torch.nn.functional.pad(x_u8.to(torch.int64),
                                 (0, rows_pad - x_u8.shape[-1]))
    seg_sums = xp.reshape(x_u8.shape[:-1] + (enc.n_segments,
                                             enc.rows_per_xbar)).sum(-1)
    out = (seg_sums[..., :, None] * enc.centers.to(torch.int64)).sum(-2)
    return out.to(torch.int32)
