"""The port's plain kernel versions against the reference kernels.

Every quantity here is an integer, so everything is held bit for bit:
``repro_torch.kernels`` K2 (speculation + recovery) and K3 (centered int8
matmul), through their ``ops`` wrappers, against the reference's Pallas
kernels in interpret mode, its XLA oracles and its Python speculation loop,
on the same numpy-seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as ref_adc
from repro.core import center_offset as ref_co
from repro.core import speculation as ref_spec
from repro.kernels import ops as ref_ops
from repro_torch.core import adc as adc_lib
from repro_torch.core import center_offset as co
from repro_torch.core import speculation as spec
from repro_torch.kernels import bitplane as bp
from repro_torch.kernels import fused_spec_crossbar as fs
from repro_torch.kernels import int8_matmul as im
from repro_torch.kernels import ops

STAT_FIELDS = ("adc_converts", "no_spec_converts", "spec_failures",
               "spec_attempts", "recovery_saturations", "cycles", "macs")
ROWS, COLS, BATCH = 1100, 40, 6   # 3 segments, the last one ragged


@pytest.fixture(scope="module")
def layer():
    rng = np.random.default_rng(11)
    w_u = rng.integers(0, 256, (ROWS, COLS)).astype(np.int64)
    x = rng.integers(0, 256, (BATCH, ROWS)).astype(np.int32)
    enc_ref = ref_co.encode(w_u, (4, 2, 2))
    enc = co.encode(torch.from_numpy(w_u), (4, 2, 2))
    return w_u, x, enc_ref, enc


def test_encode_matches_reference(layer):
    _, _, enc_ref, enc = layer
    np.testing.assert_array_equal(enc.planes.numpy(), enc_ref.planes)
    np.testing.assert_array_equal(enc.centers.numpy(), enc_ref.centers)
    assert enc.shifts == enc_ref.shifts and enc.rows == enc_ref.rows


@pytest.mark.parametrize("bits", [7, 24])
@pytest.mark.parametrize("padded", [False, True])
def test_k2_plain_matches_pallas_interpret(layer, bits, padded):
    """psum, failures per spec slice and recovery saturations, at the
    paper's 7b ADC (failures and recovery run) and the lossless 24b."""
    _, x, enc_ref, enc = layer
    adc = ref_adc.ADCConfig(bits=bits, signed=True)
    planes, shifts = enc_ref.planes, np.asarray(enc_ref.shifts, np.int32)
    valid = None
    if padded:  # one zeroed padding plane, as compiled ragged plans carry
        planes = np.concatenate([planes, np.full_like(planes[:1], 3)])
        shifts = np.append(shifts, 5).astype(np.int32)
        valid = np.array([True, True, True, False])
    ref = ref_ops.fused_spec_crossbar_forward(
        jnp.asarray(x), jnp.asarray(planes), jnp.asarray(shifts),
        jnp.asarray(enc_ref.centers), spec_slicing=(4, 2, 2),
        adc_lo=adc.lo, adc_hi=adc.hi,
        valid=None if valid is None else jnp.asarray(valid),
        backend="interpret")
    got = ops.fused_spec_crossbar_forward(
        torch.from_numpy(x), torch.from_numpy(planes),
        torch.from_numpy(shifts), enc.centers, spec_slicing=(4, 2, 2),
        adc_lo=adc.lo, adc_hi=adc.hi,
        valid=None if valid is None else torch.from_numpy(valid))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if bits == 7:
        assert int(got[1].sum()) > 0 and int(got[2]) > 0


@pytest.mark.parametrize("bits", [7, 24])
@pytest.mark.parametrize("backend", [None, "python"])
def test_speculation_matches_reference_loop(layer, bits, backend):
    """core.speculation.forward, fused op and loop, against the
    reference's Python loop: psum and every SpeculationStats field."""
    _, x, enc_ref, enc = layer
    ref_psum, ref_st = ref_spec.forward(
        jnp.asarray(x), enc_ref, (4, 2, 2),
        ref_adc.ADCConfig(bits=bits), backend="python")
    psum, st = spec.forward(torch.from_numpy(x), enc, (4, 2, 2),
                            adc_lib.ADCConfig(bits=bits), backend=backend)
    np.testing.assert_array_equal(psum.numpy(), np.asarray(ref_psum))
    for f in STAT_FIELDS:
        assert int(getattr(st, f)) == int(getattr(ref_st, f)), f


def test_speculation_valid_mask_matches_reference(layer):
    _, x, enc_ref, enc = layer
    valid = np.array([True, False, True])
    ref_psum, ref_st = ref_spec.forward(
        jnp.asarray(x), enc_ref, (4, 2, 2), ref_adc.ADCConfig(bits=6),
        valid=jnp.asarray(valid), backend="python")
    for backend in (None, "python"):
        psum, st = spec.forward(torch.from_numpy(x), enc, (4, 2, 2),
                                adc_lib.ADCConfig(bits=6), backend=backend,
                                valid=torch.from_numpy(valid))
        np.testing.assert_array_equal(psum.numpy(), np.asarray(ref_psum))
        for f in STAT_FIELDS:
            assert int(getattr(st, f)) == int(getattr(ref_st, f)), f


# K3 shapes (B, K, N[, extreme]): the first three from the start; then
# tails of the CUDA tiling (int8_matmul.tile_plan): K off multiples of 32
# and of the 128-row stage, N off multiples of 16 and of the 64-column
# tile, batch tiles of 8, 16, 32 and two of 64 rows, ranks of a cluster
# that lie past K; then x full of -128 against centers near the int32
# limits, where y wraps modulo 2^32
K3_SHAPES = [(1, 64, 48), (5, 300, 130), (8, 1100, 96), (3, 1000, 1000),
             (9, 1040, 1008), (17, 520, 200), (65, 96, 40), (4, 1000, 72),
             (4, 1024, 64, True), (9, 1000, 72, True), (64, 300, 48, True)]


def k3_operands(B, K, N, extreme=False):
    """Seeded K3 operands. ``extreme``: x half -128 and centers across the
    int32 range, so that y wraps."""
    rng = np.random.default_rng(B * K + N)
    x = rng.integers(-128, 128, (B, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    c = rng.integers(-300, 300, (N,)).astype(np.int32)
    if extreme:
        x[:, ::2] = -128
        c = rng.integers(-2**31, 2**31, (N,)).astype(np.int32)
        y = (x.astype(np.int64) @ w + x.astype(np.int64).sum(1)[:, None]
             * c.astype(np.int64))
        assert np.abs(y).max() > 2**31  # the wrap is exercised
    return x, w, c


@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_plain_matches_pallas_interpret(shape):
    x, w, c = k3_operands(*shape)
    ref = ref_ops.centered_int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(c), backend="interpret")
    got = ops.centered_int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


SITE_SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024), (1024, 151936)]
SMEM_LIMIT = 232_448  # bytes a block may use on an H100


@pytest.mark.parametrize("B", [1, 3, 4, 9, 16, 17, 64, 65])
@pytest.mark.parametrize("KN", SITE_SHAPES + [(1000, 1000), (1040, 1008),
                                               (520, 200), (96, 40)])
def test_k3_tile_plan_within_limits(KN, B):
    """The launch plan fits the card: shared memory, a portable cluster,
    the grid limits; its batch tile holds B (or 64 rows) and its cluster
    ranks cover K."""
    K, N = KN
    p = im.tile_plan(B, K, N)
    assert p.smem_bytes <= SMEM_LIMIT
    assert p.cluster in (1, 2, 4, 8) and p.grid[0] % p.cluster == 0
    assert p.grid[0] < 2**31 and p.grid[1] <= 65535
    assert p.bt in (8, 16, 32, 64) and p.bt >= min(B, 64)
    assert p.bt < 2 * min(B, 64) or p.bt == 8
    assert p.grid == (-(-N // p.bn) * p.cluster, -(-B // p.bt))
    assert p.k_per_rank % 32 == 0 and p.cluster * p.k_per_rank >= K
    # ranks past K (a power-of-two cluster over 32-row units) add zeros;
    # more than half the ranks hold rows
    assert 2 * -(-K // p.k_per_rank) > p.cluster
    assert p.k_per_rank >= im.MIN_RANK_K or p.cluster == 1
    assert (p.bn, p.bk, p.stages) == (im.BN, im.BK, im.STAGES)
    assert p.smem_bytes == im.smem_bytes(p.bt, p.cluster)


def tile_walk(x, w, c, plan):
    """numpy walk of the CUDA kernel's tiling: per (column tile, batch tile)
    and cluster rank, its K range in 128-row stages zero-filled past the
    operands, each warp's 32-row slice as m16n8k32 products (MMA row m of
    m16 tile i is column 32*(m//8) + 4*(m%8) + i), warp partials and row
    sums reduced per block, pushed to the owning rank's inbox slot, summed
    there with the center term and wrapped to int32."""
    B, K = x.shape
    N = w.shape[1]
    bt, bn, bk, cs, kpr = (plan.bt, plan.bn, plan.bk, plan.cluster,
                           plan.k_per_rank)
    perm = np.array([[32 * (m // 8) + 4 * (m % 8) + i for m in range(16)]
                     for i in range(4)])          # (m16 tile, MMA row)
    assert sorted(perm.ravel()) == list(range(bn))
    y = np.full((B, N), -1, np.int64)
    for ct in range(plan.grid[0] // cs):
        col0 = ct * bn
        for bt_i in range(plan.grid[1]):
            b0 = bt_i * bt
            per = bt * bn // cs
            inbox = np.zeros((cs, cs * per), np.int64)
            rs_in = np.zeros((cs, cs, bt), np.int64)
            for rank in range(cs):
                k_lo, k_hi = rank * kpr, min(K, rank * kpr + kpr)
                red = np.zeros((4, bt, bn), np.int64)
                rs_w = np.zeros((4, bt), np.int64)
                for k0 in range(k_lo, k_hi, bk):
                    ws = np.zeros((bk, bn), np.int64)
                    xs = np.zeros((bt, bk), np.int64)
                    kk = min(bk, k_hi - k0)
                    cc = max(0, min(bn, N - col0))
                    ws[:kk, :cc] = w[k0:k0 + kk, col0:col0 + cc]
                    rr = max(0, min(bt, B - b0))
                    xs[:rr, :kk] = x[b0:b0 + rr, k0:k0 + kk]
                    for warp in range(4):
                        rows = slice(32 * warp, 32 * warp + 32)
                        for i in range(4):
                            a = ws[rows][:, perm[i]].T   # (16, 32)
                            for n in range(bt // 8):
                                bx = xs[8 * n:8 * n + 8, rows].T  # (32, 8)
                                red[warp, 8 * n:8 * n + 8, perm[i]] += a @ bx
                        rs_w[warp] += xs[:, rows].sum(1)
                part = red.sum(0).ravel()
                for e in range(bt * bn):
                    inbox[e // per, rank * per + e % per] = part[e]
                rs_in[:, rank] = rs_w.sum(0)
            for owner in range(cs):
                for j in range(per):
                    e = owner * per + j
                    b, cc = divmod(e, bn)
                    row, col = b0 + b, col0 + cc
                    if row < B and col < N:
                        s = inbox[owner, j::per].sum()
                        xsum = rs_in[owner, :, b].sum()
                        y[row, col] = s + xsum * int(c[col])
    return ((y + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("shape", [(3, 100, 70), (17, 130, 64), (9, 300, 72),
                                   (4, 520, 40), (65, 96, 16)])
@pytest.mark.parametrize("extreme", [False, True])
def test_k3_tile_walk_matches_plain(shape, extreme):
    """The kernel's tiling, edge masking, K split and cluster reduction,
    walked in numpy, equal the plain version exactly; the shapes give
    clusters of 1, 2, 4 and 8 (ranks past K at K = 520)."""
    x, w, c = k3_operands(*shape, extreme=extreme)
    plan = im.tile_plan(*shape)
    got = tile_walk(x, w, c, plan)
    want = ops.centered_int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(c))
    np.testing.assert_array_equal(got, want.numpy())


def test_kernel_tables_reject_bits_past_eight():
    with pytest.raises(ValueError):
        fs.check_tables((5,), (15,), ((1, 2, 4, 8),))
    with pytest.raises(ValueError):
        fs.check_tables((6,), (3,), ((1, 2, 4, 0),))
    fs.check_tables((4, 2, 0), (15, 3, 3),
                    ((1, 2, 4, 8), (1, 2, 0, 0), (1, 2, 0, 0)))


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """The built library's name hashes the source and every local header
    it includes, recursively: editing a header, even one included only by
    another header, names another library, so no stale build loads."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cstdint>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("constexpr int N = 1;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("constexpr int N = 2;\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// x\n')
    assert build.library_path("k") not in (first, second)


def test_plain_kernels_refuse_other_devices():
    """The wrappers dispatch by device: plain on the CPU, the kernel on
    CUDA, an error for anything else — never a silent fallback."""
    x = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        ops.centered_int8_matmul(x, torch.zeros((8, 4), dtype=torch.int8,
                                                device="meta"),
                                 torch.zeros(4, dtype=torch.int32,
                                             device="meta"))
    with pytest.raises(ValueError):
        fs.launch(torch.zeros((2, 8), dtype=torch.int32), None, (0,), (255,),
                  None, ((1,),), None)


# ---------------------------------------------------------------- K2 plan
K2_SHAPES = SITE_SHAPES + [(1000, 1000), (1008, 1008), (2816, 1000)]


@pytest.mark.parametrize("n_j", [1, 3, 8])
@pytest.mark.parametrize("B", [1, 3, 4, 9, 16, 17, 64, 65])
@pytest.mark.parametrize("RC", K2_SHAPES)
def test_k2_tile_plan_within_limits(RC, B, n_j):
    """K2's launch plan fits the card: shared memory, a portable cluster
    that divides the grid, the grid limits; its batch tile holds B (or 4
    rows); every (segment, plane) pair is owned by exactly one rank and no
    rank is empty."""
    R, C = RC
    p = fs.tile_plan(B, R, C, n_j)
    n_seg = -(-R // 512)
    n_pairs = n_seg * n_j
    assert p.smem_bytes <= SMEM_LIMIT
    assert 1 <= p.cluster <= 8 and p.grid[0] % p.cluster == 0
    assert p.grid[0] < 2**31 and p.grid[1] <= 65535
    assert p.bt in (1, 2, 4) and p.bt >= min(B, 4)
    assert p.bt < 2 * min(B, 4) or p.bt == 1
    assert p.grid == (-(-B // p.bt) * p.cluster, -(-C // p.bn))
    owners = [pr // p.pairs_per_rank for pr in range(n_pairs)]
    assert sorted(set(owners)) == list(range(p.cluster))  # none empty
    assert (p.bn, p.bk, p.stages) == (bp.BN, bp.BK, bp.STAGES)
    assert p.smem_bytes == bp.smem_bytes(p.bt, p.cluster)


# ---------------------------------------------------------------- K2 walk
LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3


def byte_perm(a, b, sel):
    """__byte_perm on uint32 arrays (selectors 0..7 per result byte)."""
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    src = [(a >> (8 * k)) & 255 for k in range(4)] + \
          [(b >> (8 * k)) & 255 for k in range(4)]
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for k in range(4):
        out |= src[(sel >> (4 * k)) & 7] << (8 * k)
    return out


def byte_of(word, k):
    """Byte k of each uint32 word as a signed int8 value."""
    v = ((np.asarray(word, np.int64) >> (8 * k)) & 255)
    return np.where(v > 127, v - 256, v)


def k2_stage_planes(wt):
    """A (128 x 64) int8 plane tile as the kernel's swizzled stage bytes."""
    st = np.zeros(128 * 64, np.uint8)
    for r in range(128):
        for c in range(4):
            o = r * 64 + ((c ^ ((r >> 2) & 3)) << 4)
            st[o:o + 16] = wt[r, 16 * c:16 * c + 16].astype(np.uint8)
    return st


def k2_a_fragments(st):
    """Each lane's A registers, a[kk, i, reg, lane], built as the kernel
    builds them: 4 word loads from the swizzled stage, then __byte_perm."""
    words = st.view("<u4").astype(np.uint64)
    kk = np.arange(4)[:, None, None]
    reg = np.arange(4)[None, :, None]
    h, kh = reg & 1, reg >> 1
    r0 = kk * 32 + 16 * kh + 4 * T
    off = (((2 * h + (G >> 2)) ^ T) << 4) + 4 * (G & 3)
    r = [words[((r0 + q) * 64 + off) // 4] for q in range(4)]
    t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[0], r[1], 0x7362)
    t2, t3 = byte_perm(r[2], r[3], 0x5140), byte_perm(r[2], r[3], 0x7362)
    return np.stack([byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
                     byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)],
                    axis=1)  # (kk, i, reg, lane)


def mma_a_matrix(a):
    """PTX m16n8k32 .s8 A fragment layout: register reg of lane (g, t)
    holds A[g + 8*(reg%2), 4t + 16*(reg//2) + byte]."""
    A = np.zeros(a.shape[:-2] + (16, 32), np.int64)
    for reg in range(4):
        row = G + 8 * (reg & 1)
        for k in range(4):
            A[..., row, 4 * T + 16 * (reg >> 1) + k] = byte_of(
                a[..., reg, :], k)
    return A


def mma_b_matrix(b0, b1):
    """PTX m16n8k32 .s8 B fragment layout: register q of lane (g, t) holds
    B[4t + 16q + byte, g]."""
    Bm = np.zeros(b0.shape[:-1] + (32, 8), np.int64)
    for q, reg in enumerate((b0, b1)):
        for k in range(4):
            Bm[..., 4 * T + 16 * q + k, G] = byte_of(reg, k)
    return Bm


def k2_tables(spec_li, spec_mask, rmults):
    """The launcher's per-bit tables: speculative weight sw[i, p] and
    recovery multiplier rmb[i, p] of input bit p."""
    n_i, max_w = len(spec_li), len(rmults[0])
    sw = np.zeros((n_i, 8), np.int64)
    rmb = np.zeros((n_i, 8), np.int64)
    for i, (li, mask) in enumerate(zip(spec_li, spec_mask)):
        for p in range(8):
            q = p - li
            if q >= 0 and (mask >> q) & 1:
                sw[i, p] = 1 << q
            if 0 <= q < max_w:
                rmb[i, p] = rmults[i][q]
    return sw, rmb


def bitplane_walk(x, planes, mults, centers, plan, epilogue, n_counts):
    """numpy walk of the bit-plane GEMM that K1 and K2 share
    (``csrc/bitplane_gemm.cuh``): per (column tile, batch tile) and
    cluster rank, its (segment, plane) pairs in 128-row stages zero-filled
    past the operands; warp w's k32 step of each stage with its A fragments
    from the swizzled stage and its B fragments one bit plane per n8
    column, as m16n8k32 products by the PTX fragment layouts; at a pair's
    end every warp's C fragments added into the slab by the kernel's index
    formula and read back per thread element; the kernel's ``epilogue``
    (d (elements, 8), ok (elements,), plane j, counts) -> contributions
    mod 2^32, adding its counters (masked to (B, C)) into ``counts``; the
    center term in uint32; contributions pushed to the owning rank's inbox
    and summed there. Returns (psum int32, counts)."""
    B, R = x.shape
    n_j, Rp, C = planes.shape
    n_seg = Rp // 512
    bt, cs, ppr = plan.bt, plan.cluster, plan.pairs_per_rank
    tile, S = bt * 64, bp.SLAB_STRIDE
    n_el = -(-tile // 128)
    M = 2**32
    out = np.full((B, C), -1, np.int64)
    counts = np.zeros(n_counts, np.int64)
    xp = np.zeros((-(-B // bt) * bt, Rp), np.int64)
    xp[:B, :R] = x
    for ct in range(plan.grid[1]):
        col0 = ct * 64
        wcols = np.zeros((n_j, Rp, 64), np.int64)
        wcols[:, :, :max(0, min(64, C - col0))] = planes[:, :, col0:col0 + 64]
        for bti in range(plan.grid[0] // cs):
            b0 = bti * bt
            per = -(-tile // cs)
            inbox = np.zeros((cs, cs * per), np.int64)
            for rank in range(cs):
                contrib = np.zeros((n_el, 128), np.int64)  # (k, thread)
                for pr in range(rank * ppr, min(n_seg * n_j, rank * ppr + ppr)):
                    s, j = divmod(pr, n_j)
                    D = np.zeros((4, 4, bt, 16, 8), np.int64)  # (w, i, n, m, p)
                    xs_acc = np.zeros((4, bt, 32), np.int64)   # (w, n, lane)
                    for sub in range(4):
                        k0 = s * 512 + sub * 128
                        # warp w runs k32 step w of the stage
                        A = mma_a_matrix(k2_a_fragments(k2_stage_planes(
                            wcols[j, k0:k0 + 128])))       # (w, i, 16, 32)
                        xt = xp[b0:b0 + bt, k0:k0 + 128]
                        rows = np.arange(4)[:, None] * 32 + 4 * T  # (w, lane)
                        v0 = np.stack([xt[:, rows + q] for q in range(4)])
                        v1 = np.stack([xt[:, rows + 16 + q]
                                       for q in range(4)])  # (q, n, w, lane)
                        xs_acc += (v0.sum(0) + v1.sum(0)).transpose(1, 0, 2)

                        def bits(v):
                            packed = sum((v[q] & 255) << (8 * q)
                                         for q in range(4))
                            return (packed >> G) & 0x01010101
                        Bm = mma_b_matrix(bits(v0), bits(v1))  # (n, w, 32, 8)
                        D += np.einsum("wimc,nwcp->winmp", A, Bm)
                    # C register r of lane (g, t): D[g + 8*(r//2), 2t + r%2]
                    frag = np.stack([D[..., G + 8 * (r >> 1), 2 * T + (r & 1)]
                                     for r in range(4)], axis=-2)
                    slab = np.zeros(bt * 8 * S, np.int64)
                    for w in range(4):
                        for n in range(bt):
                            for i in range(4):
                                e0 = (n * 8 + 2 * T) * S + 4 * G + i
                                np.add.at(slab, e0, frag[w, i, n, 0])
                                np.add.at(slab, e0 + S, frag[w, i, n, 1])
                                np.add.at(slab, e0 + 32, frag[w, i, n, 2])
                                np.add.at(slab, e0 + S + 32, frag[w, i, n, 3])
                    v = xs_acc
                    v = v + v[..., LANES ^ 1]
                    v = v + v[..., LANES ^ 2]
                    xsum = v[..., 0].sum(0) % M  # lane 0 of each warp adds
                    for k in range(n_el):
                        e = np.arange(128) + 128 * k
                        e = e[e < tile]
                        b, c = e // 64, e % 64
                        d = np.stack([slab[(b * 8 + p) * S + c]
                                      for p in range(8)], -1)  # (thread, 8)
                        col = col0 + c
                        ok = (b0 + b < B) & (col < C)
                        contrib[k, :len(e)] += epilogue(d, ok, j, counts)
                        if j == 0:
                            cen = np.where(col < C, centers[s, np.minimum(
                                col, C - 1)], 0)
                            contrib[k, :len(e)] += xsum[b] * cen % M
                        contrib[k] %= M
                e = np.arange(128)[None, :] + 128 * np.arange(n_el)[:, None]
                keep = e < tile
                if cs == 1:
                    inbox[0, e[keep]] = contrib[keep]
                else:
                    inbox[e[keep] // per, rank * per + e[keep] % per] = \
                        contrib[keep]
            for owner in range(cs):
                for jj in range(per):
                    e = owner * per + jj
                    if e >= tile:
                        break
                    row, col = b0 + e // 64, col0 + e % 64
                    if row < B and col < C:
                        out[row, col] = inbox[owner, jj::per].sum() % M
    assert (out >= 0).all()  # every element written once
    return ((out + 2**31) % M - 2**31).astype(np.int32), counts


def k2_walk(x, planes, spec_li, spec_mask, mults, rmults, centers, lo, hi,
            plan):
    """``bitplane_walk`` with K2's epilogue: speculation, clamp, recovery
    and select in uint32; failures per spec slice and recovery
    saturations. Returns (psum, failures, recovery saturations)."""
    n_i = len(spec_li)
    sw, rmb = k2_tables(spec_li, spec_mask, rmults)
    M = 2**32

    def epilogue(d, ok, j, counts):
        out = np.zeros(len(d), np.int64)
        rcs = np.clip(d, lo, hi)
        rsat = (rcs == lo) | (rcs == hi)
        for i in range(n_i):
            cs_ = np.clip((d * sw[i]).sum(-1), lo, hi)
            sat = (cs_ == lo) | (cs_ == hi)
            counts[i] += (ok & sat).sum()
            rec = (rcs * rmb[i]).sum(-1)
            counts[n_i] += (ok[:, None] & sat[:, None] & rsat
                            & (rmb[i] > 0)).sum()
            val = np.where(sat, rec, cs_) % M
            out += val * int(mults[i, j]) % M
        return out
    psum, counts = bitplane_walk(x, planes, mults, centers, plan, epilogue,
                                 n_i + 1)
    return psum, counts[:n_i], int(counts[n_i])


def k1_walk(x, planes, in_li, in_mask, mults, centers, lo, hi, plan):
    """``bitplane_walk`` with K1's epilogue: per input slice the shifted
    sum of its bit-plane sums, the clamp, the saturation count and the
    multiply by mults in uint32. Returns (psum, saturations)."""
    sw, _ = k2_tables(in_li, in_mask, [[0]] * len(in_li))
    M = 2**32

    def epilogue(d, ok, j, counts):
        out = np.zeros(len(d), np.int64)
        for i in range(len(in_li)):
            cs_ = np.clip((d * sw[i]).sum(-1), lo, hi)
            counts[0] += (ok & ((cs_ == lo) | (cs_ == hi))).sum()
            out += cs_ % M * int(mults[i, j]) % M
        return out
    psum, counts = bitplane_walk(x, planes, mults, centers, plan, epilogue, 1)
    return psum, int(counts[0])


# (B, R, C, n_j, spec slicing, padded plane, wrapping centers): clusters of
# 5, 6, 2, 8, 3, 7 and 4 ranks; ragged last segments (1100, 520, 300,
# 1500, 700 rows), ragged column tiles, batch tiles of 1, 2 and 4 rows,
# five batch tiles at B = 17
K2_WALKS = [(3, 1100, 100, 3, (4, 2, 2), False, False),
            (9, 1000, 72, 3, (4, 2, 2), True, True),
            (17, 520, 64, 1, (8,), False, False),
            (4, 1024, 128, 8, (4, 2, 2), True, True),
            (6, 300, 40, 3, (2, 2, 2, 2), False, True),
            (1, 1500, 70, 7, (4, 2, 2), True, False),
            (2, 700, 90, 2, (4, 2, 2), False, True)]


@pytest.mark.parametrize("bits", [7, 24])
@pytest.mark.parametrize("case", K2_WALKS)
def test_k2_tile_walk_matches_plain(case, bits):
    """The K2 kernel's plan, fragments, epilogue and cluster reduction,
    walked in numpy, equal ``ref.fused_spec_crossbar`` exactly: psum,
    failures per spec slice and recovery saturations."""
    from repro_torch.kernels import ref
    B, R, C, n_j, slicing, padded, wrap = case
    rng = np.random.default_rng(B * R + C + n_j)
    n_seg = -(-R // 512)
    planes = np.concatenate([rng.integers(-m, m + 1, (1, n_seg * 512, C))
                             for m in (15, 3, 3, 1, 7, 3, 1, 15)[:n_j]])
    planes[:, R:] = 0  # zero padding rows
    planes = planes.astype(np.int8)
    shifts = np.array([4, 2, 0, 6, 1, 3, 5, 7][:n_j], np.int32)
    valid = None
    if padded:  # the last plane pads a ragged plan: zeroed, mults 0
        valid = torch.ones(n_j, dtype=torch.bool)
        valid[-1] = False
    x = rng.integers(0, 256, (B, R)).astype(np.int32)
    centers = rng.integers(1, 256, (n_seg, C)).astype(np.int32)
    if wrap:
        centers = rng.integers(-2**31, 2**31, (n_seg, C)).astype(np.int32)
    w_flat, li, mask, mults, rmults = ops.spec_tables(
        torch.from_numpy(planes.reshape(n_j, n_seg, 512, C)),
        torch.from_numpy(shifts), slicing, valid)
    adc = adc_lib.ADCConfig(bits=bits)
    want = ref.fused_spec_crossbar(
        torch.from_numpy(x), w_flat, li, mask, mults, rmults,
        torch.from_numpy(centers), adc_lo=adc.lo, adc_hi=adc.hi)
    plan = fs.tile_plan(B, R, C, n_j)
    got = k2_walk(x, w_flat.numpy(), li, mask, mults.numpy(), rmults,
                  centers, adc.lo, adc.hi, plan)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert got[2] == int(want[2])
    if bits == 7:
        assert got[1].sum() > 0 and got[2] > 0
    if wrap:
        full = (x.astype(np.int64).reshape(B, -1).sum(1).max()
                * np.abs(centers.astype(np.int64)).max())
        assert full > 2**31  # the center term wraps


# ---------------------------------------------------------------- K1
# (B, R, C, n_j, input slicing, padded plane, wrapping centers): Algorithm
# 1's 1b slices at its B = 16 with 8 planes (a padded one), the pinned
# (4,2,2) and the widest (8,) slicing; clusters of 6, 8, 5 and 4 ranks,
# batch tiles of 4, 2 and 1 rows, ragged segments and column tiles
K1_WALKS = [(3, 1100, 100, 3, (1,) * 8, False, False),
            (16, 520, 64, 8, (1,) * 8, True, True),
            (2, 1024, 72, 3, (4, 2, 2), False, True),
            (1, 700, 90, 4, (8,), True, False)]


@pytest.mark.parametrize("bits", [7, 24])
@pytest.mark.parametrize("case", K1_WALKS)
def test_k1_tile_walk_matches_plain(case, bits):
    """The K1 kernel: K2's plan, fragments and cluster reduction (the same
    walk) with K1's epilogue, equal ``ref.fused_crossbar`` exactly: psum
    and the saturation count; a padded plane adds nothing."""
    from repro_torch.kernels import fused_crossbar as fx
    from repro_torch.kernels import ref
    B, R, C, n_j, slicing, padded, wrap = case
    rng = np.random.default_rng(B * R + C + n_j + 1)
    n_seg = -(-R // 512)
    planes = np.concatenate([rng.integers(-m, m + 1, (1, n_seg * 512, C))
                             for m in (15, 3, 3, 1, 7, 3, 1, 15)[:n_j]])
    planes[:, R:] = 0  # zero padding rows
    planes = planes.astype(np.int8)
    shifts = np.array([4, 2, 0, 6, 1, 3, 5, 7][:n_j], np.int32)
    valid = None
    if padded:  # the last plane pads a ragged plan: zeroed, mults 0
        valid = torch.ones(n_j, dtype=torch.bool)
        valid[-1] = False
    x = rng.integers(0, 256, (B, R)).astype(np.int32)
    lo_hi = (-2**31, 2**31) if wrap else (1, 256)
    centers = rng.integers(*lo_hi, (n_seg, C)).astype(np.int32)
    w_flat, li, mask, mults = ops.crossbar_tables(
        torch.from_numpy(planes.reshape(n_j, n_seg, 512, C)),
        torch.from_numpy(shifts), slicing, valid)
    adc = adc_lib.ADCConfig(bits=bits)
    want = ref.fused_crossbar(torch.from_numpy(x), w_flat, li, mask, mults,
                              torch.from_numpy(centers), adc_lo=adc.lo,
                              adc_hi=adc.hi)
    plan = fx.tile_plan(B, R, C, n_j)
    got = k1_walk(x, w_flat.numpy(), li, mask, mults.numpy(), centers,
                  adc.lo, adc.hi, plan)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    assert got[1] == int(want[1])
    if bits == 7:
        assert got[1] > 0
    if padded:  # the padded plane's psum share is zero
        assert not w_flat[-1].any() and not mults[:, -1].any()


@pytest.mark.parametrize("B", [1, 3, 4, 16, 17, 64, 65])
@pytest.mark.parametrize("RC", SITE_SHAPES + [(1000, 1008)])
def test_k1_tile_plan_within_limits(RC, B):
    """K1's launch plan fits the card at 1, 3 and 8 planes: shared memory
    within 227 KB, a portable cluster of 1..8 ranks that divides the grid
    with every (segment, plane) pair owned by one rank and none empty, the
    grid limits; its batch tile holds B (or 4 rows); the C launcher's
    constants."""
    from repro_torch.kernels import fused_crossbar as fx
    R, C = RC
    for n_j in (1, 3, 8):
        p = fx.tile_plan(B, R, C, n_j)
        n_pairs = -(-R // 512) * n_j
        assert p.smem_bytes <= SMEM_LIMIT
        assert 1 <= p.cluster <= 8 and p.grid[0] % p.cluster == 0
        assert p.grid[0] < 2**31 and p.grid[1] <= 65535
        assert p.bt in (1, 2, 4) and p.bt >= min(B, 4)
        assert p.grid == (-(-B // p.bt) * p.cluster, -(-C // p.bn))
        owners = [pr // p.pairs_per_rank for pr in range(n_pairs)]
        assert sorted(set(owners)) == list(range(p.cluster))  # none empty
        assert (p.bn, p.bk, p.stages) == (bp.BN, bp.BK, bp.STAGES)
        assert p.smem_bytes == bp.smem_bytes(p.bt, p.cluster)
