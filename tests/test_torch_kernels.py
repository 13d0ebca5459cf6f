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
