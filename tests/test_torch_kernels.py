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


@pytest.mark.parametrize("shape", [(1, 64, 48), (5, 300, 130), (8, 1100, 96)])
def test_k3_plain_matches_pallas_interpret(shape):
    B, K, N = shape
    rng = np.random.default_rng(B * K + N)
    x = rng.integers(-128, 128, (B, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    c = rng.integers(-300, 300, (N,)).astype(np.int32)
    ref = ref_ops.centered_int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(c), backend="interpret")
    got = ops.centered_int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


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
