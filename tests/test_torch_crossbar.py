"""The port's static-slicing crossbar (K1, K4) against the reference.

Every quantity here is an integer, so everything is held bit for bit on
the same numpy-seeded inputs:

- K1's plain version (``ops.fused_crossbar_forward`` on CPU tensors)
  against the reference's Pallas kernel in interpret mode and its XLA
  oracle, over input slicings, weight slicings, ragged rows, batch sizes,
  the paper's 7b and the lossless 24b ADC, and ragged ``valid`` masks:
  psum and saturation count;
- K4's plain version against the reference's Pallas kernel;
- ``core.crossbar.forward`` (fused op and Python loop) against the
  reference's loop: psum and every ``CrossbarStats`` field;
- ``pim_linear.forward_exact`` with speculation off against the reference,
  and equal to the int8 reference at the 24b ADC.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as ref_adc
from repro.core import backends as ref_bk
from repro.core import center_offset as ref_co
from repro.core import crossbar as ref_xbar
from repro.core import pim_linear as ref_pl
from repro.kernels import ops as ref_ops
from repro.kernels import sliced_crossbar as ref_sx
from repro_torch.core import adc as adc_lib
from repro_torch.core import backends as bk
from repro_torch.core import center_offset as co
from repro_torch.core import crossbar as xbar
from repro_torch.core import pim_linear as pl
from repro_torch.kernels import fused_crossbar as fx
from repro_torch.kernels import ops
from repro_torch.models import layers as L

STAT_FIELDS = ("adc_converts", "saturations", "conversions_possible", "macs")
INPUT_SLICINGS = [(1,) * 8, (4, 2, 2), (3, 3, 2), (8,)]
WEIGHT_SLICINGS = [(4, 2, 2), (4, 4), (1,) * 8]
CASES = [(si, sw, (300, 700, 1500)[n % 3], (1, 5)[n % 2])
         for n, (si, sw) in enumerate((si, sw) for si in INPUT_SLICINGS
                                      for sw in WEIGHT_SLICINGS)]


def _layer(rows: int, cols: int, B: int, slicing, seed: int):
    rng = np.random.default_rng(seed)
    w_u = rng.integers(0, 256, (rows, cols)).astype(np.int64)
    x = rng.integers(0, 256, (B, rows)).astype(np.int32)
    return x, ref_co.encode(w_u, slicing)


def _k1_both(x, planes, shifts, centers, input_slicing, bits, valid=None):
    """(port plain result, reference interpret result, reference XLA
    result) of the fused static-slicing op."""
    adc = ref_adc.ADCConfig(bits=bits, signed=True)
    kw = dict(input_slicing=input_slicing, adc_lo=adc.lo, adc_hi=adc.hi)
    refs = [ref_ops.fused_crossbar_forward(
        jnp.asarray(x), jnp.asarray(planes), jnp.asarray(shifts),
        jnp.asarray(centers),
        valid=None if valid is None else jnp.asarray(valid),
        backend=be, **kw) for be in ("interpret", "xla")]
    got = ops.fused_crossbar_forward(
        torch.from_numpy(x), torch.from_numpy(planes),
        torch.from_numpy(np.asarray(shifts, np.int32)),
        torch.from_numpy(centers),
        valid=None if valid is None else torch.from_numpy(valid), **kw)
    return got, refs


@pytest.mark.parametrize("bits", [7, 24])
@pytest.mark.parametrize("input_slicing,weight_slicing,rows,B", CASES)
def test_k1_plain_matches_pallas_interpret(input_slicing, weight_slicing,
                                           rows, B, bits):
    x, enc = _layer(rows, 24, B, weight_slicing, seed=rows + B)
    got, refs = _k1_both(x, np.asarray(enc.planes),
                         np.asarray(enc.shifts, np.int32),
                         np.asarray(enc.centers), input_slicing, bits)
    for ref in refs:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        assert int(got[1]) == int(ref[1])
    if bits == 7 and input_slicing != (1,) * 8:
        assert int(got[1]) > 0  # the 7b ADC saturates wide input slices


@pytest.mark.parametrize("bits", [7, 24])
def test_k1_ragged_valid_mask_matches_pallas_interpret(bits):
    """A compiled per-site plan's padding: a nonzero plane past the
    instance's slice count, masked off by ``valid``."""
    x, enc = _layer(1100, 40, 3, (4, 4), seed=9)
    planes = np.concatenate([np.asarray(enc.planes),
                             np.full_like(np.asarray(enc.planes[:1]), 5)])
    shifts = np.array([4, 0, 3], np.int32)
    valid = np.array([True, True, False])
    got, refs = _k1_both(x, planes, shifts, np.asarray(enc.centers),
                         (4, 2, 2), bits, valid)
    for ref in refs:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        assert int(got[1]) == int(ref[1])


def test_k1_tables_reject_bits_past_eight():
    with pytest.raises(ValueError):
        fx.check_tables((5,), (15,))
    with pytest.raises(ValueError):
        fx.check_tables((0,) * 9, (1,) * 9)
    fx.check_tables((7, 6, 0), (1, 1, 63))


@pytest.mark.parametrize("n_i,n_j,B,R,C", [
    (1, 1, 4, 512, 64), (3, 3, 8, 512, 128), (8, 2, 2, 1024, 32),
    (2, 4, 16, 300, 200), (3, 3, 1, 1500, 7),
])
def test_k4_plain_matches_pallas_interpret(n_i, n_j, B, R, C):
    rng = np.random.default_rng(n_i + 10 * n_j + B + R + C)
    xs = rng.integers(0, 16, (n_i, B, R)).astype(np.int8)
    wp = rng.integers(-15, 16, (n_j, R, C)).astype(np.int8)
    m = rng.choice([1, 2, 4, 16, 64], size=(n_i, n_j)).astype(np.int32)
    want = ref_sx.sliced_crossbar_matmul(jnp.asarray(xs), jnp.asarray(wp),
                                         jnp.asarray(m), interpret=True)
    got = ops.sliced_crossbar_matmul(torch.from_numpy(xs),
                                     torch.from_numpy(wp),
                                     torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k4_clamps_per_segment():
    """Saturating inputs clamp per 512-row segment, not on the total."""
    xs = torch.full((1, 2, 1024), 15, dtype=torch.int8)
    wp = torch.full((1, 1024, 8), 15, dtype=torch.int8)
    got = ops.sliced_crossbar_matmul(xs, wp, torch.tensor([[4]]))
    np.testing.assert_array_equal(got.numpy(), np.full((2, 8), 126 * 4))


@pytest.fixture(scope="module")
def layer():
    x, enc_ref = _layer(1100, 40, 6, (4, 2, 2), seed=11)
    enc = co.encode(torch.from_numpy(
        np.random.default_rng(11).integers(0, 256, (1100, 40))), (4, 2, 2))
    np.testing.assert_array_equal(enc.planes.numpy(), enc_ref.planes)
    return x, enc_ref, enc


@pytest.mark.parametrize("input_slicing", [(1,) * 8, (4, 2, 2)])
@pytest.mark.parametrize("bits", [7, 24])
@pytest.mark.parametrize("backend", [None, "python"])
def test_crossbar_forward_matches_reference(layer, input_slicing, bits,
                                            backend):
    """core.crossbar.forward, fused op and loop, against the reference's
    Python loop: psum and every CrossbarStats field."""
    x, enc_ref, enc = layer
    ref_psum, ref_st = ref_xbar.forward(
        jnp.asarray(x), enc_ref, input_slicing, ref_adc.ADCConfig(bits=bits),
        backend="python")
    psum, st = xbar.forward(torch.from_numpy(x), enc, input_slicing,
                            adc_lib.ADCConfig(bits=bits), backend=backend)
    np.testing.assert_array_equal(psum.numpy(), np.asarray(ref_psum))
    for f in STAT_FIELDS:
        assert int(getattr(st, f)) == int(getattr(ref_st, f)), f
    assert st.saturations.dtype == torch.int64
    if bits == 7:
        assert int(st.saturations) > 0


def test_crossbar_forward_ideal_matches_reference(layer):
    """``ideal=True`` skips the ADC: the full column sums, unclamped."""
    x, enc_ref, enc = layer
    ref_psum, ref_st = ref_xbar.forward(jnp.asarray(x), enc_ref, (8,),
                                        ideal=True)
    psum, st = xbar.forward(torch.from_numpy(x), enc, (8,), ideal=True)
    np.testing.assert_array_equal(psum.numpy(), np.asarray(ref_psum))
    for f in STAT_FIELDS:
        assert int(getattr(st, f)) == int(getattr(ref_st, f)), f


def test_crossbar_helpers_match_reference(layer):
    x, enc_ref, enc = layer
    w_u = np.random.default_rng(11).integers(0, 256, (1100, 40))
    np.testing.assert_array_equal(
        xbar.matmul_reference(torch.from_numpy(x), torch.from_numpy(w_u))
        .numpy(), np.asarray(ref_xbar.matmul_reference(jnp.asarray(x),
                                                       jnp.asarray(w_u))))
    cs, frac = xbar.column_sum_distribution(torch.from_numpy(x), enc,
                                            (4, 2, 2))
    rcs, rfrac = ref_xbar.column_sum_distribution(jnp.asarray(x), enc_ref,
                                                  (4, 2, 2))
    np.testing.assert_array_equal(cs.numpy(), np.asarray(rcs))
    assert float(frac) == pytest.approx(float(rfrac), abs=1e-7)


def test_ideal_backend_reads_match_reference(layer):
    x, enc_ref, enc = layer
    xs = xbar._segment_inputs(torch.from_numpy(x), 3, 512) & 15
    prog = bk.make("ideal").program(enc.planes)
    rprog = ref_bk.IDEAL.program(jnp.asarray(enc_ref.planes))
    for j in range(3):
        for got, want in zip(bk.IDEAL.read(prog, xs, j),
                             ref_bk.IDEAL.read(rprog, jnp.asarray(xs.numpy()),
                                               j)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError):
        bk.make("nonideal")
    with pytest.raises(ValueError):
        bk.make("analog")


@pytest.fixture(scope="module")
def plans():
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((1100, 56)) * 0.05).astype(np.float32)
    x_cal = rng.standard_normal((16, 1100)).astype(np.float32)
    x = rng.standard_normal((7, 1100)).astype(np.float32) * 1.3
    kw = dict(signed_inputs=True, speculation=False)
    ref = ref_pl.prepare(jnp.asarray(w), jnp.asarray(x_cal), **kw)
    port = pl.prepare(torch.from_numpy(w), torch.from_numpy(x_cal), **kw)
    return ref, port, x


@pytest.mark.parametrize("bits", [7, 24])
def test_forward_exact_no_speculation_matches_reference(plans, bits):
    ref, port, x = plans
    ref = dataclasses.replace(ref, adc=ref_adc.ADCConfig(bits=bits))
    port = dataclasses.replace(port, adc=adc_lib.ADCConfig(bits=bits))
    y_ref, st_ref = ref_pl.forward_exact(jnp.asarray(x), ref,
                                         return_stats=True)
    y, st = pl.forward_exact(torch.from_numpy(x), port, return_stats=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))
    assert len(st) == len(st_ref) == 2  # two signed passes
    for s, r in zip(st, st_ref):
        for f in STAT_FIELDS:
            assert int(getattr(s, f)) == int(getattr(r, f)), f
    if bits == 24:  # the pim_mode contract, speculation off
        np.testing.assert_array_equal(
            y.numpy(), pl.forward_int_reference(torch.from_numpy(x),
                                                port).numpy())
    else:
        assert sum(int(s.saturations) for s in st) > 0


def test_output_codes_match_reference(plans):
    ref, port, x = plans
    for relu in (False, True):
        y = pl.forward_int_reference(torch.from_numpy(x), port)
        np.testing.assert_array_equal(
            pl.output_codes(y, port, relu=relu).numpy(),
            np.asarray(ref_pl.output_codes(jnp.asarray(y.numpy()), ref,
                                           relu=relu)))


def test_stats_totals_alias_crossbar_stats():
    """A speculation-off sink holds CrossbarStats: its
    ``conversions_possible`` is the no-speculation baseline, and the
    speculation-only fields count 0."""
    st = xbar.CrossbarStats(adc_converts=96, saturations=torch.tensor(3),
                            conversions_possible=96, macs=40)
    tot = L.pim_stats_totals([st, st])
    assert tot == {"adc_converts": 192, "no_spec_converts": 192,
                   "spec_failures": 0, "spec_attempts": 0,
                   "recovery_saturations": 0, "cycles": 0, "macs": 80}
