"""Device nonidealities and ADC noise in the port against the reference.

``repro_torch.core.backends`` (the ``NonidealSim`` die, its corners and
``make``), ``core.adc``'s noise model and the noisy or nonideal loops of
``crossbar``, ``speculation``, ``pim_linear`` and Algorithm 1 are held to
``repro.core``:

- the registry and the zero corner, with ``==``: an all-zero die is the
  ideal array, the python loop and K1's plain version, bit for bit;
- with the reference's ``jax.random`` draws injected (``JaxKey``): the
  die's fault maps with ``==`` and its conductances and reads to float32
  rounding; the noisy crossbar, speculation, ``forward_exact`` and
  Algorithm 1 with ``==``;
- the statistics of the port's own ``rng.Key`` dies, as
  ``tests/test_nonideal_backend.py`` checks the reference's;
- reduced qwen1.5-0.5b's exact logits on a nominal and on a stuck-at die;
- the launcher's ``--device-corner``.

Each comparison states its tolerance where it is not ``==``.
"""

import ast
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as ref_ad
from repro.core import adc as ref_adc
from repro.core import backends as ref_bk
from repro.core import center_offset as ref_co
from repro.core import crossbar as ref_xbar
from repro.core import pim_linear as ref_pl
from repro.core import speculation as ref_spec
from repro.launch import serve as ref_launch
from repro.models import layers as ref_layers
from repro_torch import configs, obs
from repro_torch.core import adaptive as ad
from repro_torch.core import adc
from repro_torch.core import backends as bk
from repro_torch.core import center_offset as co
from repro_torch.core import crossbar as xbar
from repro_torch.core import pim_linear as pl
from repro_torch.core import rng
from repro_torch.core import slicing as sl
from repro_torch.core import speculation as spec
from repro_torch.launch import serve as launch
from repro_torch.models import layers
from repro_torch.models import pim
from repro_torch.models import transformer as T
from repro_torch.serve import ContinuousServeEngine

import _torch_parity as tp
from _torch_parity import JaxKey, one_thread  # noqa: F401  (autouse fixture)

ARCH = "qwen1.5-0.5b"
LOSSLESS = 24                 # ADC bits at which exact == int8
STUCK = dict(stuck_rate=0.05)  # integer conductances: reads exact
CORNER_NAMES = ("1sigma", "3sigma")


def _eq(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))


def _planes(gen, n_w=3, n_seg=2, R=96, C=6) -> np.ndarray:
    return gen.integers(-127, 128, size=(n_w, n_seg, R, C)).astype(np.int8)


def _encoded(gen, rows=700, cols=24):
    """A Center+Offset layer in both packages and 8b inputs."""
    w_u = np.clip(np.round(gen.normal(0, 20, size=(rows, cols))),
                  -127, 127).astype(np.int64) + 128
    x = gen.integers(0, 256, size=(5, rows))
    return (ref_co.encode(w_u, (4, 2, 2)),
            co.encode(torch.from_numpy(w_u), (4, 2, 2)), x)


def _dies(name_or_corner, seed):
    """The reference's die and the port's on the reference's draws."""
    if isinstance(name_or_corner, str):
        rc, c = ref_bk.corner(name_or_corner), bk.corner(name_or_corner)
    else:
        rc, c = ref_bk.DeviceCorner(**name_or_corner), bk.DeviceCorner(
            **name_or_corner)
    return (ref_bk.NonidealSim(rc, jax.random.key(seed)),
            bk.NonidealSim(c, JaxKey(jax.random.key(seed))))


# ------------------------------------------------------------ registry
def test_corners_and_make_match_reference():
    assert list(bk.CORNERS) == list(ref_bk.CORNERS)
    for name in bk.CORNERS:
        assert dataclasses.asdict(bk.corner(name)) == dataclasses.asdict(
            ref_bk.corner(name))
    assert dataclasses.asdict(bk.DeviceCorner()) == dataclasses.asdict(
        ref_bk.DeviceCorner())
    assert bk.make("ideal") is bk.IDEAL
    die = bk.make("nonideal", "3sigma", seed=5)
    assert isinstance(die, bk.NonidealSim) and die.name == "nonideal"
    assert die.corner == bk.SIGMA3 and die.key == rng.Key(5)
    assert bk.make("nonideal", bk.SIGMA1).corner is bk.SIGMA1
    assert bk.BACKENDS == ref_bk.BACKENDS
    for fn, arg in ((bk.make, "analog-dreams"), (bk.corner, "9sigma")):
        with pytest.raises(ValueError) as got:
            fn(arg)
        with pytest.raises(ValueError) as want:
            getattr(ref_bk, fn.__name__)(arg)
        assert str(got.value) == str(want.value)


def test_archconfig_accepts_every_named_corner():
    cfg = configs.get("yi-6b")
    for name in bk.CORNERS:
        dataclasses.replace(cfg, pim_crossbar_backend="nonideal",
                            pim_device_corner=name)
    with pytest.raises(ValueError, match="pim_device_corner"):
        dataclasses.replace(cfg, pim_device_corner="9sigma")
    with pytest.raises(ValueError, match="pim_crossbar_backend"):
        dataclasses.replace(cfg, pim_crossbar_backend="analog-dreams")


def test_adc_tables_match_reference():
    for cfg, ref in ((adc.RAELLA_ADC, ref_adc.RAELLA_ADC),
                     (adc.ISAAC_ADC, ref_adc.ISAAC_ADC)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert (cfg.lo, cfg.hi, cfg.levels) == (ref.lo, ref.hi, ref.levels)
    cs = np.random.default_rng(0).integers(-70000, 70000, 500).astype(
        np.int32)
    for signed in (True, False):
        _eq(adc.required_bits(torch.from_numpy(cs), signed),
            ref_adc.required_bits(jnp.asarray(cs), signed))


def test_stack_corners_equals_per_corner_programs():
    names = ("nominal", "1sigma", "3sigma")
    stacked = bk.stack_corners([bk.corner(n) for n in names])
    ref = ref_bk.stack_corners([ref_bk.corner(n) for n in names])
    planes = torch.from_numpy(_planes(np.random.default_rng(1)))
    for f in dataclasses.fields(bk.DeviceCorner):
        assert getattr(stacked, f.name).dtype == torch.float32
        _eq(getattr(stacked, f.name), getattr(ref, f.name))
    for i, n in enumerate(names):
        lane = bk.DeviceCorner(**{f.name: getattr(stacked, f.name)[i]
                                  for f in dataclasses.fields(stacked)})
        a = bk.NonidealSim(lane, rng.Key(3)).program(planes, rows=150)
        b = bk.make("nonideal", n, seed=3).program(planes, rows=150)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# --------------------------------------------------- zero-corner contract
def test_zero_corner_program_and_read_are_ideal():
    gen = np.random.default_rng(0)
    planes = torch.from_numpy(_planes(gen, n_w=2, n_seg=1))
    x = torch.from_numpy(gen.integers(0, 256, size=(4, 1, 96)))
    ideal = bk.IDEAL.program(planes, rows=96)
    for key in (rng.Key(0), JaxKey(jax.random.key(0))):
        die = bk.NonidealSim(bk.DeviceCorner(), key)
        zero = die.program(planes, rows=96)
        _eq(zero.gp, ideal.gp.numpy())
        _eq(zero.gn, ideal.gn.numpy())
        assert not zero.stuck_on.any() and not zero.stuck_off.any()
        for j in range(2):
            for got, want in zip(die.read(zero, x, j),
                                 bk.IDEAL.read(ideal, x, j)):
                _eq(got, want.numpy())


@pytest.mark.parametrize("bits", [7, LOSSLESS])
def test_zero_die_forward_is_loop_and_k1(bits):
    """On a zero die the loop equals the ideal loop and K1's plain version
    (the default route on the CPU), psum and saturations; the reference's
    fused path equals both."""
    renc, enc, x = _encoded(np.random.default_rng(1))
    cfg = adc.ADCConfig(bits=bits)
    xt = torch.from_numpy(x)
    k1, st1 = xbar.forward(xt, enc, (4, 4), cfg)
    loop, stl = xbar.forward(xt, enc, (4, 4), cfg, backend="python")
    die, std = xbar.forward(xt, enc, (4, 4), cfg, device=bk.make("nonideal"))
    ref, rst = ref_xbar.forward(jnp.asarray(x), renc, (4, 4),
                                ref_adc.ADCConfig(bits=bits))
    for got in (loop, die):
        _eq(got, k1.numpy())
    _eq(k1, ref)
    assert int(st1.saturations) == int(stl.saturations) == int(
        std.saturations) == int(rst.saturations)
    assert bits == LOSSLESS or int(rst.saturations) > 0


def test_speculation_plan_on_a_zero_die_falls_back_and_stays_exact():
    gen = np.random.default_rng(3)
    w = torch.from_numpy(gen.normal(0, 0.4, size=(96, 6)).astype(np.float32))
    x_cal = torch.from_numpy(gen.normal(0, 1, size=(10, 96)).astype(
        np.float32))
    plan = pl.prepare(w, x_cal, speculation=True,
                      adc=adc.ADCConfig(bits=LOSSLESS))
    x = torch.from_numpy(gen.normal(0, 1, size=(4, 96)).astype(np.float32))
    zero = dataclasses.replace(plan, device=bk.make("nonideal"))
    y, stats = pl.forward_exact(x, zero, return_stats=True)
    _eq(y, pl.forward_int_reference(x, plan).numpy())
    # the static path ran: its stats, not speculation's
    assert all(isinstance(s, xbar.CrossbarStats) for s in stats)


def test_padded_slice_planes_stay_inert_on_a_3sigma_die():
    planes = _planes(np.random.default_rng(4))
    planes[2] = 0  # a slice-padding plane
    prog = bk.make("nonideal", "3sigma", seed=7).program(
        torch.from_numpy(planes), rows=150)
    assert not prog.gp[2].any() and not prog.gn[2].any()
    assert prog.stuck_on[:, 2].any()  # faults were drawn there all the same


# ------------------------------------------- die parity, injected draws
@pytest.mark.parametrize("name", CORNER_NAMES)
def test_die_program_and_read_match_reference(name):
    """Fault maps ``==``; conductances within rtol 1e-6 (the exp/log ulps
    of two libraries), reads within rtol 1e-5 (float32 summation order)."""
    gen = np.random.default_rng(2)
    planes = _planes(gen, n_w=3, n_seg=2, R=96, C=8)
    x = gen.integers(0, 16, size=(4, 2, 96)).astype(np.int32)
    rdie, die = _dies(name, 3)
    rprog = rdie.program(jnp.asarray(planes, jnp.int32), rows=150)
    prog = die.program(torch.from_numpy(planes), rows=150)
    _eq(prog.stuck_on, rprog.stuck_on)
    _eq(prog.stuck_off, rprog.stuck_off)
    assert prog.stuck_on.any() and prog.stuck_off.any()
    for got, want in ((prog.gp, rprog.gp), (prog.gn, rprog.gn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)
    for j in range(3):
        for got, want in zip(die.read(prog, torch.from_numpy(x), j),
                             rdie.read(rprog, jnp.asarray(x), j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=0)


@pytest.mark.parametrize("bits", [7, LOSSLESS])
def test_crossbar_on_a_stuck_at_die_matches_reference(bits):
    """Stuck-at faults alone keep every conductance an integer, so both
    reads are exact: psums and saturations ``==``."""
    renc, enc, x = _encoded(np.random.default_rng(5))
    rdie, die = _dies(STUCK, 11)
    for insl in ((1,) * 8, (4, 2, 2)):
        got, st = xbar.forward(torch.from_numpy(x), enc, insl,
                               adc.ADCConfig(bits=bits), device=die)
        want, rst = ref_xbar.forward(jnp.asarray(x), renc, insl,
                                     ref_adc.ADCConfig(bits=bits),
                                     device=rdie)
        _eq(got, want)
        assert int(st.saturations) == int(rst.saturations)
    ideal, _ = xbar.forward(torch.from_numpy(x), enc, insl,
                            adc.ADCConfig(bits=bits))
    assert not torch.equal(got, ideal)


@pytest.mark.parametrize("name", CORNER_NAMES)
def test_crossbar_on_a_die_matches_reference_to_code_flips(name):
    """At 1 and 3 sigma the read's float32 summation order differs between
    XLA and torch, so a column sum within an ulp of a .5 boundary may round
    to the neighbouring code. The ADC codes must agree on >= 99.9% of
    conversions and differ by at most 1 elsewhere; each flip moves the psum
    by 2^(li+lw), and the psums stay within the sum of those."""
    renc, enc, x = _encoded(np.random.default_rng(6))
    rdie, die = _dies(name, 1)
    cfg, rcfg = adc.ADCConfig(bits=7), ref_adc.ADCConfig(bits=7)
    got, st = xbar.forward(torch.from_numpy(x), enc, (1,) * 8, cfg,
                           device=die)
    want, rst = ref_xbar.forward(jnp.asarray(x), renc, (1,) * 8, rcfg,
                                 device=rdie)
    prog = die.program(enc.planes, rows=enc.rows)
    rprog = rdie.program(jnp.asarray(renc.planes), rows=renc.rows)
    xs = xbar._segment_inputs(torch.from_numpy(x), enc.n_segments,
                              enc.rows_per_xbar)
    bounds = sl.slice_bounds((1,) * 8, sl.INPUT_BITS)
    # the port reads every input slice at once, stacked on the batch axis
    x_all = torch.cat([sl.crop_unsigned(xs, hi, li) for hi, li in bounds])
    bound = np.zeros(got.shape, np.int64)
    n_conv = flips = 0
    for j in range(enc.n_slices):
        pos, neg = die.read(prog, x_all, j)
        codes = adc.convert(pos - neg, cfg)[0].numpy().reshape(
            (len(bounds), len(x)) + tuple(pos.shape[1:]))
        for i, (hi, li) in enumerate(bounds):
            rpos, rneg = rdie.read(rprog, jnp.asarray(
                sl.crop_unsigned(xs, hi, li).numpy()), j)
            rcode = np.asarray(ref_adc.convert(rpos - rneg, rcfg)[0])
            d = np.abs(codes[i].astype(np.int64) - rcode)
            assert d.max() <= 1
            n_conv += d.size
            flips += int(d.sum())
            bound += d.sum(axis=1) << (li + enc.shifts[j])
    assert flips <= 1e-3 * n_conv, (flips, n_conv)
    assert (np.abs(got.numpy().astype(np.int64) - np.asarray(want))
            <= bound).all()
    assert abs(int(st.saturations) - int(rst.saturations)) <= flips


# ------------------------------------------- noise parity, injected draws
@pytest.mark.parametrize("noise", [0.05, 0.12])
def test_noisy_convert_matches_reference(noise):
    gen = np.random.default_rng(7)
    pos = gen.integers(0, 4000, size=(6, 2, 40)).astype(np.int32)
    neg = gen.integers(0, 4000, size=(6, 2, 40)).astype(np.int32)
    key = jax.random.key(2)
    got = adc.convert(torch.from_numpy(pos - neg), adc.ADCConfig(bits=7),
                      noise_level=noise, pos_sum=torch.from_numpy(pos),
                      neg_sum=torch.from_numpy(neg), key=JaxKey(key))
    want = ref_adc.convert(jnp.asarray(pos - neg), ref_adc.ADCConfig(bits=7),
                           noise_level=noise, pos_sum=jnp.asarray(pos),
                           neg_sum=jnp.asarray(neg), key=key)
    for g, w in zip(got, want):
        _eq(g, w)
    with pytest.raises(ValueError, match="pos/neg"):
        adc.convert(torch.from_numpy(pos), noise_level=noise, key=rng.Key(0))
    with pytest.raises(ValueError, match="requires a key"):
        adc.convert(torch.from_numpy(pos), noise_level=noise,
                    pos_sum=torch.from_numpy(pos),
                    neg_sum=torch.from_numpy(neg))


@pytest.mark.parametrize("noise", [0.05, 0.12])
def test_noisy_crossbar_and_speculation_match_reference(noise):
    renc, enc, x = _encoded(np.random.default_rng(8))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for insl in ((1,) * 8, (4, 4)):
        got, st = xbar.forward(xt, enc, insl, noise_level=noise,
                               key=JaxKey(jax.random.key(5)))
        want, rst = ref_xbar.forward(xj, renc, insl, noise_level=noise,
                                     key=jax.random.key(5))
        _eq(got, want)
        assert int(st.saturations) == int(rst.saturations)
        assert st.adc_converts == rst.adc_converts
    got, st = spec.forward(xt, enc, noise_level=noise,
                           key=JaxKey(jax.random.key(6)))
    want, rst = ref_spec.forward(xj, renc, noise_level=noise,
                                 key=jax.random.key(6))
    _eq(got, want)
    for f in ("adc_converts", "spec_failures", "recovery_saturations",
              "spec_attempts", "no_spec_converts", "cycles", "macs"):
        assert int(getattr(st, f)) == int(getattr(rst, f)), f
    assert int(rst.spec_failures) > 0
    # noise moves the result; a key without noise does not
    clean, _ = spec.forward(xt, enc)
    assert not torch.equal(got, clean)
    _eq(spec.forward(xt, enc, key=rng.Key(0))[0], clean.numpy())
    with pytest.raises(ValueError, match="requires a key"):
        spec.forward(xt, enc, noise_level=noise)


@pytest.fixture(scope="module")
def layer_plans():
    """One layer's plans in both packages, prepared on signed and on
    unsigned calibration inputs, and test inputs of each sign."""
    gen = np.random.default_rng(9)
    w = (gen.standard_normal((600, 24)) * 0.05).astype(np.float32)
    x_cal = gen.standard_normal((12, 600)).astype(np.float32)
    x = (gen.standard_normal((5, 600)) * 1.2).astype(np.float32)
    out = {}
    for signed in (True, False):
        xc = x_cal if signed else np.abs(x_cal)
        out[signed] = (
            ref_pl.prepare(jnp.asarray(w), jnp.asarray(xc),
                           signed_inputs=signed),
            pl.prepare(torch.from_numpy(w), torch.from_numpy(xc),
                       signed_inputs=signed),
            x if signed else np.abs(x))
    return out


@pytest.mark.parametrize("noise", [0.05, 0.12])
@pytest.mark.parametrize("signed", [True, False])
def test_noisy_forward_exact_matches_reference(layer_plans, signed, noise):
    """Both passes of a signed layer (``fold_in(i)``), speculation on and
    off, at the paper's 7b ADC: outputs and every stat ``==``."""
    ref, port, x = layer_plans[signed]
    for spec_on in (True, False):
        r = dataclasses.replace(ref, speculation=spec_on)
        p = dataclasses.replace(port, speculation=spec_on)
        want, rst = ref_pl.forward_exact(jnp.asarray(x), r,
                                         noise_level=noise,
                                         key=jax.random.key(4),
                                         return_stats=True)
        got, st = pl.forward_exact(torch.from_numpy(x), p, noise_level=noise,
                                   key=JaxKey(jax.random.key(4)),
                                   return_stats=True)
        _eq(got, want)
        assert len(st) == len(rst) == (2 if signed else 1)
        for s, rs in zip(st, rst):
            assert type(s).__name__ == type(rs).__name__
            for f in ("adc_converts", "saturations", "spec_failures",
                      "recovery_saturations", "conversions_possible"):
                if hasattr(rs, f):
                    assert int(getattr(s, f)) == int(getattr(rs, f)), f


def test_forward_exact_on_a_die_with_noise_matches_reference(layer_plans):
    """A stuck-at die and ADC noise together: the die forces the static
    path even on a speculation plan; outputs and stats ``==``."""
    ref, port, x = layer_plans[True]
    rdie, die = _dies(STUCK, 2)
    r = dataclasses.replace(ref, device=rdie)
    p = dataclasses.replace(port, device=die)
    want, rst = ref_pl.forward_exact(jnp.asarray(x), r, noise_level=0.08,
                                     key=jax.random.key(1),
                                     return_stats=True)
    got, st = pl.forward_exact(torch.from_numpy(x), p, noise_level=0.08,
                               key=JaxKey(jax.random.key(1)),
                               return_stats=True)
    _eq(got, want)
    for s, rs in zip(st, rst):
        assert isinstance(s, xbar.CrossbarStats)
        assert int(s.saturations) == int(rs.saturations)


def test_noisy_algorithm1_matches_reference():
    """``find_best_slicing`` at noise 0.10 (the reference's
    ``test_noise_pushes_to_more_slices`` layer, at 256 rows): the
    reference's slicing,
    its errors within 1e-6 (the float32 error means of two libraries), and
    no fewer slices than at noise 0."""
    gen = np.random.default_rng(5)
    w = gen.normal(0.0, 0.05, size=(256, 16)).astype(np.float32)
    x = np.maximum(gen.normal(0.2, 0.35, size=(10, 256)), 0).astype(
        np.float32)
    want = ref_ad.find_best_slicing(jnp.asarray(w), jnp.asarray(x),
                                    noise_level=0.10, key=jax.random.key(0))
    got = ad.find_best_slicing(torch.from_numpy(w), torch.from_numpy(x),
                               noise_level=0.10,
                               key=JaxKey(jax.random.key(0)))
    assert got.slicing == want.slicing
    assert set(got.all_errors) == set(want.all_errors)
    for s, e in want.all_errors.items():
        assert got.all_errors[s] == pytest.approx(e, abs=1e-6)
    clean = ad.find_best_slicing(torch.from_numpy(w), torch.from_numpy(x))
    assert got.n_slices >= clean.n_slices
    with pytest.raises(ValueError, match="requires a key"):
        ad.measure_error(torch.from_numpy(w), torch.from_numpy(x), (4, 2, 2),
                         noise_level=0.1)


# ------------------------------------ statistics of the port's own Key
@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 1])
def test_same_die_programs_identically(seed):
    planes = torch.from_numpy(_planes(np.random.default_rng(123), R=64, C=4))
    die = bk.make("nonideal", "3sigma", seed=seed)
    a, b = die.program(planes, rows=100), die.program(planes, rows=100)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = bk.make("nonideal", "3sigma", seed=seed + 1).program(planes,
                                                             rows=100)
    assert (a.gp - c.gp).abs().max() > 0


def _read_error(corner_, planes, x, key):
    """Mean |column-sum error| of a die at ``corner_`` vs the ideal read."""
    die = bk.NonidealSim(corner_, key)
    prog = die.program(planes, rows=planes.shape[1] * planes.shape[2])
    iprog = bk.IDEAL.program(planes)
    err = 0.0
    for j in range(planes.shape[0]):
        pos, neg = die.read(prog, x, j)
        ipos, ineg = bk.IDEAL.read(iprog, x, j)
        err += float(((pos - neg) - (ipos - ineg)).abs().mean())
    return err


KNOBS = {
    "program_sigma": [dict(program_sigma=s) for s in (0.01, 0.1, 0.5)],
    "drift": [dict(drift_nu=n, drift_time=1e5) for n in (0.005, 0.03, 0.1)],
    "stuck_rate": [dict(stuck_rate=r) for r in (0.02, 0.1, 0.4)],
    "ir_drop_alpha": [dict(ir_drop_alpha=a) for a in (0.02, 0.1, 0.3)],
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_error_grows_with_magnitude(knob):
    gen = np.random.default_rng(7)
    planes = torch.from_numpy(_planes(gen, n_w=2, n_seg=1, R=128, C=8))
    x = torch.from_numpy(gen.integers(0, 256, size=(8, 1, 128)))
    key = rng.Key(11)
    errs = [_read_error(bk.DeviceCorner(**kw), planes, x, key)
            for kw in KNOBS[knob]]
    assert _read_error(bk.DeviceCorner(), planes, x, key) == 0.0
    assert 0.0 < errs[0] < errs[1] < errs[2], (knob, errs)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stuck_counts_within_binomial_bounds(seed):
    n_w, R, C, rate = 2, 256, 8, 0.05
    planes = torch.from_numpy(_planes(np.random.default_rng(9), n_w=n_w,
                                      n_seg=1, R=R, C=C))
    prog = bk.NonidealSim(bk.DeviceCorner(stuck_rate=rate),
                          rng.Key(seed)).program(planes, rows=R)
    stuck = int(prog.stuck_on.sum() + prog.stuck_off.sum())
    n = 2 * n_w * R * C  # Bernoulli draws per device (pos + neg arrays)
    mean, sd = n * rate, np.sqrt(n * rate * (1 - rate))
    assert abs(stuck - mean) < 6 * sd, (stuck, mean, sd)


def test_stuck_on_frac_splits_faults():
    planes = torch.from_numpy(_planes(np.random.default_rng(10), n_seg=1,
                                      R=256, C=8))
    for onf, attr in ((1.0, "stuck_off"), (0.0, "stuck_on")):
        prog = bk.NonidealSim(
            bk.DeviceCorner(stuck_rate=0.1, stuck_on_frac=onf),
            rng.Key(2)).program(planes, rows=256)
        assert not getattr(prog, attr).any()
        assert (prog.stuck_on | prog.stuck_off).any()


def test_no_faults_on_padding_rows():
    planes = torch.from_numpy(_planes(np.random.default_rng(11), n_seg=2,
                                      R=128, C=4))  # 256 padded rows
    prog = bk.NonidealSim(bk.DeviceCorner(stuck_rate=0.5),
                          rng.Key(3)).program(planes, rows=200)
    faults = (prog.stuck_on | prog.stuck_off).any(0).any(0).any(-1)
    flat = faults.reshape(-1)
    assert flat[:200].any() and not flat[200:].any()


def test_work_counters_do_not_depend_on_the_device():
    _, enc, x = _encoded(np.random.default_rng(12), rows=96, cols=6)
    xt = torch.from_numpy(x)
    _, st_loop = xbar.forward(xt, enc, (4, 4), backend="python")
    runs = [xbar.forward(xt, enc, (4, 4), device=d)[1]
            for d in (None, bk.make("nonideal"),
                      bk.make("nonideal", "3sigma", seed=1))]
    runs.append(xbar.forward(xt, enc, (4, 4), noise_level=0.1,
                             key=rng.Key(0))[1])
    for st in runs:
        assert st.adc_converts == st_loop.adc_converts
        assert st.conversions_possible == st_loop.conversions_possible
        assert st.macs == st_loop.macs
    assert int(runs[1].saturations) == int(st_loop.saturations)


# ----------------------------------------------------- the slice, whole
def _die_logits(rdev, dev, monkeypatch, **over):
    rcfg, cfg, rparams, _, params, _, tokens = tp.setup(ARCH)
    rplans, plans = tp.compiled(ARCH, "exact")
    over = dict(pim_mode="exact", pim_crossbar_backend="nonideal", **over)
    if rdev is not None:
        monkeypatch.setattr(ref_layers.device_backends, "make",
                            lambda *a, **k: rdev)
        monkeypatch.setattr(layers.device_backends, "make",
                            lambda *a, **k: dev)
    want = tp.run_ref(dataclasses.replace(rcfg, **over), rparams, rplans,
                      tokens)
    got = tp.run_port(dataclasses.replace(cfg, **over), params, plans,
                      tokens)
    return got, want


def test_logits_on_the_nominal_die(monkeypatch):
    """Reduced qwen1.5-0.5b, exact mode, on the named nominal die: the
    logits within ``ATOL['exact']`` of the reference's, and equal to the
    port's ideal run with speculation off."""
    got, want = _die_logits(None, None, monkeypatch,
                            pim_device_corner="nominal")
    tp.assert_logits_close(got, want, "exact")
    _, cfg, _, _, params, _, tokens = tp.setup(ARCH)
    ideal = tp.run_port(dataclasses.replace(cfg, pim_mode="exact",
                                            pim_speculation=False),
                        params, tp.compiled(ARCH, "exact")[1], tokens)
    np.testing.assert_array_equal(got, ideal)


def test_logits_on_a_stuck_at_die(monkeypatch):
    """The same on a stuck-at die of the reference's draws (both
    packages' ``make`` patched to return it), within ``ATOL['exact']``."""
    rdie, die = _dies(STUCK, 0)
    got, want = _die_logits(rdie, die, monkeypatch)
    tp.assert_logits_close(got, want, "exact")
    monkeypatch.undo()
    assert not np.array_equal(got, tp.port_logits(ARCH, "exact"))


# ------------------------------------------------------------ launcher
LAUNCH = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "2",
          "--steps", "4"]


def test_launcher_refuses_a_corner_without_exact(monkeypatch, capsys):
    """The port's and the reference's launcher exit with one message."""
    args = ["--arch", ARCH, "--reduced", "--pim", "fast", "--device-corner",
            "1sigma"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)  # argparse's prog
    with pytest.raises(SystemExit) as got:
        launch.main(args + ["--device", "cpu"])
    err = capsys.readouterr().err
    with pytest.raises(SystemExit) as want:
        ref_launch.main()
    assert got.value.code == want.value.code == 2
    assert err.splitlines()[-1] == capsys.readouterr().err.splitlines()[-1]
    assert "--device-corner requires --pim exact" in err


@pytest.mark.parametrize("corner", ["nominal", "3sigma"])
def test_launcher_serves_on_a_die(corner, tmp_path, capsys):
    """``--device-corner`` on reduced qwen: the tokens of the continuous
    engine on the same die (nominal: on the ideal array with speculation
    off, which the launcher has no flag for), and the die's decode steps
    billed as the static path's (``--metrics-out``)."""
    m = tmp_path / "m.json"
    launch.main(LAUNCH + ["--pim", "exact", "--device-corner", corner,
                          "--device-seed", "3", "--metrics-out", str(m)])
    out = capsys.readouterr().out
    assert (f"device corner: {corner} (die seed 3, nonideal ReRAM array)"
            in out)
    tokens = ast.literal_eval(out.split("first outputs:")[1].strip())
    converts = json.loads(m.read_text())["metrics"][
        "repro_pim_adc_converts_total"]["series"][0]["value"]

    cfg = dataclasses.replace(configs.get(ARCH).reduced(), pim_mode="exact")
    params = T.init_params(cfg, seed=0, device="cpu")
    plans = pim.compile_pim_params(
        params, cfg, launch.calibration_tokens(cfg, 8)).plans
    cfg = dataclasses.replace(cfg, pim_speculation=False) \
        if corner == "nominal" else dataclasses.replace(
            cfg, pim_crossbar_backend="nonideal", pim_device_corner=corner,
            pim_device_seed=3)
    tel = obs.ServeTelemetry(engine="continuous")
    eng = ContinuousServeEngine(cfg, params, n_slots=4, max_len=8 + 4 + 1,
                                prefill_chunk=64, plans=plans, telemetry=tel)
    outs = eng.run(launch.build_trace(2, prompt_len=8, steps=4,
                                      vocab=cfg.vocab_size))
    assert tokens == {o.uid: o.tokens[:8].tolist() for o in outs[:2]}
    assert converts == tel.registry.snapshot()[
        "repro_pim_adc_converts_total"]["series"][0]["value"]
