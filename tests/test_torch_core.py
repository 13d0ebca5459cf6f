"""The port's quantization and PIM linear layer against the reference.

Same float inputs (numpy-seeded) go through ``repro`` and ``repro_torch``;
codes, scales, encodings and the integer datapath agree bit for bit, and
so do the float outputs, because both sides apply the same float32
operations in the same order to identical values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as ref_adc
from repro.core import pim_linear as ref_pl
from repro.quant import quantize as ref_q
from repro_torch.core import adc as adc_lib
from repro_torch.core import backends as bk
from repro_torch.core import crossbar as xbar
from repro_torch.core import pim_linear as pl
from repro_torch.core import rng
from repro_torch.quant import quantize as q

from _torch_parity import one_thread  # noqa: F401  (autouse fixture)


def _eq(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((1100, 56)) * 0.05).astype(np.float32)
    w[:, 3] += 0.2  # a skewed column: the centered quantizer's case
    x_cal = rng.standard_normal((16, 1100)).astype(np.float32)
    x = rng.standard_normal((7, 1100)).astype(np.float32) * 1.3
    return w, x_cal, x


def test_quantizers_match_reference(weights):
    w, x_cal, _ = weights
    wt, xt = torch.from_numpy(w), torch.from_numpy(x_cal)
    for got, ref in zip(q.quantize_weights_per_channel(wt),
                        ref_q.quantize_weights_per_channel(jnp.asarray(w))):
        _eq(got, ref)
    for got, ref in zip(q.quantize_weights_centered(wt),
                        ref_q.quantize_weights_centered(jnp.asarray(w))):
        _eq(got, ref)
    for signed in (True, False, None):
        lq, w_q = q.calibrate_layer(wt, xt.abs() if signed is False else xt,
                                    signed_inputs=signed)
        rlq, rw_q = ref_q.calibrate_layer(
            jnp.asarray(w), jnp.abs(jnp.asarray(x_cal)) if signed is False
            else jnp.asarray(x_cal), signed_inputs=signed)
        _eq(w_q, rw_q)
        for f in ("w_scale", "x_scale"):
            _eq(getattr(lq, f), getattr(rlq, f))
        # out_scale comes from a float32 matmul (x_cal @ w) whose summation
        # order differs between the frameworks: ~1 ulp of its max element
        np.testing.assert_allclose(lq.out_scale.numpy(),
                                   np.asarray(rlq.out_scale), rtol=1e-5)
        assert lq.x_signed == rlq.x_signed


@pytest.fixture(scope="module")
def plans(weights):
    w, x_cal, _ = weights
    ref = ref_pl.prepare(jnp.asarray(w), jnp.asarray(x_cal),
                         signed_inputs=True,
                         adc=ref_adc.ADCConfig(bits=24))
    port = pl.prepare(torch.from_numpy(w), torch.from_numpy(x_cal),
                      signed_inputs=True, adc=adc_lib.ADCConfig(bits=24))
    return ref, port


def test_prepare_matches_reference(plans):
    ref, port = plans
    _eq(port.enc.planes, ref.enc.planes)
    _eq(port.enc.centers, ref.enc.centers)
    _eq(port.w_q, ref.w_q)
    for f in ("fast_w_off", "fast_centers", "fast_scale"):
        _eq(getattr(port, f), getattr(ref, f))


@pytest.mark.parametrize("bits", [7, 24])
def test_forward_exact_matches_reference(plans, weights, bits):
    ref, port = plans
    ref = dataclasses.replace(ref, adc=ref_adc.ADCConfig(bits=bits))
    port = dataclasses.replace(port, adc=adc_lib.ADCConfig(bits=bits))
    x = weights[2]
    y_ref, st_ref = ref_pl.forward_exact(jnp.asarray(x), ref,
                                         return_stats=True)
    y, st = pl.forward_exact(torch.from_numpy(x), port, return_stats=True)
    _eq(y, y_ref)
    for s, r in zip(st, st_ref):
        for f in ("adc_converts", "spec_failures", "recovery_saturations",
                  "spec_attempts", "no_spec_converts"):
            assert int(getattr(s, f)) == int(getattr(r, f)), f


def test_int_reference_matches_and_equals_exact_at_24b(plans, weights):
    """The pim_mode contract: at a non-saturating ADC the exact datapath
    is the ideal 8b-quantized layer, bit for bit."""
    ref, port = plans
    x = torch.from_numpy(weights[2])
    y_int = pl.forward_int_reference(x, port)
    _eq(y_int, ref_pl.forward_int_reference(jnp.asarray(weights[2]), ref))
    _eq(pl.forward_exact(x, port), y_int.numpy())


@pytest.mark.parametrize("signed", [True, False])
def test_forward_fast_matches_reference(plans, weights, signed):
    """The K3 path including the unsigned-input shift correction."""
    ref, port = plans
    x = np.abs(weights[2]) if not signed else weights[2]
    ref = dataclasses.replace(
        ref, lq=dataclasses.replace(ref.lq, x_signed=signed))
    port = dataclasses.replace(
        port, lq=dataclasses.replace(port.lq, x_signed=signed))
    _eq(pl.forward_fast(torch.from_numpy(x), port),
        ref_pl.forward_fast(jnp.asarray(x), ref, backend="interpret"))


def test_unported_datapaths_raise(plans, weights):
    """The datapaths that raised before they were ported now run, on both
    the speculation and the static path: a nominal die equals the ideal
    device, a 3-sigma die and ADC noise move the outputs, one key gives
    one result. What still raises is misuse: noise without a key
    (``ValueError``, never a silent noiseless run) and an unknown
    backend."""
    _, port = plans
    x = torch.from_numpy(weights[2])
    die = bk.make("nonideal", "3sigma", seed=1)
    for spec_on in (True, False):
        plan = dataclasses.replace(port, speculation=spec_on)
        y = pl.forward_exact(x, plan)
        assert y.shape == (7, 56)
        nominal = dataclasses.replace(plan, device=bk.make("nonideal"))
        _eq(pl.forward_exact(x, nominal), y.numpy())
        on_die = pl.forward_exact(x, dataclasses.replace(plan, device=die))
        assert torch.isfinite(on_die).all() and not torch.equal(on_die, y)
        noisy = pl.forward_exact(x, plan, noise_level=0.05, key=rng.Key(0))
        assert torch.isfinite(noisy).all() and not torch.equal(noisy, y)
        _eq(pl.forward_exact(x, plan, noise_level=0.05, key=rng.Key(0)),
            noisy.numpy())
        with pytest.raises(ValueError, match="requires a key"):
            pl.forward_exact(x, plan, noise_level=0.05)
    with pytest.raises(ValueError, match="requires a key"):
        xbar.forward(torch.zeros((1, 1100), dtype=torch.int32), port.enc,
                     noise_level=0.05)
    with pytest.raises(ValueError, match="crossbar backend"):
        bk.make("analog")
