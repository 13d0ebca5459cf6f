"""Algorithm 1 (Adaptive Weight Slicing) in the port against the reference.

- The candidate front and the slicing enumeration equal the reference's.
- ``measure_errors`` and ``find_best_slicing`` pick the same slicing with
  the same errors: the errors are sums of integer code differences over
  integer counts in float32, so they are held for equality, over the
  default search, ``last_layer``, ``encode_mode="zero"`` and
  ``full_search``.
- On a 2-layer reduced qwen1.5-0.5b (float32, the reference's weights,
  layer 0's ``w2`` mostly zeroed so its slicing differs from layer 1's),
  the port's per-site compile fed the reference's captured activations
  reproduces every slicing, error and plan leaf bit for bit, ragged
  ``slice_valid`` / ``slice_shifts`` included; the port's forward on the
  reference's own plans (``convert.plans_from_reference``) matches the
  reference's logits at the 7b ADC within ``_torch_parity.ATOL``; the
  port's own adaptive plans serve ``exact`` equal to ``int8`` at 24b; and
  the port's own compile reports (``CompiledPim.report``) the reference's
  dict, measured errors included.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from _torch_parity import one_thread  # noqa: F401  (autouse fixture)
from repro import configs as ref_configs
from repro.core import adaptive as ref_ad
from repro.core import adc as ref_adc
from repro.core import slicing as ref_sl
from repro.models import pim_compile as ref_pc
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.core import adaptive as ad
from repro_torch.core import adc as adc_lib
from repro_torch.core import slicing as sl
from repro_torch.models import convert
from repro_torch.models import pim_compile as pc

ARCH = "qwen1.5-0.5b"


def test_candidates_match_reference():
    assert sl.enumerate_slicings() == ref_sl.enumerate_slicings()
    assert len(sl.enumerate_slicings()) == 108
    for full in (False, True):
        assert ad.candidate_slicings(full_search=full) == \
            ref_ad.candidate_slicings(full_search=full)
    front = ad.candidate_slicings()
    assert len(front) == 15 and front[0] == (4, 4) and front[-1] == (1,) * 8
    assert len({len(s) for s in front}) == 7


def _layer(seed: int, rows: int, signed: bool):
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.04, size=(rows, 24)).astype(np.float32)
    x = rng.normal(0.2, 0.35, size=(10, rows)).astype(np.float32)
    return w, (x if signed else np.maximum(x, 0))


@pytest.mark.parametrize("bits", [6, 7])
def test_measure_errors_match_reference(bits):
    w, x = _layer(0, 700, signed=True)
    cands = ad.candidate_slicings()[:6]
    got = ad.measure_errors(torch.from_numpy(w), torch.from_numpy(x), cands,
                            adc=adc_lib.ADCConfig(bits=bits))
    want = ref_ad.measure_errors(jnp.asarray(w), jnp.asarray(x), cands,
                                 adc=ref_adc.ADCConfig(bits=bits))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and (got > 0).any()
    assert ad.measure_error(torch.from_numpy(w), torch.from_numpy(x),
                            cands[0], adc=adc_lib.ADCConfig(bits=bits)) \
        == float(want[0])


@pytest.mark.parametrize("kw", [
    {}, {"last_layer": True}, {"encode_mode": "zero"},
    {"full_search": True}, {"error_budget": 0.0},
], ids=["default", "last_layer", "zero", "full_search", "fallback"])
@pytest.mark.parametrize("signed", [False, True])
def test_find_best_slicing_matches_reference(kw, signed):
    w, x = _layer(3 + signed, 600, signed)
    got = ad.find_best_slicing(torch.from_numpy(w), torch.from_numpy(x),
                               **kw)
    want = ref_ad.find_best_slicing(jnp.asarray(w), jnp.asarray(x), **kw)
    assert got.slicing == want.slicing and got.n_slices == want.n_slices
    assert got.error == want.error
    assert got.all_errors == want.all_errors


# ---------------------------------------------------------------- model
@functools.lru_cache(maxsize=None)
def _model():
    over = dict(dtype="float32", kv_cache_dtype="float32", n_layers=2,
                pim_mode="exact", pim_weight_slicing="adaptive")
    rcfg = ref_configs.get(ARCH).reduced(**over)
    cfg = configs.get(ARCH).reduced(**over)
    rparams, _ = RT.init_params(rcfg, jax.random.key(0))
    # squash most rows of layer 0's down-projection: its column sums stay
    # small, so Algorithm 1 picks fewer slices for it than for layer 1
    w2 = rparams["blocks"][0]["ffn"]["w2"]
    rparams["blocks"][0]["ffn"]["w2"] = w2.at[0, 24:, :].set(0.0)
    np_params = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    params = convert.params_from_reference(np_params, cfg, "cpu")
    calib = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, P.TOTAL)).astype(np.int32)
    ref = ref_pc.compile_pim_params(rparams, rcfg, calib)
    return rcfg, cfg, rparams, np_params, params, calib, tokens, ref


def test_site_compile_reproduces_reference():
    rcfg, cfg, rparams, np_params, _, calib, _, ref = _model()
    w2 = ref.site("blocks[0].ffn.w2[r0]").slicing
    assert w2 != ref.site("blocks[0].ffn.w2[r1]").slicing
    assert ref.site("embed.head").slicing == pc.CONSERVATIVE_SLICING
    taps = ref_pc._build_taps(rcfg)
    ref_pc._capture(rparams, rcfg, calib, taps)
    ragged = False
    for g, names in P.PROJ.items():
        for name in names:
            site = f"blocks[0].{g}.{name}"
            leaf, sites = pc._compile_site(
                site, [torch.from_numpy(np_params["blocks"][0][g][name][r])
                       for r in range(cfg.n_layers)],
                [torch.tensor(x) for x in taps["blocks"][0][g][name].x], cfg)
            for sp in sites:
                want = ref.site(sp.site)
                assert (sp.slicing, sp.error, sp.search_adc_bits) == \
                    (want.slicing, want.error, want.search_adc_bits), sp.site
            for k, v in leaf.items():
                np.testing.assert_array_equal(
                    v.numpy(), np.asarray(ref.plans["blocks"][0][g][name][k]))
            ragged |= not bool(leaf["slice_valid"].all())
    assert ragged  # some site's instances chose different slice counts
    leaf, sites = pc._compile_site(
        "embed.head", [torch.from_numpy(np_params["embed"]["head"])],
        [torch.tensor(taps["embed"]["head"].x[0])], cfg, last_layer=True)
    want = ref.site("embed.head")
    assert (sites[0].slicing, sites[0].error) == (want.slicing, want.error)
    for k, v in leaf.items():
        np.testing.assert_array_equal(
            v[0].numpy(), np.asarray(ref.plans["embed"]["head"][k]))


def test_forward_on_reference_plans_matches_reference():
    """The port's prefill + decode on the reference's ragged adaptive
    plans, at the paper's 7b ADC (speculation failures and recovery)."""
    rcfg, cfg, rparams, _, params, _, tokens, ref = _model()
    rc = dataclasses.replace(rcfg, pim_adc_bits=7)
    c = dataclasses.replace(cfg, pim_adc_bits=7)
    plans = convert.plans_from_reference(
        jax.tree.map(np.asarray, ref.plans), c, "cpu")
    got = P.run_port(c, params, plans, tokens)
    P.assert_logits_close(got, P.run_ref(rc, rparams, ref.plans, tokens),
                          "exact")


@functools.lru_cache(maxsize=None)
def _port_compiled():
    _, cfg, _, _, params, calib, _, _ = _model()
    return pc.compile_pim_params(params, cfg, calib)


def test_port_adaptive_plans_serve_exact_equal_int8():
    """The port's own Algorithm-1 compile chooses the reference's slicings
    and its ragged plans keep the pim_mode contract at 24b."""
    _, cfg, _, _, params, calib, tokens, ref = _model()
    compiled = _port_compiled()
    assert [(s.site, s.slicing) for s in compiled.sites] == \
        [(s.site, s.slicing) for s in ref.sites]
    assert compiled.distinct_slicings() == ref.distinct_slicings()
    exact = P.run_port(cfg, params, compiled.plans, tokens)
    int8 = P.run_port(dataclasses.replace(cfg, pim_mode="int8"), params,
                      compiled.plans, tokens)
    np.testing.assert_array_equal(exact, int8)


def test_report_matches_reference():
    """The energy report of the port's own adaptive compile equals the
    reference's dict: the same slicings and errors, priced by the port's
    copy of ``core.energy``."""
    ref = _model()[-1]
    compiled = _port_compiled()
    assert compiled.report(tokens=64) == ref.report(tokens=64)
    rep = compiled.report()
    assert rep == ref.report()
    assert rep["slicing"] == "adaptive" and len(rep["slice_histogram"]) > 1
    assert all(s["error"] is not None for s in rep["sites"])
