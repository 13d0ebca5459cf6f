"""The port's encoder-only models against the reference: reduced float32
raella-bert-large (token inputs, ``causal=False``, gelu) and hubert-xlarge
(frame-embedding inputs), two layers each, the reference's weights
carried across.

- Configs compare equal; the reference's ``TestSmoke`` mirrored in the
  port (shapes, no NaN, the analytic parameter count, a finite loss).
- ``forward`` logits against the reference's in off, fast, int8 and exact
  mode on the reference's own plans (``plans_from_reference``), within
  ``_torch_parity.ATOL``; exact == int8 in the port at the 24b ADC.
- The port's ``compile_pim_params`` (hubert: from calibration embeddings)
  against the reference's compile leaf for leaf, x_scale to a few ulp
  from each framework's own capture; fed the reference's captured
  activations, its site compiler gives every leaf bit for bit, and
  Algorithm 1 on the encoder's sites makes the reference's choices with
  its errors.
- ``lm_loss`` against ``repro.models.transformer.lm_loss`` in its three
  branches (causal tokens: reduced qwen1.5-0.5b; non-causal tokens: bert;
  embeddings: hubert), with and without a mask, over several chunks with
  a padded last one, within ``LOSS_ATOL``.
- The engines and the launcher refuse both models, as the reference's
  engines do.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import pim_compile as ref_pc
from repro.models import transformer as RT
from repro.serve import ContinuousServeEngine as RefContinuous
from repro.serve import PagedServeEngine as RefPaged
from repro.serve import ServeEngine as RefServe
from repro_torch import configs
from repro_torch.launch import serve as launcher
from repro_torch.models import convert
from repro_torch.models import pim_compile as pc
from repro_torch.models import transformer as T
from repro_torch.serve import (ContinuousServeEngine, PagedServeEngine,
                               ServeEngine)

import _torch_parity as P
from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

BERT, HUBERT = "raella-bert-large", "hubert-xlarge"
ENCODERS = (BERT, HUBERT)
N_LAYERS = 2
SEQ = 10
# float32 cross-entropy of the same hidden states: both frameworks sum
# (B, S) terms of ~log(vocab) in other orders
LOSS_ATOL = 1e-5
# x_scale (max |activation| / 127) from each framework's own float capture:
# the same float32 forward summed in other orders, a few ulp apart (the
# bound test_torch_hybrid.py holds the toy's sites to)
XSCALE_RTOL = 2e-6


def _inputs(cfg, seed: int, S: int) -> np.ndarray:
    """(2, S) token ids, or (2, S, d_model) float32 frame embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    return rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)


def _port_inputs(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.long() if t.dtype == torch.int32 else t


@functools.lru_cache(maxsize=None)
def setup(arch: str):
    """(reference cfg, port cfg, reference params, numpy params, port
    params, calibration inputs, forward inputs), float32."""
    over = dict(dtype="float32", kv_cache_dtype="float32", n_layers=N_LAYERS)
    rcfg = ref_configs.get(arch).reduced(**over)
    cfg = configs.get(arch).reduced(**over)
    rparams = jax.jit(lambda k: RT.init_params(rcfg, k)[0])(
        jax.random.key(0))
    np_params = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    params = convert.params_from_reference(np_params, cfg, "cpu")
    return (rcfg, cfg, rparams, np_params, params, _inputs(cfg, 3, 8),
            _inputs(cfg, 4, SEQ))


@functools.lru_cache(maxsize=None)
def ref_compiled(arch: str, mode: str, slicing=None):
    rcfg, _, rparams, _, _, calib, _ = setup(arch)
    rc = dataclasses.replace(rcfg, pim_mode=mode, **(
        {} if slicing is None else {"pim_weight_slicing": slicing}))
    return ref_pc.compile_pim_params(rparams, rc, calib)


@functools.lru_cache(maxsize=None)
def port_compiled(arch: str, mode: str, slicing=None):
    _, cfg, _, _, params, calib, _ = setup(arch)
    c = dataclasses.replace(cfg, pim_mode=mode, **(
        {} if slicing is None else {"pim_weight_slicing": slicing}))
    return pc.compile_pim_params(params, c, calib)


def ref_forward(arch: str, mode: str) -> np.ndarray:
    rcfg, _, rparams, _, _, _, x = setup(arch)
    rc = dataclasses.replace(rcfg, pim_mode=mode)
    plans = None if mode == "off" else ref_compiled(arch, mode).plans
    fwd = jax.jit(lambda p, pl, t: RT.forward(p, rc, t, plans=pl))
    return np.asarray(fwd(rparams, plans, jnp.asarray(x)))


@functools.lru_cache(maxsize=None)
def port_forward(arch: str, mode: str, plans_from: str) -> np.ndarray:
    """The port's forward logits on the reference's plans carried across
    (``plans_from="ref"``) or on its own compile (``"port"``)."""
    _, cfg, _, _, params, _, x = setup(arch)
    c = dataclasses.replace(cfg, pim_mode=mode)
    plans = None
    if mode != "off" and plans_from == "ref":
        plans = convert.plans_from_reference(
            jax.tree.map(np.asarray, ref_compiled(arch, mode).plans), c,
            "cpu")
    elif mode != "off":
        plans = port_compiled(arch, mode).plans
    with torch.no_grad():
        return T.forward(params, c, _port_inputs(x), plans).numpy()


def assert_leaf_equal(got: dict, want: dict, xscale_rtol: float) -> None:
    assert set(got) == set(want)
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k == "x_scale":
            np.testing.assert_allclose(g, w, rtol=xscale_rtol)
        else:
            np.testing.assert_array_equal(g, w)


def port_leaves(plans: dict) -> list:
    """(site, leaf) per port site instance, in the reference's site order
    (per pattern position, each group's projections over the repeats)."""
    out = []
    for g, names in P.PROJ.items():
        for n in names:
            for r, lp in enumerate(plans["layers"]):
                out.append((f"blocks[0].{g}.{n}[r{r}]", lp[g][n]))
    return out + [("embed.head", plans["head"])]


def ref_leaves(plans: dict) -> list:
    out = []
    for g, names in P.PROJ.items():
        for n in names:
            leaf = plans["blocks"][0][g][n]
            for r in range(N_LAYERS):
                out.append((f"blocks[0].{g}.{n}[r{r}]",
                            {k: np.asarray(v)[r] for k, v in leaf.items()}))
    return out + [("embed.head", plans["embed"]["head"])]


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ENCODERS)
def test_configs_compare_equal(arch):
    for full in (True, False):
        r, c = ref_configs.get(arch), configs.get(arch)
        if not full:
            r, c = r.reduced(), c.reduced()
        assert dataclasses.asdict(r) == dataclasses.asdict(c)
    cfg = configs.get(arch)
    assert cfg.param_count() == ref_configs.get(arch).param_count()
    assert not cfg.causal and cfg.activation == "gelu"
    assert cfg.input_mode == ("embeddings" if arch == HUBERT else "tokens")


# ------------------------------------------- tests/test_archs_smoke.py
@pytest.mark.parametrize("arch", ENCODERS)
class TestSmoke:
    """``tests/test_archs_smoke.py::TestSmoke`` on the port's own random
    weights (default reduced config, bf16); the train step is forward
    only here, the loss."""

    @staticmethod
    def _model(arch, seed):
        cfg = configs.get(arch).reduced()
        params = T.init_params(cfg, seed=seed, device="cpu")
        x = _port_inputs(_inputs(cfg, seed, 16))
        return cfg, params, x

    def test_forward_shapes_no_nan(self, arch):
        cfg, params, x = self._model(arch, 0)
        with torch.no_grad():
            logits = T.forward(params, cfg, x)
        assert logits.shape == (2, 16, cfg.vocab_size)
        assert not bool(torch.isnan(logits).any())

    def test_loss_is_finite(self, arch):
        cfg, params, x = self._model(arch, 1)
        labels = torch.randint(0, cfg.vocab_size, (2, 16),
                               generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            loss = T.lm_loss(params, cfg, {"inputs": x, "labels": labels})
        assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
        assert float(loss) > 0.0

    def test_param_count_analytic_close(self, arch):
        cfg, params, _ = self._model(arch, 3)

        def count(t):
            if isinstance(t, torch.Tensor):
                return t.numel()
            vals = t.values() if isinstance(t, dict) else t
            return sum(count(v) for v in vals)
        actual = count(params)
        assert 0.5 < actual / cfg.param_count() < 2.0, actual
        # an embeddings-mode model keeps its (unused) embedding table
        assert params["embed"]["embed"].shape == (cfg.vocab_size,
                                                  cfg.d_model)


# -------------------------------------------------------------- logits
@pytest.mark.parametrize("mode", P.MODES)
@pytest.mark.parametrize("arch", ENCODERS)
def test_forward_matches_reference(arch, mode):
    """The port's forward on the reference's plans, carried across by
    ``plans_from_reference``, against the reference's forward on them."""
    got = port_forward(arch, mode, "ref")
    want = ref_forward(arch, mode)
    assert got.shape == (2, SEQ, configs.get(arch).reduced().vocab_size)
    np.testing.assert_allclose(got, want, atol=P.ATOL[mode], rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * P.ATOL[mode]
    assert clear.any()
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("mode", ["fast", "int8", "exact"])
@pytest.mark.parametrize("arch", ENCODERS)
def test_own_compile_matches_reference(arch, mode):
    """The port's ``compile_pim_params`` (hubert's from calibration
    embeddings) against the reference's: the same sites, every leaf bit
    for bit but x_scale, which each framework's own float capture gives to
    a few ulp; fed the reference's captured activations, the port's site
    compiler gives x_scale too bit for bit. The port's forward on its own
    plans stays within ``ATOL[mode]`` of the reference's."""
    rcfg, cfg, rparams, np_params, _, calib, _ = setup(arch)
    ref, port = ref_compiled(arch, mode), port_compiled(arch, mode)
    assert [(s.site, s.slicing, s.d_in, s.d_out) for s in port.sites] == \
        [(s.site, s.slicing, s.d_in, s.d_out) for s in ref.sites]
    assert len(port.sites) == 7 * N_LAYERS + 1
    for (name, got), (rname, want) in zip(port_leaves(port.plans),
                                          ref_leaves(ref.plans)):
        assert name == rname
        assert_leaf_equal(got, want, XSCALE_RTOL)
    rc, c = (dataclasses.replace(a, pim_mode=mode) for a in (rcfg, cfg))
    taps = ref_pc._build_taps(rc)
    ref_pc._capture(rparams, rc, calib, taps)
    for g, names in P.PROJ.items():
        for n in names:
            leaf, _ = pc._compile_site(
                n, [torch.from_numpy(np_params["blocks"][0][g][n][r])
                    for r in range(N_LAYERS)],
                [torch.tensor(x) for x in taps["blocks"][0][g][n].x], c)
            for k, v in leaf.items():
                np.testing.assert_array_equal(
                    v.numpy(), np.asarray(ref.plans["blocks"][0][g][n][k]))
    leaf, _ = pc._compile_site(
        "embed.head", [torch.from_numpy(np_params["embed"]["head"])],
        [torch.tensor(taps["embed"]["head"].x[0])], c, last_layer=True)
    assert_leaf_equal({k: v[0] for k, v in leaf.items()},
                      ref.plans["embed"]["head"], 0)
    np.testing.assert_allclose(port_forward(arch, mode, "port"),
                               ref_forward(arch, mode), atol=P.ATOL[mode],
                               rtol=0)


@pytest.mark.parametrize("arch", ENCODERS)
def test_int8_equals_exact_in_port(arch):
    """The ``pim_mode`` contract at the 24b ADC, on the port's plans."""
    np.testing.assert_array_equal(port_forward(arch, "int8", "port"),
                                  port_forward(arch, "exact", "port"))


def test_adaptive_sites_match_reference():
    """Algorithm 1 on bert's query and down projections through each
    framework's site compiler on the reference's captured activations:
    the same slicings (two of them: the down projection's second instance
    takes (4, 3, 1)) and measured errors, every exact leaf bit for bit;
    the port's whole adaptive compile names the reference's sites,
    measures each and keeps the head conservative."""
    rcfg, cfg, rparams, np_params, params, calib, _ = setup(BERT)
    over = dict(pim_mode="exact", pim_weight_slicing="adaptive")
    rc, c = (dataclasses.replace(a, **over) for a in (rcfg, cfg))
    taps = ref_pc._build_taps(rc)
    ref_pc._capture(rparams, rc, calib, taps)
    chosen = set()
    for g, n in (("core", "wq"), ("ffn", "w2")):
        name = f"blocks[0].{g}.{n}"
        w = np_params["blocks"][0][g][n]
        x = np.stack(taps["blocks"][0][g][n].x)
        want, want_sites = ref_pc._compile_site(name, w, x, rc, stack_dims=1)
        leaf, sites = pc._compile_site(
            name, [torch.from_numpy(w[r]) for r in range(N_LAYERS)],
            [torch.from_numpy(x[r]) for r in range(N_LAYERS)], c)
        assert [(s.site, s.slicing, s.error) for s in sites] == \
            [(s.site, s.slicing, s.error) for s in want_sites]
        for k, v in leaf.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
        chosen.update(s.slicing for s in sites)
    assert len(chosen) >= 2  # the search lands on different slicings
    whole = port_compiled(BERT, "exact", "adaptive")
    assert [s.site for s in whole.sites] == \
        [s.site for s in ref_compiled(BERT, "exact").sites]
    assert all(s.error is not None for s in whole.sites)
    assert whole.site("embed.head").slicing == pc.CONSERVATIVE_SLICING


# ---------------------------------------------------------------- loss
def _loss_setup(arch: str):
    """(reference cfg, port cfg, reference params, port params, batch in
    numpy): reduced qwen1.5-0.5b for the causal branch (the parity
    helpers' setup), else the encoders'."""
    if arch in ENCODERS:
        rcfg, cfg, rparams, _, params, _, x = setup(arch)
    else:
        rcfg, cfg, rparams, _, params, _, x = P.setup(arch)
    labels = np.random.default_rng(5).integers(
        0, cfg.vocab_size, x.shape[:2]).astype(np.int32)
    return rcfg, cfg, rparams, params, x, labels


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", BERT, HUBERT])
def test_lm_loss_matches_reference(arch, masked, monkeypatch):
    """``lm_loss`` in each branch against the reference's, with chunks of
    4 positions in both (SEQ = 10: three chunks, the last padded by 2),
    and in one chunk. The mask zeroes a ragged set of positions; the loss
    is float in every ``pim_mode``, so an exact-mode config gives the
    float loss."""
    rcfg, cfg, rparams, params, x, labels = _loss_setup(arch)
    batch = {"inputs": x, "labels": labels}
    if masked:
        batch["mask"] = (np.random.default_rng(6).random(labels.shape)
                         < 0.7).astype(np.float32)
    pbatch = {k: _port_inputs(v) for k, v in batch.items()}
    got, want = [], []
    for chunk in (4, T.LOSS_CHUNK):
        monkeypatch.setattr(T, "LOSS_CHUNK", chunk)
        monkeypatch.setattr(RT, "LOSS_CHUNK", chunk)
        with torch.no_grad():
            got.append(float(T.lm_loss(params, cfg, pbatch)))
        want.append(float(RT.lm_loss(rparams, rcfg, {
            k: jnp.asarray(v) for k, v in batch.items()})))
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    with torch.no_grad():
        exact = T.lm_loss(params, dataclasses.replace(cfg, pim_mode="exact"),
                          pbatch)
    assert float(exact) == got[-1]


# --------------------------------------------------------------- serve
@pytest.mark.parametrize("arch", ENCODERS)
def test_engines_refuse_encoders(arch):
    """Every engine refuses an encoder-only model with the reference's
    error (no decode step), the reference's engines included."""
    rcfg, cfg, rparams, _, params, _, _ = setup(arch)
    msg = f"{cfg.name} is encoder-only; no decode"
    for eng, p, c in ((ServeEngine, params, cfg),
                      (ContinuousServeEngine, params, cfg),
                      (PagedServeEngine, params, cfg),
                      (RefServe, rparams, rcfg),
                      (RefContinuous, rparams, rcfg),
                      (RefPaged, rparams, rcfg)):
        with pytest.raises(ValueError) as err:
            eng(c, p)
        assert str(err.value) == msg


@pytest.mark.parametrize("arch", ENCODERS)
def test_launcher_refuses_encoders(arch, monkeypatch):
    """The launcher refuses an encoder with the engines' error before it
    draws weights or compiles."""
    def no_init(*a, **k):
        raise AssertionError("init_params ran before the refusal")
    monkeypatch.setattr(T, "init_params", no_init)
    with pytest.raises(ValueError, match=f"{arch} is encoder-only"):
        launcher.main(["--arch", arch, "--device", "cpu", "--pim", "exact"])
