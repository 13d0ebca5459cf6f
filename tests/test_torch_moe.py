"""The port's mixture-of-experts FFN against the reference: reduced
float32 phi3.5-moe-42b (top-2 softmax gate, MoE on every layer, two
layers here) and llama4-maverick-400b (top-1 sigmoid gate, MoE on even
layers, dense FFNs between), the reference's weights carried across.

- ``moe_block``: the kept (token, expert, position) triples — read from
  the reference's own dispatch buffer through a ``PimTap`` — are equal,
  prefill shapes, the merged decode group, capacity 1.25 with slots
  dropped and two dispatch groups with padding included; outputs agree
  within ``ATOL_FFN``.
- ``compile_pim_params``: per-(repeat, expert) site names, slicings,
  errors and every plan leaf equal in fast and exact mode, pinned and
  adaptive (Algorithm 1 per (repeat, expert)); ``x_scale`` to a few ulp
  from each framework's own forward and bit for bit from the reference's
  activations. Algorithm 1 through the site compiler on an expert that no
  calibration token reached. The folds of the exact prepare in bounded
  groups equal the one-call fold.
- Logits on the reference's plans within ``_torch_parity.ATOL``, the
  reference's fast mode included (held to its own outputs, not to the
  float-distance bound it misses).
- The port alone: int8 == exact, prefill + decode == forward, continuous
  == lockstep, paged == contiguous, and the launcher in every mode.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import pim_compile as ref_pc
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.launch import serve as launcher
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import pim_compile as pc
from repro_torch.models import transformer as T
from repro_torch.serve import (
    ContinuousServeEngine,
    PagedServeEngine,
    Request,
    ServeEngine,
)

import _torch_parity as P
from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

PHI, LLAMA4 = "phi3.5-moe-42b", "llama4-maverick-400b"
N_LAYERS = {PHI: 2, LLAMA4: 2}  # two repeats of phi's one-layer pattern
# moe_block outputs in float32: the expert products are reassociated
# (a batched matmul against the reference's einsum) at d_ff = 128
ATOL_FFN = 1e-5
# x_scale from each framework's own calibration forward: the qwen tests'
# 5e-7 holds for attention sites; an expert site's inputs have passed
# through reassociated expert products (layer 1's down-projection
# through two), ~10 ulp
XSCALE_RTOL = 2e-6


@functools.lru_cache(maxsize=None)
def setup(arch: str):
    over = dict(dtype="float32", kv_cache_dtype="float32",
                n_layers=N_LAYERS[arch])
    rcfg = ref_configs.get(arch).reduced(**over)
    cfg = configs.get(arch).reduced(**over)
    rparams, _ = RT.init_params(rcfg, jax.random.key(0))
    np_params = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    params = convert.params_from_reference(np_params, cfg, "cpu")
    calib = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, P.TOTAL)).astype(np.int32)
    return rcfg, cfg, rparams, np_params, params, calib, tokens


def pim_over(mode: str) -> dict:
    """Config fields of ``mode``: a pim mode with the pinned (4,2,2)
    slicing, or "adaptive" (exact, Algorithm 1 per instance)."""
    if mode == "adaptive":
        return dict(pim_mode="exact", pim_weight_slicing="adaptive")
    return dict(pim_mode=mode)


@functools.lru_cache(maxsize=None)
def port_compiled(arch: str, mode: str):
    """The port's CompiledPim for ``mode`` (``pim_over``)."""
    _, cfg, _, _, params, calib, _ = setup(arch)
    return pc.compile_pim_params(
        params, dataclasses.replace(cfg, **pim_over(mode)), calib)


@functools.lru_cache(maxsize=None)
def compiled(arch: str, mode: str):
    """(reference CompiledPim, port CompiledPim) for ``mode``."""
    rcfg, _, rparams, _, _, calib, _ = setup(arch)
    return (ref_pc.compile_pim_params(
                rparams, dataclasses.replace(rcfg, **pim_over(mode)), calib),
            port_compiled(arch, mode))


@functools.lru_cache(maxsize=None)
def ref_taps(arch: str) -> dict:
    """The reference's calibration activations of every site (its float
    capture forward; the pim fields do not enter it)."""
    rcfg, _, rparams, _, _, calib, _ = setup(arch)
    taps = ref_pc._build_taps(rcfg)
    ref_pc._capture(rparams, rcfg, calib, taps)
    return taps


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_configs_compare_equal(arch):
    for full in (True, False):
        r, c = ref_configs.get(arch), configs.get(arch)
        if not full:
            r, c = r.reduced(), c.reduced()
        assert dataclasses.asdict(r) == dataclasses.asdict(c)
    cfg = configs.get(arch)
    assert cfg.is_moe and cfg.param_count() == ref_configs.get(
        arch).param_count()


def test_moe_routes_tokens_to_experts():
    """Routing is input-dependent (the reference's smoke test, on the
    port's own random weights)."""
    cfg = configs.get(PHI).reduced()
    params = T.init_params(cfg, seed=6, device="cpu")
    rng = np.random.default_rng(7)
    x1, x2 = (torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
              for _ in range(2))
    with torch.no_grad():
        l1, l2 = T.forward(params, cfg, x1), T.forward(params, cfg, x2)
    assert not torch.allclose(l1, l2)
    assert params["layers"][0]["ffn"]["router"].dtype == torch.float32
    assert params["layers"][0]["ffn"]["w1"].shape == (
        cfg.n_experts, cfg.d_model, cfg.d_ff)


# ------------------------------------------------------------ moe_block
# (B, S, capacity_factor): a prefill shape, a decode step (one merged
# dispatch group), capacity 1.25 where slots drop, and two groups with
# padding at capacity 1.0
CASES = {"prefill": (2, 8, 4.0), "decode": (11, 1, 1.25),
         "drop": (2, 24, 1.25), "groups": (1, 600, 1.0)}


def _moe_case(arch: str, case: str):
    rcfg, cfg, _, np_params, params, _, _ = setup(arch)
    B, S, cf = CASES[case]
    rcfg = dataclasses.replace(rcfg, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    x = np.random.default_rng(11).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    rp = {k: v[0] for k, v in np_params["blocks"][0]["ffn"].items()}
    return rcfg, cfg, rp, params["layers"][0]["ffn"], x


def _expected_buffer(rt: L.MoeRoute, x: np.ndarray, k: int,
                     E: int) -> np.ndarray:
    """The dispatch buffer ``(E, B * n_groups * cap, D)`` that ``rt``'s
    kept (token, expert, position) triples describe for x (B, S, D)."""
    B, _, D = x.shape
    n_rows = B * rt.n_groups * rt.cap
    buf = np.zeros((E, n_rows, D), np.float32)
    for b, n, g in zip(*np.nonzero(rt.keep.numpy())):
        tok = (n * rt.group + g) // k
        row = (b * rt.n_groups + n) * rt.cap + int(rt.pos[b, n, g])
        buf[int(rt.expert[b, n, g]), row] = x[b, tok]
    return buf


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_moe_block_matches_reference(arch, case):
    """The kept slots and the FFN output against the reference's
    ``moe_block`` (float32, pim off). Distinct token rows make the
    reference's tapped dispatch buffer name each kept triple."""
    rcfg, cfg, rp, p, x = _moe_case(arch, case)
    rtaps = {n: RL.PimTap() for n in ("w1", "w3", "w2")}
    want = np.asarray(RL.moe_block(jax.tree.map(jnp.asarray, rp), rcfg,
                                   jnp.asarray(x), plans=rtaps))
    taps = {n: L.PimTap() for n in ("w1", "w3", "w2")}
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = L.moe_block(p, cfg, xt, plans=taps).numpy()
        B, S, D = x.shape
        merged = x.reshape(1, B, D) if S == 1 else x
        rt = L.moe_route(p, cfg, torch.from_numpy(merged))
    ref_buf = rtaps["w1"].x[0]
    dropped = int(((~rt.keep) & (rt.expert < cfg.n_experts)).sum())
    np.testing.assert_array_equal(
        _expected_buffer(rt, merged, cfg.experts_per_token, cfg.n_experts),
        ref_buf)
    np.testing.assert_array_equal(taps["w1"].x[0].numpy(), ref_buf)
    assert ref_buf.shape[1] == L.moe_dispatch_rows(cfg, B, S)
    np.testing.assert_array_equal(taps["w2"].x[0].shape,
                                  rtaps["w2"].x[0].shape)
    np.testing.assert_allclose(got, want, atol=ATOL_FFN, rtol=0)
    if CASES[case][2] < 4.0:
        assert dropped > 0, "the capacity case dropped no slot"
    else:
        assert dropped == 0
    if case == "groups":
        assert rt.n_groups >= 2 and rt.n_groups * rt.group > 600 * (
            cfg.experts_per_token)  # padding slots in the last group


# ---------------------------------------------------------- the compile
def _check_compiled(arch: str, mode: str) -> None:
    """Sites and every plan leaf of the port's compile against the
    reference's (x_scale to a few ulp); then the site compiler on the
    reference's captured activations, x_scale included, bit for bit."""
    _, cfg, _, np_params, _, _, _ = setup(arch)
    ref, port = compiled(arch, mode)
    assert [(s.site, s.slicing, s.error, s.d_in, s.d_out)
            for s in port.sites] == \
        [(s.site, s.slicing, s.error, s.d_in, s.d_out) for s in ref.sites]
    n_pat = len(cfg.block_pattern)
    pairs = [(port.plans["head"], ref.plans["embed"]["head"], None)]
    for layer in range(cfg.n_layers):
        i, r = layer % n_pat, layer // n_pat
        for g, names in P.PROJ.items():
            for name in names:
                pairs.append((port.plans["layers"][layer][g][name],
                              ref.plans["blocks"][i][g][name], r))
    for got, want, r in pairs:
        assert set(got) == set(want)
        for k in got:
            w = np.asarray(want[k]) if r is None else np.asarray(want[k])[r]
            if k == "x_scale":
                np.testing.assert_allclose(got[k].numpy(), w,
                                           rtol=XSCALE_RTOL)
            else:
                np.testing.assert_array_equal(got[k].numpy(), w)
    c = dataclasses.replace(cfg, **pim_over(mode))
    taps = ref_taps(arch)
    E = cfg.n_experts
    for i in range(n_pat):
        for g, names in P.PROJ.items():
            expert = g == "ffn" and L.is_moe_layer(cfg, i)
            for name in names:
                w = np_params["blocks"][i][g][name]
                x = np.stack(taps["blocks"][i][g][name].x)
                lead = x.shape[:2] if expert else x.shape[:1]
                ws = [torch.from_numpy(a) for a in w.reshape(
                    (-1,) + w.shape[len(lead):])]
                xs = [torch.from_numpy(a) for a in x.reshape(
                    (-1,) + x.shape[len(lead):])]
                tags = [f"[r{r},e{e}]" for r in range(lead[0])
                        for e in range(E)] if expert else None
                site = f"blocks[{i}].{g}.{name}"
                leaf, sites = pc._compile_site(site, ws, xs, c, tags=tags)
                assert [(s.site, s.slicing, s.error) for s in sites] == \
                    [(s.site, s.slicing, s.error) for s in ref.sites
                     if s.site.startswith(site + "[")]
                for k, v in leaf.items():
                    np.testing.assert_array_equal(
                        v.numpy(), np.asarray(
                            ref.plans["blocks"][i][g][name][k]).reshape(
                                v.shape))


@pytest.mark.parametrize("arch,mode", [
    (PHI, "fast"), (PHI, "exact"), (PHI, "adaptive"), (LLAMA4, "exact")])
def test_compile_matches_reference(arch, mode):
    """Pinned and adaptive (the reference's Algorithm 1 per instance
    costs it ~25 s on one thread here)."""
    _check_compiled(arch, mode)
    _, port = compiled(arch, mode)
    names = [s.site for s in port.sites]
    if mode == "adaptive":  # Algorithm 1 chose per instance
        assert len({s.slicing for s in port.sites}) >= 2
        assert all(s.error is not None for s in port.sites)
    if arch == PHI:  # one instance per (repeat, expert)
        assert "blocks[0].ffn.w1[r1,e3]" in names
    else:  # MoE at pattern position 0, a dense FFN at position 1
        assert "blocks[0].ffn.w2[r0,e3]" in names
        assert "blocks[1].ffn.w1[r0]" in names


def test_adaptive_expert_site_matches_reference():
    """Algorithm 1 on experts that no calibration token reached: phi's
    gate projection of both layers through each framework's site
    compiler, on the reference's activations with one expert's dispatch
    buffer of each layer all zero, as an expert that receives no token
    has it: per-instance slicings and measured errors, site names and
    every exact leaf equal; the empty ones get x_scale at the 1e-12
    floor, error 0 for every candidate and the first two-slice
    candidate."""
    rcfg, cfg, _, np_params, _, _, _ = setup(PHI)
    rc, c = (dataclasses.replace(a, **pim_over("adaptive"))
             for a in (rcfg, cfg))
    w = np_params["blocks"][0]["ffn"]["w1"]      # (n_rep, E, d, f)
    x = np.stack(ref_taps(PHI)["blocks"][0]["ffn"]["w1"].x)  # (n_rep, E,
    x[0, 1] = x[1, 2] = 0                                    # N, d)
    name = "blocks[0].ffn.w1"
    want, want_sites = ref_pc._compile_site(name, w, x, rc, stack_dims=2)
    n_rep, E = w.shape[:2]
    leaf, sites = pc._compile_site(
        name, [torch.from_numpy(a) for a in w.reshape(-1, *w.shape[2:])],
        [torch.from_numpy(a) for a in x.reshape(-1, *x.shape[2:])], c,
        tags=[f"[r{r},e{e}]" for r in range(n_rep) for e in range(E)])
    assert [(s.site, s.slicing, s.error) for s in sites] == \
        [(s.site, s.slicing, s.error) for s in want_sites]
    for k, v in leaf.items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(want[k]).reshape(v.shape))
    empty = (x == 0).all(axis=(2, 3)).reshape(-1)
    assert empty.sum() == 2 and not empty.all()
    for sp, e in zip(sites, empty):
        if e:
            assert sp.error == 0.0 and sp.n_slices == 2
            assert float(leaf["x_scale"][sites.index(sp)]) == \
                np.float32(1e-12)


def test_bounded_folds_equal_one_call_fold(monkeypatch):
    """The exact prepare folds a slicing group in bounded pieces; Eq. 2
    centers are per column, so one instance per fold, two per fold and one
    call over all give the same leaves bit for bit (ragged slicings)."""
    _, cfg, _, _, params, _, _ = setup(PHI)
    rng = np.random.default_rng(9)
    xs = [torch.from_numpy(rng.normal(size=(5, cfg.d_model)).astype(
        np.float32)) for _ in range(cfg.n_experts)] * 2
    ws = list(params["layers"][0]["ffn"]["w1"]) \
        + list(params["layers"][1]["ffn"]["w1"])
    slicings = [(4, 2, 2), (4, 4), (4, 2, 2), (2, 2, 2, 2)] * 2
    R, C = ws[0].shape
    monkeypatch.setattr(pc, "FOLD_ELEMENTS", 1 << 40)
    one = pc._exact_prepare_stacked(ws, xs, slicings)
    for fold in (R * C, 2 * R * C):
        monkeypatch.setattr(pc, "FOLD_ELEMENTS", fold)
        got = pc._exact_prepare_stacked(ws, xs, slicings)
        for k in one:
            assert torch.equal(got[k], one[k]), (fold, k)


# -------------------------------------------------------------- logits
@pytest.mark.parametrize("arch,mode", [
    (PHI, "off"), (PHI, "fast"), (PHI, "exact"), (LLAMA4, "off")])
def test_logits_match_reference(arch, mode):
    """The port's prefill + decode on the reference's plans against the
    reference's forward, within ``_torch_parity.ATOL[mode]``."""
    rcfg, cfg, rparams, _, params, _, tokens = setup(arch)
    ref_plans = None if mode == "off" else compiled(arch, mode)[0].plans
    plans = None if ref_plans is None else convert.plans_from_reference(
        jax.tree.map(np.asarray, ref_plans), cfg, "cpu")
    got = P.run_port(dataclasses.replace(cfg, pim_mode=mode), params, plans,
                     tokens)
    want = P.run_ref(dataclasses.replace(rcfg, pim_mode=mode), rparams,
                     ref_plans, tokens)
    P.assert_logits_close(got, want, mode)


def _port_logits(arch: str, mode: str) -> np.ndarray:
    _, cfg, _, _, params, _, tokens = setup(arch)
    plans = None if mode == "off" else port_compiled(arch, mode).plans
    return P.run_port(dataclasses.replace(cfg, pim_mode=mode), params, plans,
                      tokens)


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_int8_equals_exact_in_port(arch):
    np.testing.assert_array_equal(_port_logits(arch, "int8"),
                                  _port_logits(arch, "exact"))


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_prefill_decode_equals_forward(arch):
    """Drop-free at the reduced configs' capacity 4.0, so the decode
    step's merged dispatch group routes every token as the full-sequence
    forward does."""
    _, cfg, _, _, params, _, tokens = setup(arch)
    with torch.no_grad():
        full = T.forward(params, cfg, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(_port_logits(arch, "off"),
                               full[:, P.PROMPT - 1:].numpy(),
                               atol=P.ATOL["off"], rtol=0)


# -------------------------------------------------------------- engines
def _requests(cfg, n=5):
    rng = np.random.default_rng(0)
    return [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size, p).astype(
        np.int32), max_new_tokens=m)
        for u, (p, m) in enumerate([(5, 4), (9, 2), (3, 5), (7, 3),
                                    (4, 4)][:n])]


@pytest.mark.parametrize("mode", ["off", "fast"])
def test_continuous_matches_lockstep(mode):
    """Greedy continuous batching (chunked prefill, slot reuse, the merged
    decode group) returns each request's solo lockstep tokens, bit for
    bit (the reference test of this name, on phi3.5-moe)."""
    _, cfg, _, _, params, _, _ = setup(PHI)
    cfg = dataclasses.replace(cfg, pim_mode=mode)
    plans = None if mode == "off" else port_compiled(PHI, mode).plans
    reqs = _requests(cfg)
    eng = ContinuousServeEngine(cfg, params, n_slots=2, max_len=32,
                                prefill_chunk=4, plans=plans)
    outs = eng.run(reqs)
    assert [o.uid for o in outs] == [r.uid for r in reqs]
    lock = ServeEngine(cfg, params, max_len=32, plans=plans)
    for r, o in zip(reqs, outs):
        want = lock.generate(r.prompt[None], steps=r.max_new_tokens)
        np.testing.assert_array_equal(o.tokens, want.tokens[0])
    assert eng.stats.completed == 5 and eng.stats.decode_utilization > 1.0


def test_paged_matches_continuous():
    """The paged engine on a pool that must evict returns the continuous
    engine's tokens, bit for bit (fast mode, same chunks)."""
    _, cfg, _, _, params, _, _ = setup(PHI)
    cfg = dataclasses.replace(cfg, pim_mode="fast")
    plans = port_compiled(PHI, "fast").plans
    rng = np.random.default_rng(4)
    reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size,
                                               9).astype(np.int32),
                    max_new_tokens=n) for u, n in enumerate([14, 8])]
    kw = dict(n_slots=2, max_len=24, prefill_chunk=16, plans=plans)
    eng = PagedServeEngine(cfg, params, block_size=4, n_blocks=6,
                           prefix_sharing=False, **kw)
    outs = eng.run(reqs)
    cont = ContinuousServeEngine(cfg, params, **kw).run(reqs)
    assert eng.stats.evictions >= 1 and eng.stats.blocks_in_use == 0
    for o, c in zip(outs, cont):
        np.testing.assert_array_equal(o.tokens, c.tokens)


@pytest.mark.parametrize("argv", [
    ["--pim", "off"], ["--pim", "int8"], ["--pim", "fast"],
    ["--pim", "exact", "--engine", "paged", "--blocks", "3"],
    ["--pim", "exact", "--pim-slicing", "adaptive", "--engine", "lockstep",
     "--requests", "2"]], ids=lambda a: "-".join(a).replace("--", ""))
def test_launcher_serves_moe_on_cpu(argv, capsys):
    launcher.main(["--arch", PHI, "--reduced", "--device", "cpu",
                   "--requests", "4", "--steps", "4"] + argv)
    out = capsys.readouterr().out
    assert "phi3.5-moe-42b-smoke" in out
    if "adaptive" in argv:
        assert "blocks[0].ffn.w2[r0,e3]" in out
