"""The port's recurrent blocks (mamba and rwkv6) against the reference:
reduced float32 jamba-1.5-large-398b (its whole 8-layer pattern: mamba
layers, attention at position 3, MoE FFNs at the even positions) and
rwkv6-3b (two rwkv layers), the reference's weights carried across, plus
the reference's hybrid toy config for the projection sites and Algorithm 1
(attention + mamba + MoE, copied from ``tests/test_pim_adaptive.py``).

- Configs compare equal; the recurrence constants stay float32.
- ``models.ssm``'s mixers, decode steps and carries equal
  ``repro.models.ssm``'s; decode from scratch, token by token, equals the
  full-sequence forward, and the forward equals the reference's (float,
  ``ATOL["off"]``).
- ``prefill_chunk`` over three chunks equals ``prefill`` bit for bit:
  logits, every cache leaf (recurrent carries included) and the next
  decode step; the carries agree with the reference's ``prefill`` within
  ``ATOL_CARRY``.
- Logits in fast and exact mode on one set of plans against the
  reference's own outputs, within ``_torch_parity.ATOL`` (not the float
  bound the reference itself misses for jamba); int8 == exact in the port.
- The toy's sites: pinned exact plans equal the reference's
  ``compile_pim_params`` leaf for leaf; fed the reference's tapped
  activations, the site compilers give the same mamba leaves (fast and
  exact) and each mamba projection the reference's output, bit for bit;
  Algorithm 1 on the mamba sites makes the reference's choices with its
  errors.
- Reduced jamba's pinned fast and exact compiles, all 86 instances, equal
  the reference's site compiler fed the same activations, bit for bit.
- ``insert_request_paged`` == contiguous decode for rwkv6; the paged
  engine stages recurrent prefills and returns the lockstep engine's
  tokens, under eviction too; ``prefill_chunk_paged`` refuses them.
- The launcher serves both archs on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ArchConfig as RefArchConfig
from repro.models import layers as RL
from repro.models import pim_compile as ref_pc
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import serve as launcher
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import pim_compile as pc
from repro_torch.models import transformer as T
from repro_torch.serve import PagedServeEngine, Request, ServeEngine

import _torch_parity as P
from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

JAMBA, RWKV = "jamba-1.5-large-398b", "rwkv6-3b"
N_LAYERS = {JAMBA: 8, RWKV: 2}  # jamba: one repeat of its pattern
# recurrent carries after a 9-token float32 prefill, each framework's own:
# the same float32 ops summed in other orders (the scans run 9 steps)
ATOL_CARRY = 1e-5
MAMBA = ("in_proj", "x_proj", "out_proj")
# the reference's hybrid toy (tests/test_pim_adaptive.py::_hybrid_cfg):
# attention at position 0 with a 2-expert MoE FFN, mamba at position 1
TOY = dict(name="hybrid-toy", family="hybrid", n_layers=2, d_model=64,
           n_heads=2, n_kv_heads=1, head_dim=16, d_ff=144, vocab_size=64,
           n_experts=2, experts_per_token=1, moe_every=2,
           capacity_factor=4.0, block_pattern=("attn", "mamba"),
           mamba_d_state=8, remat=False, dtype="float32",
           kv_cache_dtype="float32")


def _ref_init(rcfg):
    """The reference's ``init_params`` under one ``jax.jit`` (the values
    of its eager call, one XLA compile instead of one per op)."""
    return jax.jit(lambda k: RT.init_params(rcfg, k)[0])(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def setup(arch: str):
    over = dict(dtype="float32", kv_cache_dtype="float32",
                n_layers=N_LAYERS[arch])
    rcfg = ref_configs.get(arch).reduced(**over)
    cfg = configs.get(arch).reduced(**over)
    rparams = _ref_init(rcfg)
    np_params = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    params = convert.params_from_reference(np_params, cfg, "cpu")
    calib = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, P.TOTAL)).astype(np.int32)
    return rcfg, cfg, rparams, np_params, params, calib, tokens


@functools.lru_cache(maxsize=None)
def port_compiled(arch: str, mode: str):
    _, cfg, _, _, params, calib, _ = setup(arch)
    return pc.compile_pim_params(
        params, dataclasses.replace(cfg, pim_mode=mode), calib)


def port_plans(arch: str, mode: str):
    return port_compiled(arch, mode).plans


def ref_layout(plans: dict, cfg) -> dict:
    """Port plans -> the reference's plan tree (leaves stacked over
    repeats per pattern position, None at an rwkv position)."""
    n_pat = len(cfg.block_pattern)
    blocks = []
    for i in range(n_pat):
        reps = [plans["layers"][r * n_pat + i] for r in range(cfg.n_repeats)]
        blocks.append(None if reps[0] is None else {
            g: {n: {k: jnp.asarray(np.stack([lp[g][n][k].numpy()
                                             for lp in reps]))
                    for k in leaf} for n, leaf in sub.items()}
            for g, sub in reps[0].items()})
    return {"embed": {"head": {k: jnp.asarray(v.numpy())
                               for k, v in plans["head"].items()}},
            "blocks": blocks}


def site_keys(sites) -> list:
    return [(s.site, s.slicing, s.d_in, s.d_out) for s in sites]


def assert_leaf_equal(got: dict, want: dict, xscale_rtol: float) -> None:
    """Every key of a plan leaf (reference layout) bit for bit, x_scale
    within ``xscale_rtol``."""
    assert set(got) == set(want)
    for k in got:
        if k == "x_scale":
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), rtol=xscale_rtol)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


def ids(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_configs_compare_equal(arch):
    for full in (True, False):
        r, c = ref_configs.get(arch), configs.get(arch)
        if not full:
            r, c = r.reduced(), c.reduced()
        assert dataclasses.asdict(r) == dataclasses.asdict(c)
    assert configs.get(arch).param_count() == ref_configs.get(
        arch).param_count()
    # bf16 params keep the reference's float32 leaves float32
    _, cfg, _, np_params, _, _, _ = setup(arch)
    p = convert.params_from_reference(
        np_params, dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    core = p["layers"][0]["core"]
    f32 = ("A_log", "D") if arch == JAMBA else ("decay_base", "bonus")
    assert all(core[k].dtype == torch.float32 for k in f32)
    assert core["x_proj" if arch == JAMBA else "wr"].dtype == torch.bfloat16


def test_embedding_inputs_run_forward_and_prefill():
    """An embeddings-mode rwkv6 config initializes (its unused embedding
    table kept), and ``forward`` and ``prefill`` take (B, S, D) frame
    embeddings, cast to ``cfg.dtype``; prefill's last logits equal the
    forward's."""
    cfg = dataclasses.replace(configs.get(RWKV).reduced(dtype="float32"),
                              input_mode="embeddings")
    params = T.init_params(cfg, device="cpu")
    assert params["embed"]["embed"].shape == (cfg.vocab_size, cfg.d_model)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 6, cfg.d_model))).to(torch.float64)
    with torch.no_grad():
        logits = T.forward(params, cfg, x)
        last, state = T.prefill(params, cfg, x, max_len=8)
    assert logits.shape == (2, 6, cfg.vocab_size)
    assert logits.dtype == torch.float32 and bool(logits.isfinite().all())
    np.testing.assert_allclose(last[:, 0].numpy(), logits[:, -1].numpy(),
                               atol=P.ATOL["off"], rtol=0)
    assert state["pos"] == 6


# ------------------------------------------------------ forward / decode
@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_decode_from_scratch_equals_forward(arch):
    """Pure decode from a zero state, token by token, equals the
    full-sequence forward (the reference test of this name); the forward
    equals the reference's."""
    rcfg, cfg, rparams, _, params, _, tokens = setup(arch)
    toks = ids(tokens)
    with torch.no_grad():
        full = T.forward(params, cfg, toks).numpy()
        st = T.init_decode_state(cfg, 2, P.TOTAL, device="cpu")
        steps = []
        for t in range(P.TOTAL):
            lg, st = T.decode_step(params, cfg, st, toks[:, t:t + 1])
            steps.append(lg)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full,
                               atol=P.ATOL["off"], rtol=0)
    want = P.run_ref(rcfg, rparams, None, tokens)
    np.testing.assert_allclose(full, want, atol=P.ATOL["off"], rtol=0)


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_block_functions_match_reference(arch):
    """``models.ssm`` against ``repro.models.ssm`` on layer 0's weights,
    float32: the full-sequence mixer over a random input, then one decode
    step from a random state (outputs and every new carry), and rwkv's
    channel-mix on the sequence."""
    from repro.models import ssm as RS
    from repro_torch.models import ssm as S
    rcfg, cfg, rparams, _, params, _, _ = setup(arch)
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"][0])
    p = params["layers"][0]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    init = S.init_mamba_state if arch == JAMBA else S.init_rwkv_state
    state = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in init(cfg, 2, "cpu").items()}
    t = {k: torch.from_numpy(v) for k, v in state.items()}
    j = {k: jnp.asarray(v) for k, v in state.items()}
    xt, xj, x1t, x1j = (torch.from_numpy(x), jnp.asarray(x),
                        torch.from_numpy(x1), jnp.asarray(x1))
    def ref(fn, *args):  # one XLA compile instead of one per op
        return jax.jit(lambda *a: fn(*a[:1], rcfg, *a[1:]))(*args)
    with torch.no_grad():
        if arch == JAMBA:
            pairs = [(S.mamba_block(p["core"], cfg, xt),
                      ref(RS.mamba_block, rp["core"], xj))]
            st, y = S.mamba_decode_step(p["core"], cfg, t, x1t)
            rst, ry = ref(RS.mamba_decode_step, rp["core"], j, x1j)
        else:
            pairs = [(S.rwkv_time_mix(p["core"], cfg, xt),
                      ref(RS.rwkv_time_mix, rp["core"], xj)),
                     (S.rwkv_channel_mix(p["ffn"], cfg, xt),
                      ref(RS.rwkv_channel_mix, rp["ffn"], xj))]
            st, y = S.rwkv_time_mix_decode(p["core"], cfg, t, x1t)
            rst, ry = ref(RS.rwkv_time_mix_decode, rp["core"], j, x1j)
    pairs += [(y, ry)] + [(st[k], rst[k]) for k in state]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=P.ATOL["off"], rtol=0)


def _chunked(params, cfg, prompt, plans):
    with torch.no_grad():
        lg, st = T.prefill(params, cfg, prompt, max_len=24, plans=plans)
        st2 = T.init_decode_state(cfg, 1, 24, device="cpu")
        for lo, hi in [(0, 4), (4, 8), (8, 9)]:
            lg2, st2 = T.prefill_chunk(params, cfg, st2, prompt[:, lo:hi],
                                       plans=plans)
    return lg, st, lg2, st2


@pytest.mark.parametrize("arch,mode", [(RWKV, "off"), (RWKV, "fast"),
                                       (JAMBA, "fast")])
def test_prefill_chunk_matches_prefill(arch, mode):
    """init_decode_state + prefill_chunk over (0,4), (4,8), (8,9) ==
    prefill, bit for bit: logits, every cache leaf (mamba h and conv, rwkv
    h, x_prev and cm_prev) and the next decode step (the reference test of
    this name). Jamba runs on fast plans: its float 'off' projections go
    through the CPU BLAS, which rounds a row by how many rows share it."""
    _, cfg, _, _, params, _, _ = setup(arch)
    cfg = dataclasses.replace(cfg, pim_mode=mode)
    plans = None if mode == "off" else port_plans(arch, mode)
    prompt = ids(np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                   (1, 9)))
    lg, st, lg2, st2 = _chunked(params, cfg, prompt, plans)
    assert torch.equal(lg, lg2)
    assert st["pos"] == st2["pos"] == 9
    for c, c2 in zip(st["caches"], st2["caches"]):
        assert set(c) == set(c2)
        for k in c:
            assert torch.equal(c[k], c2[k]), k
    tok = torch.argmax(lg[:, -1], -1)[:, None]
    with torch.no_grad():
        a = T.decode_step(params, cfg, st, tok, plans=plans)[0]
        b = T.decode_step(params, cfg, st2, tok, plans=plans)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_prefill_carries_match_reference(arch):
    """The recurrent carries and the logits after a 9-token prefill
    against the reference's ``prefill`` (float, each framework's own
    order of float32 sums)."""
    rcfg, cfg, rparams, _, params, _, _ = setup(arch)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 9))
    rlg, rst = jax.jit(lambda p, t: RT.prefill(p, rcfg, t, max_len=24))(
        rparams, jnp.asarray(prompt, jnp.int32))
    with torch.no_grad():
        lg, st = T.prefill(params, cfg, ids(prompt), max_len=24)
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg),
                               atol=P.ATOL["off"], rtol=0)
    n_pat = len(cfg.block_pattern)
    carries = 0
    for layer, cache in enumerate(st["caches"]):
        if T.block_kind(cfg, layer) == "attn":
            continue
        want = rst["caches"][layer % n_pat]
        for k, v in cache.items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(want[k])[layer // n_pat],
                atol=ATOL_CARRY, rtol=0, err_msg=f"layer {layer} {k}")
            carries += 1
    assert carries == (14 if arch == JAMBA else 6)


# -------------------------------------------------------------- logits
@functools.lru_cache(maxsize=None)
def port_logits(arch: str, mode: str) -> np.ndarray:
    _, cfg, _, _, params, _, tokens = setup(arch)
    return P.run_port(dataclasses.replace(cfg, pim_mode=mode), params,
                      port_plans(arch, mode), tokens)


@pytest.mark.parametrize("arch,mode", [(RWKV, "fast"), (RWKV, "exact"),
                                       (JAMBA, "fast"), (JAMBA, "exact")])
def test_logits_match_reference(arch, mode):
    """The port's prefill + decode against the reference's forward on the
    same plans (the port's compile, held to the reference's site compiler
    by ``test_jamba_sites_match_reference`` and the toy tests), within
    ``_torch_parity.ATOL[mode]``. Jamba's exact mode is held to the
    reference's int8 outputs on the int8 plans of the same calibration: the
    reference's pim_mode contract makes its exact outputs equal those at
    the 24b ADC (``tests/test_pim_contract.py``), and its exact forward over
    86 sites costs ~80 s of XLA compile here."""
    rcfg, cfg, rparams, _, _, _, tokens = setup(arch)
    ref_mode = "int8" if (arch, mode) == (JAMBA, "exact") else mode
    got = port_logits(arch, mode)
    want = P.run_ref(dataclasses.replace(rcfg, pim_mode=ref_mode), rparams,
                     ref_layout(port_plans(arch, ref_mode), cfg), tokens)
    P.assert_logits_close(got, want, mode)


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_int8_equals_exact_in_port(arch):
    np.testing.assert_array_equal(port_logits(arch, "int8"),
                                  port_logits(arch, "exact"))


# ------------------------------------------------------- toy sites
@functools.lru_cache(maxsize=None)
def toy():
    """(reference cfg, port cfg, reference params, port params, calib,
    the reference's taps of its calibration forward)."""
    rcfg, cfg = RefArchConfig(**TOY), ArchConfig(**TOY)
    rparams = _ref_init(rcfg)
    np_params = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    params = convert.params_from_reference(np_params, cfg, "cpu")
    calib = np.array(jax.random.randint(
        jax.random.key(2), (2, 8), 0, cfg.vocab_size), np.int32)
    taps = ref_pc._build_taps(rcfg)
    ref_pc._capture(rparams, rcfg, calib, taps)
    return rcfg, cfg, rparams, params, calib, taps


@functools.lru_cache(maxsize=None)
def toy_exact():
    """(reference, port) ``compile_pim_params`` of the toy, pinned exact."""
    rcfg, cfg, rparams, params, calib, _ = toy()
    return (ref_pc.compile_pim_params(
                rparams, dataclasses.replace(rcfg, pim_mode="exact"), calib),
            pc.compile_pim_params(
                params, dataclasses.replace(cfg, pim_mode="exact"), calib))


def test_toy_sites_match_reference():
    """Pinned exact plans: every site of the port's compile (attention, MoE
    experts, mamba, dense FFN, head) equals the reference's
    ``compile_pim_params`` leaf for leaf (x_scale to a few ulp from each
    framework's own capture)."""
    _, cfg, _, _, _, _ = toy()
    ref, port = toy_exact()
    assert site_keys(port.sites) == site_keys(ref.sites)
    assert len(port.sites) == 17
    got = ref_layout(port.plans, cfg)
    assert_leaf_equal(got["embed"]["head"], ref.plans["embed"]["head"], 2e-6)
    for i in range(2):
        for g, leaves in ref.plans["blocks"][i].items():
            for n, want in leaves.items():
                assert_leaf_equal(got["blocks"][i][g][n], want, 2e-6)


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_mamba_projections_match_reference(mode):
    """Fed the reference's tapped activations, each framework's site
    compiler gives the same mamba leaves, and each mamba projection's
    ``pim_matmul`` on them returns the reference's output, bit for bit
    (fast: the K3 path; exact: K2's)."""
    rcfg, cfg, rparams, _, _, taps = toy()
    rc, c = (dataclasses.replace(a, pim_mode=mode) for a in (rcfg, cfg))
    for n in MAMBA:
        name = f"blocks[1].core.{n}"
        w = np.array(rparams["blocks"][1]["core"][n], np.float32)
        x = np.stack(taps["blocks"][1]["core"][n].x)
        if mode == "exact":  # compile_pim_params ran the same capture
            want = toy_exact()[0].plans["blocks"][1]["core"][n]
        else:
            want, _ = ref_pc._compile_site(name, w, x, rc, stack_dims=1)
        leaf, _ = pc._compile_site(name, [torch.from_numpy(w[0])],
                                   [torch.from_numpy(x[0])], c)
        for k, v in leaf.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
        y = L.pim_matmul(torch.from_numpy(x[0]), torch.from_numpy(w[0]),
                         {k: v[0] for k, v in leaf.items()}, c)
        y_ref = jax.jit(lambda xx, ww, pl: RL.pim_matmul(xx, ww, pl, rc))(
            x[0], w[0], jax.tree.map(lambda a: a[0], want))
        np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


def test_adaptive_mamba_sites_match_reference():
    """Algorithm 1 on the toy's mamba sites through each framework's site
    compiler, on the reference's taps: slicings, measured errors and every
    exact leaf equal; the port's whole adaptive compile names the
    reference's 17 sites, measures each and keeps the head conservative."""
    rcfg, cfg, rparams, params, calib, taps = toy()
    over = dict(pim_mode="exact", pim_weight_slicing="adaptive")
    rc, c = (dataclasses.replace(a, **over) for a in (rcfg, cfg))
    chosen = set()
    for n in MAMBA:
        name = f"blocks[1].core.{n}"
        w = np.array(rparams["blocks"][1]["core"][n], np.float32)
        x = np.stack(taps["blocks"][1]["core"][n].x)
        want, want_sites = ref_pc._compile_site(name, w, x, rc, stack_dims=1)
        leaf, sites = pc._compile_site(name, [torch.from_numpy(w[0])],
                                       [torch.from_numpy(x[0])], c)
        assert [(s.site, s.slicing, s.error) for s in sites] == \
            [(s.site, s.slicing, s.error) for s in want_sites]
        for k, v in leaf.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
        chosen.add(sites[0].slicing)
    assert len(chosen) >= 2  # the search lands on different slicings
    whole = pc.compile_pim_params(params, c, calib)
    assert [s.site for s in whole.sites] == \
        [s.site for s in toy_exact()[0].sites]
    assert all(s.error is not None for s in whole.sites)
    assert whole.site("embed.head").slicing == pc.CONSERVATIVE_SLICING


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_jamba_sites_match_reference(mode):
    """Reduced jamba's pinned compile, all 86 instances (mamba sites,
    per-(repeat, expert) MoE sites, attention, dense FFN, head): fed the
    port's calibration activations, the reference's site compiler
    (``_compile_site``, per site as its ``compile_pim_params`` loops)
    gives the port's sites and every leaf, x_scale included, bit for bit.
    The activations are held to the reference's by the forward and carry
    tests above. The reference's whole ``compile_pim_params`` would add
    its eager capture and ``plan_specs``, ~18 s of XLA compiles, to a file
    held to 90 s."""
    rcfg, cfg, rparams, _, params, calib, _ = setup(JAMBA)
    rc, c = (dataclasses.replace(a, pim_mode=mode) for a in (rcfg, cfg))
    n_pat = len(cfg.block_pattern)
    taps = {"head": L.PimTap(), "layers": [
        None if p is None else pc._taps(p)
        for p in (pc._block_projections(cfg, l % n_pat)
                  for l in range(cfg.n_layers))]}
    with torch.no_grad():
        pc._capture(params, c, ids(calib), taps)
    port = port_compiled(JAMBA, mode)
    got = ref_layout(port.plans, cfg)
    sites = []
    for i, rb in enumerate(rparams["blocks"]):
        paths = ref_pc._block_projections(rcfg, i)
        for g, names in (paths or {}).items():
            expert = g == "ffn" and rcfg.moe_layer(i)
            for n in names:
                x = np.stack([taps["layers"][l][g][n].x[0].numpy()
                              for l in range(i, cfg.n_layers, n_pat)])
                want, more = ref_pc._compile_site(
                    f"blocks[{i}].{g}.{n}", rb[g][n], x, rc,
                    stack_dims=2 if expert else 1)
                assert_leaf_equal(got["blocks"][i][g][n], want, 0)
                sites += more
    want, more = ref_pc._compile_site(
        "embed.head", rparams["embed"]["head"],
        taps["head"].x[0].numpy(), rc, stack_dims=0, last_layer=True)
    assert_leaf_equal(got["embed"]["head"], want, 0)
    assert site_keys(port.sites) == site_keys(sites + more)
    assert len(port.sites) == 86


# -------------------------------------------------------------- paged
def test_insert_request_paged_matches_contiguous_decode():
    """A contiguous B=1 rwkv6 prefill handed to slot 1 of a paged state
    decodes as the same prefill spliced into a contiguous batched state
    (the staged-admission primitive: the carries ride along; batches of 2
    on both sides)."""
    _, cfg, _, _, params, _, _ = setup(RWKV)
    with torch.no_grad():
        logits, one = T.prefill(params, cfg, ids(np.arange(2, 9)[None]),
                                max_len=16)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        toks = torch.cat([torch.zeros((1, 1), dtype=torch.int64), tok])
        layout = T.PagedLayout(n_blocks=9, block_size=4)
        st = T.init_decode_state(cfg, 2, 16, per_slot_pos=True,
                                 paged=layout, device="cpu")
        table = ids([4, 1, 7, 0])
        st = T.insert_request_paged(st, one, 1, table, layout)
        assert st["pos"].tolist() == [0, 7]
        cont = T.insert_request(T.init_decode_state(
            cfg, 2, 16, per_slot_pos=True, device="cpu"), one, 1)
        for c, c1 in zip(st["caches"], one["caches"]):
            for k in c:
                assert torch.equal(c[k][1], c1[k][0])
        ref = T.decode_step(params, cfg, cont, toks)[0]
        tables = torch.stack([torch.full((4,), layout.sentinel), table])
        out, _ = T.decode_step(params, cfg, st, toks, block_tables=tables,
                               paged=layout)
    assert torch.equal(out[1], ref[1])


def _requests(cfg, plens=(3, 7, 5, 9, 4), steps=(6, 3, 9, 4, 7)):
    rng = np.random.default_rng(0)
    return [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size, p).astype(
        np.int32), max_new_tokens=m) for u, (p, m) in enumerate(zip(plens,
                                                                   steps))]


def _lockstep(cfg, params, plans, reqs, max_len):
    eng = ServeEngine(cfg, params, max_len=max_len, plans=plans)
    return {r.uid: eng.generate(r.prompt[None], steps=r.max_new_tokens)
            .tokens[0] for r in reqs}


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_paged_engine_matches_lockstep(arch):
    """Recurrent patterns stage their prefill at B=1 (no prefix sharing)
    and the paged engine returns each request's solo lockstep tokens, bit
    for bit (fast plans; the reference test of this name)."""
    _, cfg, _, _, params, _, _ = setup(arch)
    cfg = dataclasses.replace(cfg, pim_mode="fast")
    plans = port_plans(arch, "fast")
    reqs = _requests(cfg)
    eng = PagedServeEngine(cfg, params, n_slots=2, max_len=32,
                           prefill_chunk=4, block_size=4, plans=plans)
    assert eng.staged_prefill and not eng.prefix_sharing
    outs = eng.run(reqs)
    refs = _lockstep(cfg, params, plans, reqs, 32)
    for o in outs:
        np.testing.assert_array_equal(o.tokens, refs[o.uid])
    assert eng.stats.completed == 5 and eng.stats.blocks_in_use == 0


def test_paged_eviction_reprefills_recurrent_request():
    """On a pool that must evict, the evicted rwkv6 request prefills again
    from scratch and every request still gets its lockstep tokens."""
    _, cfg, _, _, params, _, _ = setup(RWKV)
    cfg = dataclasses.replace(cfg, pim_mode="fast")
    plans = port_plans(RWKV, "fast")
    reqs = _requests(cfg, plens=(9, 9), steps=(14, 8))
    eng = PagedServeEngine(cfg, params, n_slots=2, max_len=24,
                           prefill_chunk=16, block_size=4, n_blocks=6,
                           plans=plans)
    outs = eng.run(reqs)
    refs = _lockstep(cfg, params, plans, reqs, 24)
    assert eng.stats.evictions >= 1 and eng.stats.blocks_in_use == 0
    assert eng.stats.prefill_chunks > len(reqs)  # the victim prefilled again
    for o in outs:
        np.testing.assert_array_equal(o.tokens, refs[o.uid])


def test_prefill_chunk_paged_refuses_recurrent_patterns():
    _, cfg, _, _, params, _, _ = setup(JAMBA)
    layout = T.PagedLayout(n_blocks=4, block_size=4)
    st = T.init_decode_state(cfg, 1, 16, per_slot_pos=True, paged=layout,
                             device="cpu")
    with pytest.raises(ValueError, match="insert_request_paged"):
        T.prefill_chunk_paged(params, cfg, st, ids([[1, 2]]), slot=0,
                              table_row=ids([0, 1, 2, 3]), pos0=0,
                              paged=layout)


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("argv", [
    ["--arch", RWKV, "--pim", "exact"],
    ["--arch", RWKV, "--pim", "exact", "--pim-slicing", "adaptive",
     "--engine", "lockstep", "--requests", "2"],
    ["--arch", JAMBA, "--engine", "paged"],
    ["--arch", JAMBA, "--pim", "fast", "--engine", "paged", "--blocks", "2"]],
    ids=lambda a: "-".join(a).replace("--", ""))
def test_launcher_serves_recurrent_on_cpu(argv, capsys):
    launcher.main(["--reduced", "--device", "cpu", "--requests", "4",
                   "--steps", "4"] + argv)
    out = capsys.readouterr().out
    assert f"{argv[1]}-smoke" in out
    if "paged" in argv:
        assert "block pool:" in out
    if "adaptive" in argv:  # rwkv6: the head is the one crossbar site
        assert "embed.head" in out and "1 sites" in out


@pytest.mark.parametrize("layer", [0, 1, 3])
def test_compile_layer_matches_compile_pim_params(layer):
    """One layer compiled alone on the activations the model feeds it
    gives the whole-model compile's plans for that layer bit for bit: a
    mamba layer with MoE experts (0), one with a dense FFN (1) and the
    attention layer (3), pinned exact."""
    _, cfg, _, _, params, calib, _ = setup(JAMBA)
    cfg = dataclasses.replace(cfg, pim_mode="exact")
    x = T.embed_inputs(params, cfg, ids(calib))
    positions = torch.arange(x.shape[1]).expand(x.shape[0], x.shape[1])
    with torch.no_grad():
        for bp, lay in zip(params["layers"][:layer], range(layer)):
            x = T.apply_block(bp, cfg, lay, x, positions)
    one = pc.compile_layer(params["layers"][layer], cfg, layer, x)
    whole = port_plans(JAMBA, "exact")["layers"][layer]
    assert set(one.plans) == set(whole) == {"core", "ffn"}
    for g in whole:
        assert list(one.plans[g]) == list(whole[g])
        for n in whole[g]:
            for k, v in whole[g][n].items():
                assert torch.equal(one.plans[g][n][k], v), (g, n, k)
    assert all(s.site.startswith(f"blocks[{layer}].") for s in one.sites)
