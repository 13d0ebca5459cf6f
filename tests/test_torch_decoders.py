"""The last three decoder configurations in the port against the reference:
chameleon-34b (qk-norm, GQA), qwen2.5-32b and qwen1.5-110b (GQA, QKV
bias), at ``reduced()`` size in float32 through ``_torch_parity``.

- Each config equals the reference's field for field, full size and
  ``reduced()``.
- chameleon-34b runs with seeded non-unit ``q_norm`` / ``k_norm`` scales
  (``_torch_parity.setup``), carried across with the other weights.
- chameleon-34b and qwen2.5-32b: plans held leaf by leaf (``fast``,
  ``exact``) and logits in all four ``pim_mode``s within the tolerances of
  ``_torch_parity``. qwen2.5-32b's ``reduced()`` twin has qwen1.5-110b's
  shapes, so qwen1.5-110b is held in ``exact`` alone.
- In the port, chameleon's ``int8`` logits equal its ``exact`` ones bit
  for bit at the 24b ADC, and its ``fast`` logits differ from the float
  ones while matching the reference's ``fast`` logits (the port's mirror of
  the reference's ``TestArchCoverage``, held to the reference's own values
  rather than to a bound on the distance from float).
- chameleon's teacher-forced prefill + decode equals its forward, and the
  paged cache equals the contiguous one bit for bit, in a float32 and an
  int8 KV cache; its int8-KV logits match the reference's.
- ``CompiledPim.report`` of the pinned exact compile equals the
  reference's dict.
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
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.models import transformer as T

CHAMELEON, QWEN25, QWEN110 = "chameleon-34b", "qwen2.5-32b", "qwen1.5-110b"
FULL = (CHAMELEON, QWEN25)   # plans and logits in every mode


@pytest.mark.parametrize("arch", [CHAMELEON, QWEN25, QWEN110])
def test_configs_compare_equal(arch):
    want, got = ref_configs.get(arch), configs.get(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())


def test_qk_norm_scales_carried_across():
    """The port's chameleon params hold the reference's seeded, non-unit
    qk-norm scales."""
    _, cfg, rparams, _, params, _, _ = P.setup(CHAMELEON)
    assert cfg.qk_norm
    for name in ("q_norm", "k_norm"):
        want = np.asarray(rparams["blocks"][0]["core"][name])
        assert want.shape == (cfg.n_layers, cfg.resolved_head_dim)
        assert np.abs(want - 1.0).min() > 0
        for layer in range(cfg.n_layers):
            np.testing.assert_array_equal(
                params["layers"][layer]["core"][name].numpy(), want[layer])


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("arch", FULL)
def test_plans_match_reference(arch, mode):
    P.check_plans(arch, mode)


@functools.lru_cache(maxsize=None)
def port_logits(arch: str, mode: str) -> np.ndarray:
    return P.port_logits(arch, mode)


@pytest.mark.parametrize("mode", P.MODES)
@pytest.mark.parametrize("arch", FULL)
def test_logits_match_reference(arch, mode):
    P.assert_logits_close(port_logits(arch, mode), P.ref_logits(arch, mode),
                          mode)


def test_qwen110b_exact_logits_match_reference():
    P.check_logits(QWEN110, "exact")


def test_int8_equals_exact_in_port():
    np.testing.assert_array_equal(port_logits(CHAMELEON, "int8"),
                                  port_logits(CHAMELEON, "exact"))


@pytest.mark.parametrize("arch", FULL)
def test_fast_reaches_every_projection(arch):
    """``fast`` moves the logits off the float ones (every projection and
    the head go through the centered int8 matmul); how far is held to the
    reference's own ``fast`` logits by ``test_logits_match_reference``."""
    assert np.abs(port_logits(arch, "fast") - port_logits(arch, "off")).max() \
        > 0


def ids(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_prefill_decode_matches_forward(kv_dtype):
    """Teacher-forced prefill of S - 2 tokens and 2 decode steps (the
    reference's ``test_prefill_decode_matches_forward``): with a float32
    cache the logits equal the forward's within ``P.ATOL["off"]``; through
    a scrambled paged table the same chunks give the contiguous cache's
    logits bit for bit, in either cache dtype."""
    _, cfg, _, _, params, _, tokens = P.setup(CHAMELEON)
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    toks = ids(tokens[:1, :8])
    split, S = 6, 8
    layout = T.PagedLayout(n_blocks=5, block_size=4)
    table = ids([3, 0])
    with torch.no_grad():
        full = T.forward(params, cfg, toks)
        lg, st = T.prefill(params, cfg, toks[:, :split], max_len=S)
        cont = [lg[:, -1]]
        pst = T.init_decode_state(cfg, 1, S, per_slot_pos=True, paged=layout,
                                  device="cpu")
        for lo, hi in [(0, 4), (4, split)]:
            plg, pst = T.prefill_chunk_paged(
                params, cfg, pst, toks[:, lo:hi], slot=0, table_row=table,
                pos0=lo, paged=layout)
        paged = [plg[:, -1]]
        cst = T.init_decode_state(cfg, 1, S, device="cpu")
        for lo, hi in [(0, 4), (4, split)]:
            clg, cst = T.prefill_chunk(params, cfg, cst, toks[:, lo:hi])
        chunked = [clg[:, -1]]
        for t in range(split, S):
            lg, st = T.decode_step(params, cfg, st, toks[:, t:t + 1])
            cont.append(lg[:, 0])
            clg, cst = T.decode_step(params, cfg, cst, toks[:, t:t + 1])
            chunked.append(clg[:, 0])
            plg, pst = T.decode_step(params, cfg, pst, toks[:, t:t + 1],
                                     block_tables=table[None], paged=layout)
            paged.append(plg[:, 0])
    for c, p in zip(chunked, paged):
        assert torch.equal(c, p)
    if kv_dtype == "float32":
        np.testing.assert_allclose(torch.stack(cont, 1).numpy(),
                                   full[:, split - 1:].numpy(),
                                   atol=P.ATOL["off"], rtol=0)


def test_int8_kv_logits_close_to_reference():
    """chameleon with an int8 KV cache (qk-norm before the cache's
    quantizer): chunked prefill + teacher-forced decode logits against the
    reference's within ``P.ATOL_INT8_KV``, argmax equal wherever the
    reference's top-2 margin exceeds twice that."""
    rcfg, cfg, rparams, _, params, _, tokens = P.setup(CHAMELEON)
    rcfg = dataclasses.replace(rcfg, kv_cache_dtype="int8")
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    chunks = [(0, 4), (4, P.PROMPT)]
    chunk = jax.jit(lambda p, st, t: RT.prefill_chunk(p, rcfg, st, t))
    dec = jax.jit(lambda p, st, t: RT.decode_step(p, rcfg, st, t))
    st = RT.init_decode_state(rcfg, 2, P.TOTAL)
    for lo, hi in chunks:
        lg, st = chunk(rparams, st, jnp.asarray(tokens[:, lo:hi]))
    want = [np.asarray(lg)]
    for t in range(P.PROMPT, P.TOTAL):
        lg, st = dec(rparams, st, jnp.asarray(tokens[:, t:t + 1]))
        want.append(np.asarray(lg))
    want = np.concatenate(want, axis=1)
    with torch.no_grad():
        st = T.init_decode_state(cfg, 2, P.TOTAL, device="cpu")
        for lo, hi in chunks:
            lg, st = T.prefill_chunk(params, cfg, st, ids(tokens[:, lo:hi]))
        got = [lg]
        for t in range(P.PROMPT, P.TOTAL):
            lg, st = T.decode_step(params, cfg, st, ids(tokens[:, t:t + 1]))
            got.append(lg)
    got = torch.cat(got, dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=P.ATOL_INT8_KV, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * P.ATOL_INT8_KV
    assert clear.any()
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_report_matches_reference():
    """The pinned exact compile's energy report, port against reference:
    every value a Python float or int, so the dicts are equal."""
    ref, port = P.compiled_pim(CHAMELEON, "exact")
    assert port.report(tokens=64) == ref.report(tokens=64)
    assert port.report() == ref.report()
