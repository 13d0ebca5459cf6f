"""The paged engine's disaggregated prefill/decode mode
(``PagedServeEngine(..., prefill_mesh=, decode_mesh=)``) on 4 ``gloo``
ranks: one spawn per module (``_torch_dist_workers.task_disagg``, a
``file://`` store, one intra-op thread each, no jax in the workers), slices
``(1, 1, 2)`` + ``(1, 1, 2)``, so that ranks 0 and 1 prefill and every
handoff reaches two decode ranks (2 and 3). This process computes the
port's one-process engines and the reference's values.

- Greedy tokens in ``off`` and in ``exact`` mode (plans from
  ``prepare_pim_params``, the kernels' plain versions on the CPU) equal the
  port's lockstep engine and its non-disaggregated paged engine bit for
  bit (reduced float32 yi-6b, ``_torch_parity.setup``); sampled requests
  replay the paged engine's streams; a pool that must evict gives the same
  tokens; reduced jamba-1.5-large-398b, mamba carries and attention K/V in
  one state, crosses the handoff.
- Every rank ends every run with the same ``ServeStats``, tables, free
  list, outputs and per-iteration decisions, its pool drained; with
  telemetry on, the same counters everywhere, the PIM work counters equal
  to the one-process engine's. The pool exists on decode ranks only and a
  staged B=1 state on prefill ranks only; the first prefill rank sends
  every handoff and both decode ranks receive them.
- Against the reference: the per-iteration decisions on one pressure
  trace equal those of the reference's disaggregated ``PagedServeEngine``
  on two ``(1, 1, 2)`` slices of the 8 fake devices; passing one mesh
  raises the reference's error. A rank in neither slice raises, and a
  first decode rank that misses an iteration makes every other rank fail
  on the groups' timeout instead of hanging.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.launch.mesh import make_disaggregated_meshes as ref_meshes
from repro.serve import paged as ref_paged
from repro.serve.scheduler import Request as RefRequest
from repro_torch import configs
from repro_torch.models import pim
from repro_torch.models import transformer as T
from repro_torch.obs import ServeTelemetry
from repro_torch.serve import PagedServeEngine, Request, ServeEngine

import _torch_dist_workers as W
from _torch_parity import one_thread, setup  # noqa: F401  (autouse fixture)

YI, JAMBA = "yi-6b", "jamba-1.5-large-398b"
BASE = dict(n_slots=2, max_len=32, prefill_chunk=4, block_size=4)
# two requests that need 11 blocks at their peak, on a pool of 6
EVICT = dict(n_slots=2, max_len=24, prefill_chunk=16, block_size=4,
             n_blocks=6, prefix_sharing=False)
# tests/test_torch_paged.py::test_engine_decisions_match_reference's pool
PRESSURE = dict(n_slots=3, max_len=16, prefill_chunk=4, block_size=4,
                n_blocks=6)
ROLES = ["prefill", "prefill", "decode", "decode"]


def mixed(vocab: int, n: int) -> list:
    rng = np.random.default_rng(0)
    plens, steps = [3, 7, 5, 9, 4], [6, 3, 9, 4, 7]
    return [Request(uid=i, prompt=rng.integers(0, vocab, plens[i]).astype(
        np.int32), max_new_tokens=steps[i]) for i in range(n)]


def sampled(vocab: int) -> list:
    rng = np.random.default_rng(1)
    return [Request(uid=u, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=m, temperature=t, seed=10 + u)
            for u, (n, m, t) in enumerate([(6, 7, 1.0), (5, 4, 0.0),
                                           (8, 6, 1.0)])]


def evicting(vocab: int) -> list:
    rng = np.random.default_rng(4)
    return [Request(uid=u, prompt=rng.integers(0, vocab, 9).astype(np.int32),
                    max_new_tokens=n, temperature=t, seed=10 + u)
            for u, (n, t) in enumerate([(14, 0.0), (8, 1.0)])]


def pressure(vocab: int) -> list:
    """The pressure trace of ``test_torch_paged.py``: a shared system
    prompt (no sharing here: a staged prefill shares no blocks)."""
    rng = np.random.default_rng(7)
    sys_prompt = rng.integers(0, vocab, 8).astype(np.int32)
    spec = [(sys_prompt, 2, 6), (sys_prompt, 3, 5), (None, 5, 6),
            (sys_prompt, 1, 4), (None, 6, 3)]
    return [Request(uid=u, prompt=np.concatenate(
        [p if p is not None else [], rng.integers(0, vocab, x)]).astype(
            np.int32), max_new_tokens=n) for u, (p, x, n) in enumerate(spec)]


def runs() -> dict:
    v = setup(YI)[1].vocab_size
    vj = configs.get(JAMBA).reduced().vocab_size
    return {
        "off": dict(arch=YI, mode="off", kw=BASE, requests=mixed(v, 5)),
        "exact": dict(arch=YI, mode="exact", kw=BASE, requests=mixed(v, 5),
                      telemetry=True),
        "sampled": dict(arch=YI, mode="off", kw=BASE, requests=sampled(v)),
        "evict": dict(arch=YI, mode="off", kw=EVICT, requests=evicting(v)),
        "jamba": dict(arch=JAMBA, mode="off", kw=BASE,
                      requests=mixed(vj, 4)),
        "pressure": dict(arch=YI, mode="off", kw=PRESSURE,
                         requests=pressure(v)),
    }


RUNS = tuple(runs())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of one spawn of 4 gloo processes."""
    _, _, _, np_params, _, calib, _ = setup(YI)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.spawn("disagg", 4, tmp_path_factory.mktemp("disagg"),
                       {"runs": runs(), "np_params": {YI: np_params},
                        "calib": calib})
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def one_process(run: str):
    """(cfg, params, plans) of a run, in this process."""
    r = runs()[run]
    if r["arch"] == YI:
        cfg, params, calib = setup(YI)[1], setup(YI)[4], setup(YI)[5]
    else:
        cfg = configs.get(JAMBA).reduced(dtype="float32",
                                         kv_cache_dtype="float32")
        params, calib = T.init_params(cfg, seed=0, device="cpu"), None
    cfg = dataclasses.replace(cfg, pim_mode=r["mode"])
    plans = (None if r["mode"] == "off"
             else pim.prepare_pim_params(params, cfg, calib))
    return cfg, params, plans


@functools.lru_cache(maxsize=None)
def paged_tokens(run: str) -> dict:
    """The one-process paged engine's tokens on the run's trace."""
    cfg, params, plans = one_process(run)
    r = runs()[run]
    outs = PagedServeEngine(cfg, params, plans=plans, **r["kw"]).run(
        r["requests"])
    return {o.uid: o.tokens for o in outs}


def lockstep_tokens(run: str) -> dict:
    """Each request alone through the lockstep engine (its seed's stream
    when sampled)."""
    cfg, params, plans = one_process(run)
    r = runs()[run]
    out = {}
    for q in r["requests"]:
        eng = ServeEngine(cfg, params, max_len=r["kw"]["max_len"],
                          plans=plans, temperature=q.temperature)
        out[q.uid] = eng.generate(q.prompt[None], steps=q.max_new_tokens,
                                  seed=q.seed).tokens[0]
    return out


def assert_tokens(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid {uid}")


def test_roles_and_no_jax_in_workers(ranks):
    assert [r["off"]["role"] for r in ranks] == ROLES
    assert all(r["jax_loaded"] == [] for r in ranks)


@pytest.mark.parametrize("run", ["off", "exact"])
def test_greedy_tokens_equal_lockstep_and_paged(ranks, run):
    want = lockstep_tokens(run)
    assert_tokens(paged_tokens(run), want)
    for r in ranks:
        assert_tokens(r[run]["tokens"], want)


def test_sampled_requests_replay_the_paged_stream(ranks):
    want = paged_tokens("sampled")
    assert_tokens(want, lockstep_tokens("sampled"))
    for r in ranks:
        assert_tokens(r["sampled"]["tokens"], want)


def test_evicting_pool_gives_the_same_tokens(ranks):
    want = lockstep_tokens("evict")
    assert_tokens(paged_tokens("evict"), want)
    for r in ranks:
        assert r["evict"]["stats"]["evictions"] >= 1
        assert_tokens(r["evict"]["tokens"], want)


def test_recurrent_state_crosses_the_handoff(ranks):
    cfg = one_process("jamba")[0]
    assert {"mamba", "attn"} <= set(cfg.block_pattern)
    want = lockstep_tokens("jamba")
    assert_tokens(paged_tokens("jamba"), want)
    for r in ranks:
        assert_tokens(r["jamba"]["tokens"], want)


@pytest.mark.parametrize("run", RUNS)
def test_every_rank_ends_with_one_host_state(ranks, run):
    first = ranks[0][run]
    for r in ranks[1:]:
        for key in ("stats", "tables", "free", "log", "reasons"):
            assert r[run][key] == first[key], key
    st = first["stats"]
    assert st["completed"] == len(runs()[run]["requests"])
    assert st["blocks_in_use"] == 0 and st["prefix_block_hits"] == 0
    assert len(first["free"]) == runs()[run]["kw"].get(
        "n_blocks", BASE["n_slots"] * BASE["max_len"] // BASE["block_size"])


@pytest.mark.parametrize("run", RUNS)
def test_state_lives_on_its_slice(ranks, run):
    """The pool on decode ranks, staged B=1 states on prefill ranks; every
    finished prompt (a requeued one again) is one handoff, sent by rank 0
    and received by ranks 2 and 3."""
    got = [r[run] for r in ranks]
    assert [g["pool"] for g in got] == [False, False, True, True]
    assert got[2]["staged"] == got[3]["staged"] == [False]
    n = len(runs()[run]["requests"]) + got[0]["stats"]["evictions"]
    assert [g["handoffs"] for g in got] == [n, 0, n, n]
    assert got[0]["handoff_bytes"] == got[2]["handoff_bytes"] \
        == got[3]["handoff_bytes"] > 0
    if runs()[run]["kw"]["prefill_chunk"] == 4:   # prompts span chunks
        assert True in got[0]["staged"] and True in got[1]["staged"]


def test_telemetry_fires_alike_on_every_rank(ranks):
    """The exact run with telemetry on every rank: equal counters, gauges
    and histogram counts everywhere; the PIM work counters (the decode
    rank's K2 totals, carried by the iteration's broadcast) equal the
    one-process paged engine's."""
    got = [r["exact"]["metrics"] for r in ranks]
    assert all(g == got[0] for g in got[1:])
    cfg, params, plans = one_process("exact")
    r = runs()["exact"]
    tel = ServeTelemetry(engine="paged")
    PagedServeEngine(cfg, params, plans=plans, telemetry=tel,
                     **r["kw"]).run(r["requests"])
    want = W.counts(tel)
    pim = [k for k in want if k.startswith("repro_pim_")]
    assert "repro_pim_spec_attempts_total" in pim
    assert want["repro_pim_spec_attempts_total"][0][1] > 0
    for k in pim + ["repro_serve_decode_steps_total",
                    "repro_serve_tokens_generated_total"]:
        assert got[0][k] == want[k], k


def test_decisions_match_reference(ranks):
    """The reference's disaggregated engine on two (1, 1, 2) slices of the
    fake devices and the port's on 4 ranks: the same admissions,
    evictions, admission waits and block tables at every iteration."""
    rcfg, _, rparams, _, _, _, _ = setup(YI)
    pm, dm = ref_meshes((1, 1, 2), (1, 1, 2))
    ref = ref_paged.PagedServeEngine(rcfg, rparams, prefill_mesh=pm,
                                     decode_mesh=dm, **PRESSURE)
    assert ref.staged_prefill and not ref.prefix_sharing
    for q in runs()["pressure"]["requests"]:
        ref.submit(RefRequest(uid=q.uid, prompt=q.prompt,
                              max_new_tokens=q.max_new_tokens))
    log = []
    while ref.has_work:
        log.append(W.decisions(ref, ref.step))
        assert len(log) < 200
    mine = ranks[0]["pressure"]["log"]
    assert len(mine) == len(log)
    for i, (a, b) in enumerate(zip(mine, log)):
        assert a == b, i
    st = ranks[0]["pressure"]["stats"]
    assert st["evictions"] >= 1 and st["admission_waits"] >= 1


def test_missed_iteration_fails_on_the_group_timeout(ranks):
    """Rank 2 (the first decode rank, the source of every iteration's
    broadcast) skips an iteration; ranks 0, 1 and 3 raise after the 3 s
    group timeout instead of hanging."""
    for rank in (0, 1, 3):
        t = ranks[rank]["timeout"]
        assert t["error"] is not None, rank
        assert 2.5 < t["seconds"] < 60, t


def test_rank_in_neither_slice_raises(ranks):
    """Slices (1, 1, 1) + (1, 1, 2) on 4 ranks leave rank 3 out."""
    assert [r["neither"] for r in ranks[:3]] == ["prefill", "decode",
                                                 "decode"]
    assert "neither the prefill nor the decode slice" in ranks[3]["neither"]


class _Slice:
    """A stand-in mesh: only its coordinate matters to the checks."""

    def __init__(self, inside: bool):
        self.inside = inside

    def get_coordinate(self):
        return [0, 0, 0] if self.inside else None


def test_one_process_errors():
    """One mesh without the other raises the reference's error; meshes
    that leave this rank out, or both claim it, raise before any group is
    opened."""
    rcfg, cfg, rparams, _, params, _, _ = setup(YI)
    kw = dict(max_len=32, block_size=4)
    with pytest.raises(ValueError, match="both prefill_mesh"):
        ref_paged.PagedServeEngine(rcfg, rparams, decode_mesh=object(), **kw)
    for one in (dict(decode_mesh=object()), dict(prefill_mesh=object())):
        with pytest.raises(ValueError, match="both prefill_mesh"):
            PagedServeEngine(cfg, params, **one, **kw)
    with pytest.raises(ValueError, match="neither the prefill"):
        PagedServeEngine(cfg, params, prefill_mesh=_Slice(False),
                         decode_mesh=_Slice(False), **kw)
    with pytest.raises(ValueError, match="overlap"):
        PagedServeEngine(cfg, params, prefill_mesh=_Slice(True),
                         decode_mesh=_Slice(True), **kw)
    assert not torch.distributed.is_initialized()
