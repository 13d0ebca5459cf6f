"""The port's paged KV engine and int8 KV cache (reduced float32 yi-6b on
the CPU, through ``_torch_parity.setup``).

Port against port, bit for bit: paged prefill/decode and the paged insert
against the contiguous cache, for float32 and int8 KV; the paged engine
against the lockstep engine (greedy in ``off`` and ``exact`` mode, greedy
and sampled under eviction) and against the continuous engine under an
int8 KV cache; prefix-sharing refcounts, FIFO admission waits, blocks
freed on a stop token, argument and engine validation.

Port against the reference: ``_quantize_kv`` codes and scales (ties at
.5 and an all-zero row included), a ``BlockAllocator`` pair driven by one
seeded operation sequence, the two ``PagedServeEngine``s' per-iteration
decisions on one pressure trace with a shared prefix, and int8-KV logits
within ``_torch_parity.ATOL_INT8_KV``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro.serve import paged as ref_paged
from repro.serve.scheduler import Request as RefRequest
from repro_torch.models import pim
from repro_torch.models import transformer as T
from repro_torch.serve import (
    BlockAllocator,
    ContinuousServeEngine,
    EngineStats,
    PagedServeEngine,
    Request,
    ServeEngine,
    ServeStats,
)

from _torch_parity import (  # noqa: F401  one_thread: an autouse fixture
    ATOL_INT8_KV, PROMPT, TOTAL, one_thread, setup)


def model(kv_dtype: str = "float32", mode: str = "off"):
    """(cfg, params, plans) of the reduced float32 yi-6b."""
    _, cfg, _, _, params, calib, _ = setup("yi-6b")
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype, pim_mode=mode)
    plans = None if mode == "off" else pim.prepare_pim_params(params, cfg,
                                                              calib)
    return cfg, params, plans


def mixed_requests(cfg, n=5, seed=0, **overrides):
    rng = np.random.default_rng(seed)
    plens = [3, 7, 5, 9, 4, 6, 8][:n]
    steps = [6, 3, 9, 4, 7, 2, 5][:n]
    return [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        plens[i]).astype(np.int32),
                    max_new_tokens=steps[i], **overrides)
            for i in range(n)]


def lockstep_refs(cfg, params, reqs, max_len, plans=None):
    """Each request alone through the lockstep engine, its seed's stream
    when sampled."""
    out = {}
    for r in reqs:
        eng = ServeEngine(cfg, params, max_len=max_len, plans=plans,
                          temperature=r.temperature)
        out[r.uid] = eng.generate(r.prompt[None, :], steps=r.max_new_tokens,
                                  seed=r.seed).tokens[0]
    return out


def assert_matches(outs, refs):
    for o in outs:
        np.testing.assert_array_equal(o.tokens, refs[o.uid],
                                      err_msg=f"uid {o.uid}")


def ids(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


# ----------------------------------------------------------- model layer
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_prefill_decode_matches_contiguous(kv_dtype):
    """prefill_chunk_paged + block-table decode == contiguous prefill_chunk
    + decode with the same chunks, bit for bit, through a scrambled block
    table over a pool full of finite garbage."""
    cfg, params, _ = model(kv_dtype)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 9))
    chunks = [(0, 4), (4, 8), (8, 9)]
    with torch.no_grad():
        st_ref = T.init_decode_state(cfg, 1, 16, device="cpu")
        for lo, hi in chunks:
            logits_ref, st_ref = T.prefill_chunk(params, cfg, st_ref,
                                                 ids(prompt[:, lo:hi]))
        layout = T.PagedLayout(n_blocks=7, block_size=4)   # 4 of 7 used
        st = T.init_decode_state(cfg, 1, 16, per_slot_pos=True,
                                 paged=layout, device="cpu")
        for c in st["caches"]:       # garbage the kv_len mask must hide
            for leaf in c.values():
                leaf += 7
        table = ids([5, 2, 6, 0])                          # scrambled
        for lo, hi in chunks:
            logits, st = T.prefill_chunk_paged(
                params, cfg, st, ids(prompt[:, lo:hi]), slot=0,
                table_row=table, pos0=lo, paged=layout)
        assert torch.equal(logits_ref[:, -1], logits[:, -1])
        assert st["pos"].tolist() == [9]
        tok = torch.argmax(logits_ref[:, -1], -1)[:, None]
        l_ref, _ = T.decode_step(params, cfg, st_ref, tok)
        l_pg, st = T.decode_step(params, cfg, st, tok,
                                 block_tables=table[None], paged=layout)
    assert torch.equal(l_ref, l_pg)
    assert st["pos"].tolist() == [10]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_insert_request_paged_matches_contiguous_decode(kv_dtype):
    """A contiguous B=1 prefill scattered into pool blocks decodes as the
    same prefill spliced into a contiguous batched state does (the
    staged-admission primitive; both batches of 2, since a CPU matmul may
    round a batch of 1 differently)."""
    cfg, params, _ = model(kv_dtype)
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
        ref = T.decode_step(params, cfg, cont, toks)[0]
        tables = torch.stack([torch.full((4,), layout.sentinel), table])
        out, _ = T.decode_step(params, cfg, st, toks, block_tables=tables,
                               paged=layout)
    assert torch.equal(out[1], ref[1])


def test_decode_step_paged_arg_validation():
    cfg, params, _ = model()
    layout = T.PagedLayout(n_blocks=4, block_size=4)
    st = T.init_decode_state(cfg, 1, 16, per_slot_pos=True, paged=layout,
                             device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="block_tables"):
        T.decode_step(params, cfg, st, tok, paged=layout)
    with pytest.raises(ValueError, match="per_slot_pos"):
        T.decode_step(params, cfg, T.init_decode_state(cfg, 1, 16,
                                                       device="cpu"), tok,
                      block_tables=torch.zeros((1, 4), dtype=torch.int64),
                      paged=layout)
    hybrid = dataclasses.replace(cfg, block_pattern=("attn", "mamba"),
                                 n_layers=2)
    with pytest.raises(ValueError, match="attention-only"):
        T.prefill_chunk_paged(params, hybrid, st, tok, slot=0,
                              table_row=ids([0, 1, 2, 3]), pos0=0,
                              paged=layout)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("mode", ["off", "exact"])
def test_paged_engine_matches_lockstep(mode):
    """Greedy paged-engine outputs equal solo lockstep runs bit for bit,
    and draining returns every block."""
    cfg, params, plans = model(mode=mode)
    reqs = mixed_requests(cfg)
    eng = PagedServeEngine(cfg, params, n_slots=2, max_len=32,
                           prefill_chunk=4, block_size=4, plans=plans)
    outs = eng.run(reqs)
    assert_matches(outs, lockstep_refs(cfg, params, reqs, 32, plans))
    assert eng.stats.completed == 5
    assert eng.stats.blocks_in_use == 0          # block-granular free
    assert eng.stats.peak_blocks_in_use > 0
    assert len(eng.alloc.free) == eng.alloc.n_blocks


def test_paged_engine_matches_continuous_int8_kv():
    """Under an int8 KV cache chunked prefill rounds the cache at every
    chunk boundary, so the paged engine is held to the continuous engine
    with the same chunking; prefix sharing is off."""
    cfg, params, _ = model("int8")
    reqs = mixed_requests(cfg)
    eng = PagedServeEngine(cfg, params, n_slots=2, max_len=32,
                           prefill_chunk=4, block_size=4)
    assert eng.prefix_sharing is False
    outs = eng.run(reqs)
    cont = ContinuousServeEngine(cfg, params, n_slots=2, max_len=32,
                                 prefill_chunk=4).run(reqs)
    assert_matches(outs, {o.uid: o.tokens for o in cont})


def test_prefix_sharing_refcounts():
    """A live request's full prompt blocks register for sharing; later
    admissions with the same system prompt claim them by refcount, and
    draining returns the pool with an empty prefix index."""
    cfg, params, _ = model()
    sys_prompt = np.arange(1, 9, dtype=np.int32)       # 2 full blocks
    rng = np.random.default_rng(2)
    reqs = [Request(uid=u, prompt=np.concatenate(
                [sys_prompt,
                 rng.integers(0, cfg.vocab_size, x).astype(np.int32)]),
                max_new_tokens=s)
            for u, (x, s) in enumerate([(3, 6), (5, 4), (2, 5)])]
    eng = PagedServeEngine(cfg, params, n_slots=3, max_len=32,
                           prefill_chunk=4, block_size=4)
    assert eng.prefix_sharing
    eng.submit(reqs[0])
    while not eng.alloc.prefix_index:                  # until uid 0 is live
        eng.step()
    shared = list(eng.alloc.prefix_index.values())
    assert len(shared) == 2
    eng.submit(reqs[1])
    eng.submit(reqs[2])
    eng.step()                                         # both admitted
    assert [int(eng.alloc.refcount[b]) for b in shared] == [3, 3]
    assert eng.stats.prefix_block_hits == 4            # 2 blocks x 2 reqs
    outs = eng.run([])
    assert_matches(outs, lockstep_refs(cfg, params, reqs, 32))
    assert eng.stats.blocks_in_use == 0
    assert not eng.alloc.prefix_index                  # unregistered on free


def test_admission_waits_under_memory_pressure():
    """With a pool too small for two prompts the head of the queue waits
    (strict FIFO), is admitted once blocks free, and every output still
    matches lockstep."""
    cfg, params, _ = model()
    rng = np.random.default_rng(3)
    reqs = [Request(uid=u,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        9).astype(np.int32),
                    max_new_tokens=3) for u in range(3)]
    eng = PagedServeEngine(cfg, params, n_slots=3, max_len=16,
                           prefill_chunk=16, block_size=4, n_blocks=4,
                           prefix_sharing=False)      # one request at a time
    for r in reqs:
        eng.submit(r)
    admitted_order, outs = [], []
    while eng.has_work:
        before = set(eng.active_uids)
        outs.extend(eng.step())
        admitted_order += [u for u in eng.active_uids if u not in before]
    assert admitted_order == [0, 1, 2]                 # FIFO held
    assert eng.stats.admission_waits > 0
    assert eng.stats.evictions == 0                    # waiters, not victims
    assert_matches(outs, lockstep_refs(cfg, params, reqs, 16))
    assert eng.stats.blocks_in_use == 0


def test_blocks_free_on_stop_token():
    """A stop token frees the slot's blocks the same iteration."""
    cfg, params, _ = model()
    [req] = mixed_requests(cfg, n=1)
    [full] = PagedServeEngine(cfg, params, n_slots=1, max_len=32,
                              prefill_chunk=8, block_size=4).run([req])
    stop = int(full.tokens[2])
    eng = PagedServeEngine(cfg, params, n_slots=1, max_len=32,
                           prefill_chunk=8, block_size=4)
    eng.submit(dataclasses.replace(req, stop_tokens=(stop,)))
    outs = []
    while eng.has_work:
        done = eng.step()
        if done:
            assert done[0].finish_reason == "stop"
            assert eng.stats.blocks_in_use == 0       # freed this iteration
            outs += done
    first = int(np.argmax(full.tokens == stop))
    np.testing.assert_array_equal(outs[0].tokens, full.tokens[:first + 1])
    assert eng.stats.peak_blocks_in_use >= 1
    assert len(eng.alloc.free) == eng.alloc.n_blocks


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_eviction_recompute_matches_lockstep(temperature):
    """Pool exhaustion mid-decode preempts the youngest request; its
    recompute replays the lockstep tokens — greedy, or sampled from a
    stream that restarts at the request's seed."""
    cfg, params, _ = model()
    rng = np.random.default_rng(4)
    reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size,
                                               9).astype(np.int32),
                    max_new_tokens=n, temperature=temperature, seed=10 + u)
            for u, n in enumerate([14, 8])]
    eng = PagedServeEngine(cfg, params, n_slots=2, max_len=24,
                           prefill_chunk=16, block_size=4, n_blocks=6,
                           prefix_sharing=False)
    outs = eng.run(reqs)
    assert eng.stats.evictions >= 1
    assert_matches(outs, lockstep_refs(cfg, params, reqs, 24))
    assert eng.stats.blocks_in_use == 0


def test_engine_validation():
    cfg, params, _ = model()
    with pytest.raises(ValueError, match="divide"):
        PagedServeEngine(cfg, params, max_len=30, block_size=4)
    with pytest.raises(ValueError, match="never fit"):
        PagedServeEngine(cfg, params, max_len=32, block_size=4, n_blocks=4)
    with pytest.raises(ValueError, match="n_slots"):
        PagedServeEngine(cfg, params, n_slots=0, max_len=32, block_size=4,
                         n_blocks=8)
    with pytest.raises(ValueError, match="compiled plans"):
        PagedServeEngine(dataclasses.replace(cfg, pim_mode="exact"), params,
                         max_len=32, block_size=4)


def test_servestats_defaults_and_alias():
    st = ServeStats()
    assert st.decode_utilization == 0.0
    assert st.blocks_in_use == st.evictions == st.prefix_block_hits == 0
    assert st.admission_waits == st.peak_blocks_in_use == 0
    assert EngineStats is ServeStats


def test_block_allocator_unit():
    alloc = BlockAllocator(4, 2)
    a, b = alloc.alloc(2)
    assert alloc.blocks_in_use == 2
    alloc.register(a, alloc.prefix_key(np.asarray([1, 2, 3, 4]), 0))
    prompt = np.asarray([1, 2, 9], np.int32)
    assert alloc.match_prefix(prompt) == [a]
    alloc.claim(a)
    alloc.release(a)
    assert alloc.match_prefix(prompt) == [a]           # still refcounted
    alloc.release(a)
    assert alloc.match_prefix(prompt) == []            # unregistered
    alloc.release(b)
    assert alloc.blocks_in_use == 0
    with pytest.raises(RuntimeError, match="pool exhausted"):
        alloc.alloc(5)
    with pytest.raises(RuntimeError, match="double free"):
        alloc.release(b)


# ----------------------------------------------------- against reference
def test_quantize_kv_matches_reference():
    """Equal int8 codes and float32 scales on one numpy input: random
    rows, rows whose quotients land on .5 (round half to even in both),
    and an all-zero row (the 1e-8 scale floor)."""
    rng = np.random.default_rng(5)
    t = rng.normal(size=(3, 5, 2, 16)).astype(np.float32)
    t[0, 0, 0] = np.arange(-8, 8) + 0.5      # ties around zero ...
    t[0, 0, 0, 0] = 127.0                    # ... at scale exactly 1
    t[0, 1, 1] = np.linspace(-63.5, 63.5, 16)  # scale 0.5, x.25 steps
    t[1, 2, 0] = 0.0                         # all zero
    t[2, 4, 1] = [2.5, -2.5, 3.5, -3.5] * 3 + [127.0, 0.5, -0.5, 1.5]
    q, s = T._quantize_kv(torch.from_numpy(t))
    rq, rs = RT._quantize_kv(jnp.asarray(t))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q[0, 0, 0, 1:4].tolist() == [-6, -6, -4]  # -6.5 -5.5 -4.5
    assert float(s[1, 2, 0]) == np.float32(1e-8)
    for dt in (torch.float32, torch.bfloat16):
        np.testing.assert_array_equal(
            T._dequantize_kv(q, s, dt).float().numpy(),
            np.asarray(RT._dequantize_kv(rq, rs, jnp.dtype(str(dt)[6:]))
                       .astype(jnp.float32)))


def test_block_allocator_matches_reference():
    """One seeded sequence of alloc / claim / release / register /
    match_prefix on both allocators: the free deque, refcounts and prefix
    index agree after every operation."""
    rng = np.random.default_rng(6)
    mine, ref = BlockAllocator(8, 2), ref_paged.BlockAllocator(8, 2)
    prompts = [np.asarray(p, np.int32) for p in
               ([1, 2, 3, 4, 5, 6, 7], [1, 2, 3, 4, 9, 9], [1, 2, 8, 8],
                [5, 5, 5, 5, 5])]
    held: list[int] = []
    for _ in range(400):
        op = rng.integers(5)
        if op == 0:
            n = int(rng.integers(1, 4))
            if n > len(mine.free):
                for a in (mine, ref):
                    with pytest.raises(RuntimeError, match="exhausted"):
                        a.alloc(n)
            else:
                got = mine.alloc(n)
                assert got == ref.alloc(n)
                held += got
        elif op == 1 and held:
            b = held[rng.integers(len(held))]
            assert mine.claim(b) == ref.claim(b)
            held.append(b)
        elif op == 2 and held:
            b = held.pop(rng.integers(len(held)))
            mine.release(b)
            ref.release(b)
        elif op == 3 and held:
            b = held[rng.integers(len(held))]
            p = prompts[rng.integers(len(prompts))]
            j = int(rng.integers(len(p) // 2))
            key = mine.prefix_key(p, j)
            assert key == ref.prefix_key(p, j)
            mine.register(b, key)
            ref.register(b, key)
        else:
            p = prompts[rng.integers(len(prompts))]
            assert mine.match_prefix(p) == ref.match_prefix(p)
        assert list(mine.free) == list(ref.free)
        np.testing.assert_array_equal(mine.refcount, ref.refcount)
        assert mine.prefix_index == ref.prefix_index
        assert mine._block_key == ref._block_key
        assert mine.blocks_in_use == ref.blocks_in_use


def _decisions(eng, step):
    """Run one iteration; log what the scheduler decided in it."""
    before = set(eng.active_uids)
    n_ev = eng.stats.evictions
    finished = sorted(o.uid for o in step())
    now = set(eng.active_uids)
    return dict(admitted=sorted(now - before),
                left=sorted(before - now - set(finished)),
                finished=finished, evictions=eng.stats.evictions - n_ev,
                queue=[r.uid for r in eng.queue],
                waits=eng.stats.admission_waits,
                hits=eng.stats.prefix_block_hits,
                in_use=eng.stats.blocks_in_use,
                tables=np.asarray(eng.tables).tolist(),
                free=list(eng.alloc.free))


def test_engine_decisions_match_reference():
    """The reference's PagedServeEngine and the port's, on one pressure
    trace (``off`` mode) with a shared system prompt: the same admissions,
    evictions, admission waits, prefix hits and block tables at every
    iteration."""
    rcfg, cfg, rparams, _, params, _, _ = setup("yi-6b")
    rng = np.random.default_rng(7)
    sys_prompt = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    spec = [(sys_prompt, 2, 6), (sys_prompt, 3, 5), (None, 5, 6),
            (sys_prompt, 1, 4), (None, 6, 3)]
    prompts = [np.concatenate([p if p is not None else [],
                               rng.integers(0, cfg.vocab_size, x)])
               .astype(np.int32) for p, x, _ in spec]
    kw = dict(n_slots=3, max_len=16, prefill_chunk=4, block_size=4,
              n_blocks=6)
    mine = PagedServeEngine(cfg, params, **kw)
    ref = ref_paged.PagedServeEngine(rcfg, rparams, **kw)
    for (_, _, n), p, u in zip(spec, prompts, range(len(spec))):
        mine.submit(Request(uid=u, prompt=p, max_new_tokens=n))
        ref.submit(RefRequest(uid=u, prompt=p, max_new_tokens=n))
    log_mine, log_ref = [], []
    while mine.has_work or ref.has_work:
        log_mine.append(_decisions(mine, mine.step))
        log_ref.append(_decisions(ref, ref.step))
        assert log_mine[-1] == log_ref[-1], len(log_mine)
        assert len(log_mine) < 200
    st = mine.stats
    assert st.evictions >= 1 and st.admission_waits >= 1
    assert st.prefix_block_hits >= 2 and st.completed == len(spec)


def test_int8_kv_logits_close_to_reference():
    """int8-KV logits of chunked prefill + teacher-forced decode, port
    against reference, within ``ATOL_INT8_KV``; the argmax equal wherever
    the reference's top-2 margin exceeds twice that."""
    rcfg, cfg, rparams, _, params, _, tokens = setup("yi-6b")
    rcfg = dataclasses.replace(rcfg, kv_cache_dtype="int8")
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    chunks = [(0, 4), (4, PROMPT)]
    chunk = jax.jit(lambda p, st, t: RT.prefill_chunk(p, rcfg, st, t))
    dec = jax.jit(lambda p, st, t: RT.decode_step(p, rcfg, st, t))
    st = RT.init_decode_state(rcfg, 2, TOTAL)
    for lo, hi in chunks:
        lg, st = chunk(rparams, st, jnp.asarray(tokens[:, lo:hi]))
    want = [np.asarray(lg)]
    for t in range(PROMPT, TOTAL):
        lg, st = dec(rparams, st, jnp.asarray(tokens[:, t:t + 1]))
        want.append(np.asarray(lg))
    want = np.concatenate(want, axis=1)
    with torch.no_grad():
        st = T.init_decode_state(cfg, 2, TOTAL, device="cpu")
        got = []
        for lo, hi in chunks:
            lg, st = T.prefill_chunk(params, cfg, st, ids(tokens[:, lo:hi]))
        got.append(lg)
        for t in range(PROMPT, TOTAL):
            lg, st = T.decode_step(params, cfg, st, ids(tokens[:, t:t + 1]))
            got.append(lg)
    got = torch.cat(got, dim=1).numpy()
    assert st["pos"] == TOTAL
    np.testing.assert_allclose(got, want, atol=ATOL_INT8_KV, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * ATOL_INT8_KV
    assert clear.any()
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_one_flipped_kv_code_is_within_tol():
    """The reasoning behind ``ATOL_INT8_KV``: one int8 K or V code moved
    by one step after the prefill moves the decode logits by more than
    float32 noise and by less than the tolerance."""
    _, cfg, _, _, params, _, tokens = setup("yi-6b")
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")

    def run(flip=None):
        with torch.no_grad():
            st = T.init_decode_state(cfg, 2, TOTAL, device="cpu")
            lg, st = T.prefill_chunk(params, cfg, st, ids(tokens[:, :PROMPT]))
            out = [lg]
            if flip is not None:
                name, idx, step = flip
                leaf = st["caches"][0][name]
                leaf[idx] = (leaf[idx].int() + step).clamp(-127, 127)
            for t in range(PROMPT, TOTAL):
                lg, st = T.decode_step(params, cfg, st,
                                       ids(tokens[:, t:t + 1]))
                out.append(lg)
        return torch.cat(out, dim=1).numpy()
    base = run()
    rng = np.random.default_rng(8)
    moved = []
    for i in range(24):
        idx = (int(rng.integers(2)), int(rng.integers(PROMPT)),
               int(rng.integers(cfg.n_kv_heads)),
               int(rng.integers(cfg.resolved_head_dim)))
        moved.append(np.abs(run(("kv"[i % 2], idx,
                                 int(rng.choice([-1, 1])))) - base).max())
    assert max(moved) < ATOL_INT8_KV
    assert max(moved) > 1e-4
