"""Worker side of the port's multi-rank tests (``test_torch_dist_ranks.py``,
``test_torch_compression.py``, ``test_torch_disagg.py``).

``spawn(task, world, tmp, payload)`` starts ``world`` processes by the
``spawn`` method, each one rank of a ``gloo`` process group over a
``file://`` store under ``tmp`` (no port is opened, so test workers cannot
collide), runs ``TASKS[task](rank, payload, tmp)`` on one intra-op thread,
and returns each rank's result (a rank killed by a signal reports the
Python stack that ``faulthandler`` wrote). The workers import torch, numpy and
``repro_torch`` only, never jax: the parent process computes the
reference's values. A rank that raises writes its traceback, and
``spawn`` raises it.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import multiprocessing
import os
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

ARCH = "qwen1.5-0.5b"
OPT_KW = dict(lr=3e-3, warmup_steps=5, total_steps=200, weight_decay=0.01)


def spawn(task: str, world: int, tmp: Path, payload, timeout: float = 240
          ) -> list:
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp}/store"
    procs = [ctx.Process(target=_main,
                         args=(task, rank, world, init, str(tmp), payload))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    out, errors = [], []
    for rank, p in enumerate(procs):
        path = Path(tmp) / f"rank{rank}.pkl"
        if not path.exists():
            crash = Path(tmp) / f"rank{rank}.crash"
            stack = crash.read_text()[-3000:] if crash.exists() else ""
            errors.append(f"rank {rank}: exit code {p.exitcode}, no result"
                          f"\n{stack}")
            continue
        with open(path, "rb") as f:  # written by this test's own workers
            res = pickle.load(f)
        if isinstance(res, dict) and "traceback" in res:
            errors.append(f"rank {rank}:\n{res['traceback']}")
        out.append(res)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _main(task: str, rank: int, world: int, init: str, tmp: str,
          payload) -> None:
    import faulthandler
    import torch.distributed as dist
    # a fatal signal's Python stack, for the parent's error
    crash = open(os.path.join(tmp, f"rank{rank}.crash"), "w")
    faulthandler.enable(file=crash)
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=90))
        try:
            res = TASKS[task](rank, payload, Path(tmp))
        finally:
            dist.destroy_process_group()
    except Exception:
        res = {"traceback": traceback.format_exc()}
    else:
        res["jax_loaded"] = sorted(m for m in sys.modules
                                   if m == "jax" or m.startswith("jax."))
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# ------------------------------------------------------------------ helpers
def _np(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy (a gathered replicated leaf is the rank's own
    storage, which later in-place steps would change)."""
    return np.array(t.detach().to(torch.float32).cpu().numpy())


def _expected_local(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``, from the mesh
    coordinate alone (major-first over a tuple entry's axes)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = full
    for d, e in enumerate(spec):
        if e is None:
            continue
        idx, n = 0, 1
        for a in ((e,) if isinstance(e, str) else e):
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        step = full.shape[d] // n
        out = out.narrow(d, idx * step, step)
    return out


def _placement_rows(source, placed, shardings) -> list:
    from repro_torch.train import _tree
    rows = []
    paths, src = _tree.flatten(source)
    for path, s, p, sh in zip(paths, src, _tree.leaves(placed),
                              _tree.leaves(shardings), strict=True):
        rows.append(dict(
            path=path, spec=tuple(sh.spec),
            placements=tuple(str(x) for x in p.placements),
            local_shape=tuple(p.to_local().shape),
            block_ok=bool(torch.equal(
                p.to_local(), _expected_local(s, sh.spec, sh.mesh))),
            full_ok=bool(torch.equal(p.full_tensor(), s)
                         and p.full_tensor().dtype == s.dtype)))
    return rows


# ------------------------------------------------------------------ tasks
def task_dist(rank: int, payload: dict, tmp: Path) -> dict:
    """Placements, ``shard``, the data-parallel step, elastic checkpoints
    and the meshes, on 4 ranks."""
    from repro_torch import configs
    from repro_torch.dist import sharding as dsh
    from repro_torch.launch import mesh as lm
    from repro_torch.models import transformer as T
    out: dict = {"rank": rank}
    mesh = lm.make_test_mesh(2, 2, device_type="cpu")
    out["coordinate"] = tuple(mesh.get_coordinate())

    # placements of reduced qwen's params and AdamW state (bf16 weights)
    from repro_torch.train import optimizer as opt
    cfg = configs.get(ARCH).reduced()
    params = T.init_params(cfg, seed=0, device="cpu")
    state = opt.init_state(opt.AdamWConfig(), params)
    pspecs = T.param_specs(cfg)
    for name, rules in (("default", dsh.DEFAULT_RULES),
                        ("serve", dsh.SERVE_RULES)):
        with dsh.axis_rules(rules):
            rows = []
            for tree, specs in ((params, pspecs),
                                (state, opt.state_specs(pspecs))):
                placed = dsh.place(tree, specs, mesh)
                rows += _placement_rows(
                    tree, placed, dsh.named_shardings(specs, tree, mesh))
        out[f"place_{name}"] = rows

    out["shard"] = _shard_checks(mesh)
    out["step"] = _dp_steps(payload)
    out["ckpt"] = _checkpoint(cfg, params, state, mesh, tmp)
    out["meshes"] = _meshes()
    return out


def _shard_checks(mesh) -> dict:
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.dist import sharding as dsh
    res = {}
    x = torch.ones(4, 8)
    res["no_mesh_identity"] = dsh.shard(x, "batch", "tp") is x
    with dsh.axis_rules(dsh.DEFAULT_RULES), dsh.use_mesh(mesh):
        res["plain_identity"] = dsh.shard(x, "batch", "tp") is x
        for rows in (4, 3):
            d = distribute_tensor(torch.arange(rows * 8.).reshape(rows, 8),
                                  mesh, [Replicate(), Replicate()])
            out = dsh.shard(d, "batch", "tp")
            res[f"placements_{rows}"] = tuple(str(p) for p in out.placements)
            res[f"values_{rows}"] = bool(torch.equal(out.full_tensor(),
                                                     d.full_tensor()))
        try:
            dsh.shard(x, "batch", "seq", "tp")
            res["rank_error"] = None
        except ValueError as e:
            res["rank_error"] = str(e)
    with dsh.axis_rules(()), dsh.use_mesh(mesh):
        d = distribute_tensor(torch.ones(4, 8), mesh,
                              [Replicate(), Replicate()])
        res["empty_rules_identity"] = dsh.shard(d, "batch", "tp") is d
    return res


# (name, rules, mesh shape, mesh axes, micro-batches)
DP_RUNS = (("default_x1", "DEFAULT_RULES", (2, 2), ("data", "model"), 1),
           ("default_x2", "DEFAULT_RULES", (2, 2), ("data", "model"), 2),
           ("multipod_x1", "MULTIPOD_RULES", (2, 2, 1),
            ("pod", "data", "model"), 1))


def _dp_steps(payload: dict) -> dict:
    """Two data-parallel train steps of reduced float32 qwen from the
    reference's weights (``payload["np_params"]``) on each of ``DP_RUNS``:
    losses, grad norms, the gathered params."""
    import dataclasses
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import compat
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import convert
    from repro_torch.models import transformer as T
    from repro_torch.train import _tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    ocfg = opt.AdamWConfig(**OPT_KW)
    data = SyntheticLM(64, 32, 8, seed=3)
    res = {}
    for name, rules, shape, axes, micro in DP_RUNS:
        cfg = dataclasses.replace(
            configs.get(ARCH).reduced(vocab_size=64, dtype="float32"),
            micro_batches=micro)
        mesh = compat.make_mesh(shape, axes, device_type="cpu")
        # a copy: placed leaves may share the source's storage, and the
        # step updates them in place
        params = convert.params_from_reference(
            copy.deepcopy(payload["np_params"]), cfg, "cpu")
        pspecs = T.param_specs(cfg)
        with dsh.axis_rules(getattr(dsh, rules)), dsh.use_mesh(mesh):
            p = dsh.place(params, pspecs, mesh)
            s = dsh.place(opt.init_state(ocfg, params),
                          opt.state_specs(pspecs), mesh)
            step = tl.make_train_step(cfg, ocfg)
            losses, norms = [], []
            for i in range(2):
                p, s, m = step(p, s, data.batch(i))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            placed = all(isinstance(t, DTensor)
                         for t in _tree.leaves((p, s)))
            paths, flat = _tree.flatten(p)
            res[name] = dict(
                losses=losses, grad_norms=norms, placed=placed,
                step=int(s["step"].full_tensor()),
                params=dict(zip(paths, (_np(t.full_tensor())
                                        for t in flat))))
    return res


def _checkpoint(cfg, params, state, mesh, tmp: Path) -> dict:
    """Save from the 2x2 placement; restore onto a 4x1 mesh and onto no
    mesh, bit for bit."""
    from repro_torch.dist import compat
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import transformer as T
    from repro_torch.train import _tree
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    pspecs = T.param_specs(cfg)
    pairs = ((params, pspecs), (state, opt.state_specs(pspecs)))
    tree = (params, state)
    d = str(tmp / "ckpt")
    with dsh.axis_rules(dsh.DEFAULT_RULES):
        placed = tuple(dsh.place(t, s, mesh) for t, s in pairs)
        ckpt.save(d, 3, placed, extra={"mesh": "2x2"})
        mesh41 = compat.make_mesh((4, 1), ("data", "model"),
                                  device_type="cpu")
        sh = tuple(dsh.named_shardings(s, t, mesh41) for t, s in pairs)
        back, step, extra = ckpt.restore(d, tree, shardings=sh)
    rows = _placement_rows(tree, back, sh)
    plain, step2, _ = ckpt.restore(d, tree)
    same = all(torch.equal(a, b) and a.dtype == b.dtype and not
               hasattr(a, "placements")
               for a, b in zip(_tree.leaves(plain), _tree.leaves(tree)))
    return dict(rows=rows, step=step, extra=extra, plain_step=step2,
                plain_equal=same,
                files=sorted(os.listdir(d)))


def _meshes() -> dict:
    from repro_torch.dist import compat
    from repro_torch.launch import mesh as lm
    res = {}
    pre, dec = lm.make_disaggregated_meshes((1, 1, 2), (1, 1, 2),
                                            device_type="cpu")
    res["disagg"] = dict(
        prefill=pre.mesh.tolist(), decode=dec.mesh.tolist(),
        names=(tuple(pre.mesh_dim_names), tuple(dec.mesh_dim_names)),
        coord=(pre.get_coordinate(), dec.get_coordinate()))
    for name, fn in (
            ("disagg_too_few", lambda: lm.make_disaggregated_meshes(
                prefill=(2, 16, 16), decode=(2, 16, 16), device_type="cpu")),
            ("disagg_4_4", lambda: lm.make_disaggregated_meshes(
                device_type="cpu")),
            ("production", lambda: lm.make_production_mesh(
                device_type="cpu")),
            ("production_pods", lambda: lm.make_production_mesh(
                multi_pod=True, device_type="cpu")),
            ("make_mesh", lambda: compat.make_mesh(
                (2, 3), ("data", "model"), device_type="cpu"))):
        try:
            fn()
            res[name] = None
        except ValueError as e:
            res[name] = str(e)
    res["pod_mesh"] = tuple(compat.make_mesh(
        (1, 2, 2), ("pod", "data", "model"), device_type="cpu"
    ).get_coordinate())
    return res


def task_compression(rank: int, payload: dict, tmp: Path) -> dict:
    """``compressed_psum`` over 4 ranks with one tree everywhere, and over
    the "data" axis of a 2x2 mesh with a tree per rank."""
    from repro_torch.dist import compat
    from repro_torch.train import compression as comp

    def tensors(d):
        return {k: torch.from_numpy(v) if v.dtype != np.uint16 else
                torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                for k, v in d.items()}

    def arrays(d):
        return {k: (v.view(torch.int16).numpy().view(np.uint16)
                    if v.dtype == torch.bfloat16 else v.numpy())
                for k, v in d.items()}

    line = compat.make_mesh((4,), ("data",), device_type="cpu")
    mean, err = comp.compressed_psum(tensors(payload["same"]), line, "data")
    square = compat.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    mine = payload["per_rank"][rank]
    mean2, err2 = comp.compressed_psum(tensors(mine["g"]), square, "data",
                                       tensors(mine["e"]))
    return dict(same=(arrays(mean), arrays(err)),
                per_rank=(arrays(mean2), arrays(err2)),
                coordinate=tuple(square.get_coordinate()))


def decisions(eng, step) -> dict:
    """Run one iteration of a paged engine; log what its scheduler decided
    in it (either package's engine)."""
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


def counts(tel) -> dict:
    """A telemetry registry's counters and gauges, and its histograms'
    observation counts (their sums are host times)."""
    out = {}
    for name, m in tel.registry.snapshot().items():
        if m["type"] == "histogram":
            out[name] = [(s["labels"], s["count"]) for s in m["series"]]
        else:
            out[name] = [(s["labels"], s["value"]) for s in m["series"]]
    return out


def _host_state(eng) -> dict:
    """What every rank of a disaggregated engine must agree on, and where
    its device state lives."""
    stats = {k: v for k, v in eng.stats.snapshot().items()
             if not k.endswith("_seconds")}
    return dict(role=eng.role, stats=stats, tables=eng.tables.tolist(),
                free=list(eng.alloc.free), pool=eng.state is not None,
                handoffs=eng.handoffs, handoff_bytes=eng.handoff_bytes)


def task_disagg(rank: int, payload: dict, tmp: Path) -> dict:
    """The disaggregated paged engine on 4 ranks, slices (1, 1, 2) +
    (1, 1, 2): each of ``payload["runs"]`` served (tokens, host state,
    staged states seen on decode ranks), a pressure trace logged an
    iteration at a time, a first decode rank that misses an iteration
    (the others must fail on the group's timeout), and meshes that leave
    rank 3 in neither slice."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import mesh as lm
    from repro_torch.models import convert, pim
    from repro_torch.models import transformer as T
    from repro_torch.obs import ServeTelemetry
    from repro_torch.serve import PagedServeEngine
    pm, dm = lm.make_disaggregated_meshes((1, 1, 2), (1, 1, 2),
                                          device_type="cpu")
    out: dict = {"rank": rank}
    models: dict = {}
    for name, run in payload["runs"].items():
        if run["arch"] not in models:
            arch = run["arch"]
            cfg = configs.get(arch).reduced(dtype="float32",
                                            kv_cache_dtype="float32")
            params = (T.init_params(cfg, seed=0, device="cpu")
                      if arch not in payload["np_params"] else
                      convert.params_from_reference(
                          copy.deepcopy(payload["np_params"][arch]), cfg,
                          "cpu"))
            models[arch] = cfg, params
        cfg, params = models[run["arch"]]
        cfg = dataclasses.replace(cfg, pim_mode=run["mode"])
        plans = (None if run["mode"] == "off" else
                 pim.prepare_pim_params(params, cfg, payload["calib"]))
        tel = ServeTelemetry(engine="paged") if run.get("telemetry") \
            else None
        eng = PagedServeEngine(cfg, params, plans=plans, prefill_mesh=pm,
                               decode_mesh=dm, telemetry=tel, **run["kw"])
        for r in run["requests"]:
            eng.submit(r)
        log, outs, staged = [], [], set()

        def step():
            done = eng.step()
            outs.extend(done)
            return done
        while eng.has_work:
            log.append(decisions(eng, step))
            staged |= {s.state1 is not None for s in eng.slots if s}
            if len(log) > 500:
                raise RuntimeError(f"{name}: no drain in 500 iterations")
        out[name] = dict(tokens={o.uid: o.tokens for o in outs},
                         reasons={o.uid: o.finish_reason for o in outs},
                         log=log, staged=sorted(staged),
                         metrics=None if tel is None else counts(tel),
                         **_host_state(eng))
        del eng
    out["timeout"] = _missed_iteration(rank, pm, dm, models, payload)
    pm1, dm1 = lm.make_disaggregated_meshes((1, 1, 1), (1, 1, 2),
                                            device_type="cpu")
    cfg, params = models[next(iter(payload["runs"].values()))["arch"]]
    try:
        eng = PagedServeEngine(cfg, params, n_slots=2, max_len=16,
                               block_size=4, prefill_mesh=pm1,
                               decode_mesh=dm1)
        out["neither"] = eng.role
    except ValueError as e:
        out["neither"] = str(e)
    return out


def _missed_iteration(rank, pm, dm, models, payload) -> dict:
    """Every rank but the first decode rank (rank 2) steps an engine whose
    groups time out after 3 s; rank 2 skips the iteration. Each other rank
    must raise within the timeout's order instead of hanging."""
    import datetime
    import time
    from repro_torch.serve import PagedServeEngine
    from repro_torch.serve import paged
    cfg, params = models[next(iter(payload["runs"].values()))["arch"]]
    saved = paged.GROUP_TIMEOUT
    paged.GROUP_TIMEOUT = datetime.timedelta(seconds=3)
    try:
        eng = PagedServeEngine(cfg, params, n_slots=2, max_len=16,
                               prefill_chunk=8, block_size=4,
                               prefill_mesh=pm, decode_mesh=dm)
    finally:
        paged.GROUP_TIMEOUT = saved
    eng.submit(payload["runs"]["off"]["requests"][0])
    t0 = time.perf_counter()
    if rank == 2:
        return dict(error=None, seconds=0.0)
    try:
        eng.step()
        err = None
    except RuntimeError as e:
        err = type(e).__name__ + ": " + str(e).splitlines()[0]
    return dict(error=err, seconds=time.perf_counter() - t0)


def _as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@contextlib.contextmanager
def _routes():
    """The expert ids (B, n_groups, group) of each ``moe_route`` call made
    in the body, as numpy."""
    from repro_torch.models import layers as L
    orig, log = L.moe_route, []

    def rec(*args):
        rt = orig(*args)
        log.append(rt.expert.numpy().copy())
        return rt
    L.moe_route = rec
    try:
        yield log
    finally:
        L.moe_route = orig


def task_tp(rank: int, payload: dict, tmp: Path) -> dict:
    """The partitioned train step and prefill on 4 ranks, for each of
    ``payload["runs"]`` (a 2-axis mesh under DEFAULT_RULES, a 3-axis pod
    mesh under MULTIPOD_RULES): 2 steps from the reference's weights on the
    payload's batches (losses, grad norms, the gathered parameters and
    each gradient's placements, on rank 0), then a prefill of the rank's
    rows of the payload's prompts (the rank's logits and cache blocks, its
    coordinate, and a partitioned prefill's refusal of ``pim_mode``)."""
    import dataclasses
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.dist import compat
    from repro_torch.dist import parallel
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import convert
    from repro_torch.models import transformer as T
    from repro_torch.train import _tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    ocfg = opt.AdamWConfig(**OPT_KW)
    out: dict = {"rank": rank}
    for run in payload["runs"]:
        cfg = dataclasses.replace(
            configs.get(run["arch"]).reduced(**run["reduced"]),
            **run["replace"])
        pods = len(run["mesh"]) == 3  # ("pod", "data", "model")
        mesh = compat.make_mesh(
            run["mesh"], ("pod", "data", "model") if pods
            else ("data", "model"), device_type="cpu")
        rules = dsh.MULTIPOD_RULES if pods else dsh.DEFAULT_RULES
        pspecs = T.param_specs(cfg)
        res: dict = {"coordinate": tuple(mesh.get_coordinate())}
        with dsh.axis_rules(rules), dsh.use_mesh(mesh):
            params = convert.params_from_reference(
                copy.deepcopy(payload["np_params"][run["config"]]), cfg,
                "cpu")
            p = dsh.place(params, pspecs, mesh)
            s = dsh.place(opt.init_state(ocfg, params),
                          opt.state_specs(pspecs), mesh)
            step = tl.make_train_step(cfg, ocfg)
            batches = [_as_torch(b) for b in payload["batches"][run["config"]]]
            loss, grads = tl.make_grad_fn(cfg)(p, batches[0])
            same = all(isinstance(g, DTensor) and g.placements == q.placements
                       for g, q in zip(_tree.leaves(grads), _tree.leaves(p)))
            # the batch placed along its rows: the same rows, the same step
            rows = {k: dsh.distribute(v, dsh.NamedSharding(
                mesh, dsh.spec_for(("batch",), mesh)))
                for k, v in batches[0].items()}
            loss2, grads2 = tl.make_grad_fn(cfg)(p, rows)
            res["placed_batch_equal"] = bool(torch.equal(loss, loss2)) and all(
                torch.equal(a.to_local(), b.to_local()) for a, b in zip(
                    _tree.leaves(grads), _tree.leaves(grads2)))
            del grads, grads2
            losses, norms = [], []
            for b in batches:
                p, s, m = step(p, s, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            paths, flat = _tree.flatten(p)
            gathered = {k: _np(t.full_tensor()) for k, t in zip(paths, flat)}
            res.update(losses=losses, grad_norms=norms,
                       grad_placements_ok=same,
                       placed=all(isinstance(t, DTensor)
                                  for t in _tree.leaves((p, s))),
                       step=int(s["step"].full_tensor()))
            if rank == 0:
                res["params"] = gathered
            # prefill of this rank's rows, from the reference's weights
            params = convert.params_from_reference(
                copy.deepcopy(payload["np_params"][run["config"]]), cfg,
                "cpu")
            p = dsh.place(params, pspecs, mesh)
            prompts = torch.from_numpy(np.array(
                payload["prompts"][run["config"]]))
            part = T.partition(p, cfg)
            rows = prompts.shape[0] // part.n_batch
            mine = prompts[part.batch_index * rows:
                           (part.batch_index + 1) * rows]
            with torch.no_grad(), _routes() as routes:
                logits, state = T.prefill(p, cfg, mine)
            res["prefill"] = dict(
                logits=_np(logits), pos=state["pos"],
                caches=[{k: _np(v) for k, v in c.items()}
                        for c in state["caches"]],
                batch_index=part.batch_index, model_rank=part.model.rank,
                heads=part.heads, kv=part.kv, experts=part.experts,
                inner=part.inner, rwkv_heads=part.rwkv_heads,
                routes=routes)
            try:
                T.prefill(p, dataclasses.replace(cfg, pim_mode="exact"),
                          mine)
                res["pim_refusal"] = None
            except ValueError as e:
                res["pim_refusal"] = str(e)
            res["placed_flag"] = (parallel.placed(p),
                                  parallel.placed(params))
        out[run["name"]] = res
    out["decode"] = {run["name"]: _decode_run(run, payload)
                     for run in payload.get("decode_runs", ())}
    return out


def _state_from_numpy(start: dict) -> dict:
    pos = start["pos"]
    return {"caches": [{k: torch.from_numpy(np.array(v)) for k, v in
                        c.items()} for c in start["caches"]],
            "pos": pos if isinstance(pos, int) else torch.from_numpy(
                np.array(pos))}


def _decode_run(run: dict, payload: dict) -> dict:
    """The partitioned decode (``dist.parallel.ServePartition``) of one of
    ``payload["decode_runs"]``: the reference's weights placed by
    ``param_specs`` and the one-process start state by ``cache_specs``
    under SERVE_RULES (MULTIPOD_SERVE_RULES on a pod mesh), then
    ``DECODE_STEPS`` steps on the run's whole tokens. Returns each step's
    logits block and the head's vocab start, the final cache blocks with
    their rows' and positions' starts, the collectives' result shapes and
    the leaves' global and local shapes (rank 0), and the refusals: other
    rules, paged tables, ``pim_mode``; plain parameters under the mesh
    run the replicated program."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.dist import compat, parallel
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import convert
    from repro_torch.models import transformer as T
    from repro_torch.train import _tree
    cfg = dataclasses.replace(
        configs.get(run["arch"]).reduced(**run["reduced"]), **run["replace"])
    pods = len(run["mesh"]) == 3
    mesh = compat.make_mesh(
        run["mesh"], ("pod", "data", "model") if pods
        else ("data", "model"), device_type="cpu")
    rules = dsh.MULTIPOD_SERVE_RULES if pods else dsh.SERVE_RULES
    params = convert.params_from_reference(
        copy.deepcopy(payload["np_params"][run["config"]]), cfg, "cpu")
    tokens = torch.from_numpy(np.array(run["tokens"]))
    res: dict = {"coordinate": tuple(mesh.get_coordinate())}
    with dsh.axis_rules(rules), dsh.use_mesh(mesh), torch.no_grad():
        p = dsh.place(params, T.param_specs(cfg), mesh)
        state = dsh.place(_state_from_numpy(run["start"]),
                          T.cache_specs(cfg), mesh)
        part = T.partition(p, cfg, decode=True)
        rows, seq = part.cache_layout(state["caches"])
        parallel.STATS.reset()
        logits = []
        with _routes() as routes:
            for t in tokens:
                lg, state = T.decode_step(p, cfg, state, t)
                logits.append(_np(lg))
        shapes = sorted(parallel.STATS.shapes)
        by_op = dict(parallel.STATS.by_op)
        res.update(
            logits=logits, vocab_start=part.leaf["embed/head"].start,
            partition_kept=T.partition(p, cfg, decode=True) is part,
            rows_start=rows.start, seq_start=seq.start,
            pos=np.array(state["pos"].to_local() if hasattr(
                state["pos"], "to_local") else state["pos"]).tolist(),
            caches=[{k: v.to_local().numpy().copy() for k, v in c.items()}
                    for c in state["caches"]],
            greedy=part.greedy(lg).numpy().copy(),
            collective_shapes=shapes, collectives=by_op, routes=routes,
            experts=[part.experts(f"layers/{i}/ffn/w1")
                     for i in range(cfg.n_layers)
                     if f"layers/{i}/ffn/router" in part.leaf])
        if run.get("checks"):
            paths, flat = _tree.flatten(p)
            res["leaf_shapes"] = sorted(
                {tuple(t.shape) for t in flat}
                | {tuple(t.to_local().shape) for t in flat})
            res["refusals"] = _decode_refusals(cfg, p, params, state, mesh,
                                               tokens[0])
            plain = _state_from_numpy(run["start"])
            want, _ = T.decode_step(params, cfg, plain, tokens[0])
            res["plain_under_mesh"] = _np(want)
    return res


def _decode_refusals(cfg, p, params, state, mesh, tok) -> dict:
    """What the partitioned decode refuses, each error's text."""
    import dataclasses
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import transformer as T
    out = {}
    tables = torch.zeros((tok.shape[0], 2), dtype=torch.int64)
    cases = {
        "default_rules": lambda: T.decode_step(p, cfg, state, tok),
        "paged": lambda: T.decode_step(
            p, cfg, state, tok, block_tables=tables,
            paged=T.PagedLayout(n_blocks=4, block_size=8)),
        "pim": lambda: T.decode_step(
            p, dataclasses.replace(cfg, pim_mode="exact"), state, tok)}
    for name, fn in cases.items():
        ctx = dsh.axis_rules(dsh.DEFAULT_RULES) if name == "default_rules" \
            else dsh.axis_rules(dsh.current_rules())
        try:
            with ctx:
                fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


TASKS = {"dist": task_dist, "compression": task_compression,
         "disagg": task_disagg, "tp": task_tp}
