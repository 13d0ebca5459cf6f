"""Worker side of the port's multi-rank tests (``test_torch_dist_ranks.py``,
``test_torch_compression.py``).

``spawn(task, world, tmp, payload)`` starts ``world`` processes by the
``spawn`` method, each one rank of a ``gloo`` process group over a
``file://`` store under ``tmp`` (no port is opened, so test workers cannot
collide), runs ``TASKS[task](rank, payload, tmp)`` on one intra-op thread,
and returns each rank's result. The workers import torch, numpy and
``repro_torch`` only, never jax: the parent process computes the
reference's values. A rank that raises writes its traceback, and
``spawn`` raises it.
"""

from __future__ import annotations

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
            errors.append(f"rank {rank}: exit code {p.exitcode}, no result")
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
    import torch.distributed as dist
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


TASKS = {"dist": task_dist, "compression": task_compression}
