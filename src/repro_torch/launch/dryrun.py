"""Multi-pod dry run: run every (architecture x input shape x mesh) cell's
per-rank program on fake tensors and report its roofline terms.

Port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell with the production shardings on 256 or 512 fake CPU devices. Torch
is multi-controller, so a cell here is rank 0 of a fake process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``), opened
inside ``dryrun_cell`` and destroyed before it returns, on the production
mesh (``launch.mesh.make_production_mesh``). Every tensor is a fake tensor
(``FakeTensorMode``): nothing is allocated, just as the reference
allocates nothing. ``launch.hlo_analysis.analyze`` counts the step's
flops, bytes, collectives and peak live bytes at the rank's local shapes.

The step is what the port runs on one rank, the partitioned programs
(``dist.parallel``) of every config, the counterpart of the reference's
``jax.jit(..., in_shardings=...)``:

  - train and prefill cells: parameters placed as DTensors by
    ``param_specs`` under the cell's rules (``dist.place``), the AdamW
    state by ``state_specs``; the train step
    (``train_loop.make_train_step`` under the mesh) is FSDP, tensor and
    sequence parallel on the rank's slice of the batch (MoE FFNs expert
    parallel over "model", mamba layers over their d_inner channels,
    rwkv6 layers over whole heads), and the prefill
    (``transformer.prefill``) is tensor and sequence parallel on the
    rank's rows, returning the rank's blocks of the logits and caches.
  - decode cells: the partitioned decode under SERVE_RULES /
    MULTIPOD_SERVE_RULES (``dist.parallel.ServePartition``), the
    counterpart of the reference's ``jax.jit(decode_step,
    in_shardings=(params_sh, cache_sh, batch_sh))``: the weights placed by
    ``param_specs`` (stationary, split over the whole mesh), the state by
    ``cache_specs`` (the rank's rows by its block of positions; a
    recurrent carry by its rows; only the local blocks are made), the
    tokens whole; the step (``transformer.decode_step``) returns the
    rank's vocab block of the logits; a MoE FFN runs the experts of the
    rank's stored block; a recurrent layer steps the rank's rows.
    ``long_500k``'s batch of 1 stays whole on every rank.

Only the step is counted, not the placement.

Fake tensors live on the card's device type unless ``--device`` names
another (``cpu`` in the tests). Reports carry the reference's keys, per
device, but ``xla_cost_analysis_flops_loop_once`` (there is no XLA);
``compile_seconds`` holds the fake run's wall seconds and ``fits_hbm``
compares with ``HBM_PER_CHIP``, the H100's 80 GB.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun --jobs 6
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --single-pod-only \\
      --device cpu
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback

import torch

from repro_torch import configs, resolve_device
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.dist import parallel
from repro_torch.dist import sharding as dsh
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import make_train_step

# NVIDIA H100 80GB HBM3: 80e9 bytes, below the 85.0e9 that the card
# reports as total_memory
HBM_PER_CHIP = 80 * 10 ** 9


# ------------------------------------------------------------- input specs
def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta tensors standing in for every model input of this cell (the
    reference's ShapeDtypeStructs)."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    if shape.kind == "train":
        if cfg.input_mode == "tokens":
            inputs = spec((B, S), tok)
        else:
            inputs = spec((B, S, cfg.d_model), torch.bfloat16)
        return {"inputs": inputs, "labels": spec((B, S), tok)}
    if shape.kind == "prefill":
        if cfg.input_mode == "tokens":
            return {"inputs": spec((B, S), tok)}
        return {"inputs": spec((B, S, cfg.d_model), torch.bfloat16)}
    # decode: one new token against a seq_len cache
    if cfg.input_mode == "tokens":
        return {"tokens": spec((B, 1), tok)}
    return {"tokens": spec((B, 1, cfg.d_model), torch.bfloat16)}


def batch_logical(cfg: ArchConfig, shape: InputShape) -> dict:
    if shape.kind == "train":
        il = ("batch", "seq") if cfg.input_mode == "tokens" \
            else ("batch", "seq", None)
        return {"inputs": il, "labels": ("batch", "seq")}
    if shape.kind == "prefill":
        il = ("batch", "seq") if cfg.input_mode == "tokens" \
            else ("batch", "seq", None)
        return {"inputs": il}
    tl = ("batch", None) if cfg.input_mode == "tokens" \
        else ("batch", None, None)
    return {"tokens": tl}


def _batch_ranks(logical: str, rows: int, mesh) -> int:
    """How many ways the logical axis ``logical`` splits ``rows`` under the
    bound rules, fitted as ``fit_spec_to_shape`` fits it (1: whole)."""
    spec = dsh.fit_spec_to_shape(dsh.spec_for((logical,), mesh), (rows,),
                                 mesh)
    if not spec or spec[0] is None:
        return 1
    axes = (spec[0],) if isinstance(spec[0], str) else spec[0]
    return math.prod(dsh._mesh_sizes(mesh)[a] for a in axes)


def _fake(meta: torch.Tensor, dev, rows: int | None = None) -> torch.Tensor:
    """A tensor of ``meta``'s dtype and shape (``rows`` leading rows if
    given) on ``dev``: a fake tensor under ``FakeTensorMode``."""
    shp = tuple(meta.shape) if rows is None else (rows, *meta.shape[1:])
    return torch.zeros(shp, dtype=meta.dtype, device=dev)


def _placed(meta: torch.Tensor, sharding, dev):
    """A DTensor of ``meta``'s shape placed by ``sharding`` whose local
    block alone is made, zeroed on ``dev`` (a fake tensor under
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh, pl = sharding.mesh, sharding.placements
    shape = list(meta.shape)
    for d, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.size(d)
    return DTensor.from_local(
        torch.zeros(shape, dtype=meta.dtype, device=dev), mesh, pl,
        run_check=False, shape=meta.shape,
        stride=torch.empty(meta.shape, device="meta").stride())


def _placed_rows(meta: torch.Tensor, dev, mesh):
    """``meta``'s batch as a DTensor placed along its rows by the axes
    ``"batch"`` resolves to: the rank holds its rows only."""
    spec = dsh.fit_spec_to_shape(dsh.spec_for(("batch",), mesh),
                                 (meta.shape[0],), mesh)
    return _placed(meta, dsh.NamedSharding(mesh, spec), dev)


def _placed_state(cfg: ArchConfig, shape: InputShape, mesh, dev) -> dict:
    """The decode state of the cell placed by ``cache_specs`` under the
    bound rules: DTensors whose local blocks alone are made."""
    meta = T.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                               device="meta")
    specs = T.cache_specs(cfg)
    shardings = dsh.named_shardings(specs, meta, mesh)
    return dsh.map_specs(lambda _, leaf, sh: leaf if sh is None
                         else _placed(leaf, sh, dev), specs, meta, shardings)


# ------------------------------------------------------------- step builders
def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch["inputs"])
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, state, batch):
        return T.decode_step(params, cfg, state, batch["tokens"])
    return serve_step


def rank_program(cfg: ArchConfig, shape: InputShape, mesh, dev):
    """The rank's step and its arguments for this cell (module docstring),
    under the bound rules, with random weights from seed 0 and zeroed
    inputs and caches, placed on ``mesh`` (a ``DeviceMesh``): fake tensors
    under ``FakeTensorMode``, real ones otherwise. A decode cell's
    ``ServePartition`` is made here, before the step: its one gather of
    the channel-wise leaves of the recurrent layers is placement."""
    batch = input_specs(cfg, shape)
    params = T.init_params(cfg, seed=0, device=dev)
    pspecs = T.param_specs(cfg)
    if shape.kind == "train":
        opt_cfg = opt.AdamWConfig(state_dtype=cfg.opt_state_dtype)
        state = dsh.place(opt.init_state(opt_cfg, params),
                          opt.state_specs(pspecs), mesh)
        params = dsh.place(params, pspecs, mesh)
        # each rank holds its rows, placed
        batch = {k: _placed_rows(v, dev, mesh) for k, v in batch.items()}
        return make_train_step(cfg, opt_cfg), (params, state, batch)
    params = dsh.place(params, pspecs, mesh)
    if shape.kind == "prefill":
        n = _batch_ranks(batch_logical(cfg, shape)["inputs"][0],
                         shape.global_batch, mesh)
        batch = {"inputs": _fake(batch["inputs"], dev,
                                 shape.global_batch // n)}
        return make_prefill_step(cfg), (params, batch)
    # the tokens whole, weights and state placed
    parallel.serve_partition(mesh, cfg, params, pspecs)
    return make_serve_step(cfg), (
        params, _placed_state(cfg, shape, mesh, dev),
        {"tokens": _fake(batch["tokens"], dev)})


def cell_rules(shape: InputShape, multi_pod: bool):
    """The rule set of a cell: serve rules for decode, else train's."""
    if shape.kind == "decode":
        return dsh.MULTIPOD_SERVE_RULES if multi_pod else dsh.SERVE_RULES
    return dsh.MULTIPOD_RULES if multi_pod else dsh.DEFAULT_RULES


def cut_depth(cfg: ArchConfig, n_layers: int) -> ArchConfig:
    """``cfg``'s first ``n_layers`` layers: below one repeat of its block
    pattern, the pattern cut to its first ``n_layers`` positions, so each
    layer keeps its kind and its FFN (jamba's first 4: mamba + MoE, mamba,
    mamba + MoE, attention)."""
    pat = cfg.block_pattern
    return dataclasses.replace(cfg, n_layers=n_layers,
                               block_pattern=pat[:n_layers]
                               if n_layers < len(pat) else pat)


# ------------------------------------------------------------- cell dry-run
def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool,
                verbose: bool = True, device=None,
                n_layers: int | None = None) -> dict:
    """One cell's report (module docstring); ``n_layers`` cuts the
    config's depth (``cut_depth``: a rank program that one card can also
    hold whole)."""
    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = cut_depth(cfg, n_layers)
    shape = {s.name: s for s in configs.runnable_shapes(cfg)}.get(shape_name)
    if shape is None:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped",
                "reason": "assignment skip rule (see DESIGN.md §4)"}
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dev = resolve_device(device)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=dev.type)
        t0 = time.time()
        with FakeTensorMode(), dsh.axis_rules(cell_rules(shape, multi_pod)):
            step, args = rank_program(cfg, shape, mesh, dev)
            with torch.set_grad_enabled(shape.kind == "train"), \
                    dsh.use_mesh(mesh):
                _, costs, dev_bytes = hlo.analyze(step, *args)
            del step, args
        seconds = time.time() - t0
        n_chips = math.prod(mesh.shape)
    finally:
        dist.destroy_process_group()

    flops = costs.flops
    bytes_acc = costs.hbm_bytes
    terms = hlo.roofline_terms(flops, bytes_acc, costs.total_coll_bytes)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cfg.active_param_count()
    # embedding lookups are gathers, not MACs: exclude the table from the
    # useful-FLOPs numerator (the LM head IS a matmul and stays counted)
    n_flops_params = n_active - cfg.vocab_size * cfg.d_model
    model_flops = (6 if shape.kind == "train" else 2) * n_flops_params * tokens
    model_flops_per_chip = model_flops / n_chips

    report = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "multi_pod": multi_pod, "n_chips": n_chips, "status": "ok",
        "per_device_bytes": int(dev_bytes),
        "per_device_gib": round(dev_bytes / 1024 ** 3, 3),
        "fits_hbm": bool(dev_bytes <= HBM_PER_CHIP),
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_acc,
        "collective_bytes_per_device": costs.total_coll_bytes,
        "collective_breakdown": costs.coll_bytes,
        "collective_counts": costs.coll_counts,
        "model_flops_per_device": model_flops_per_chip,
        "useful_flops_ratio": (model_flops_per_chip / flops) if flops else 0.0,
        "params_total": cfg.param_count(),
        "params_active": n_active,
        "compile_seconds": round(seconds, 1),
        **terms,
    }
    if verbose:
        print(f"[{arch} x {shape_name} x "
              f"{'2x16x16' if multi_pod else '16x16'}] "
              f"{report['per_device_gib']} GiB/dev "
              f"fits={report['fits_hbm']} "
              f"compute={terms['compute_s']:.3e}s "
              f"mem={terms['memory_s']:.3e}s "
              f"coll={terms['collective_s']:.3e}s "
              f"bound={terms['bottleneck']} "
              f"({report['compile_seconds']}s fake run)")
        print(f"  counted: {flops:.4e} flops, {bytes_acc:.4e} bytes, "
              f"collectives {costs.coll_counts}", flush=True)
    return report


def _cell_or_failure(cell: tuple, device) -> dict:
    """``dryrun_cell``'s report, or a FAILED record if it raised."""
    a, s, mp = cell
    try:
        return dryrun_cell(a, s, multi_pod=mp, device=device)
    except Exception as e:  # a failing cell is a bug in the system
        traceback.print_exc()
        return {"arch": a, "shape": s, "multi_pod": mp, "status": "FAILED",
                "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="an arch, or a comma list of them")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=None, help="directory for JSON reports")
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors (default: cuda)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]

    cells = []
    archs = configs.ASSIGNED if (args.all or not args.arch) \
        else tuple(args.arch.split(","))
    for a in archs:
        cfg = configs.get(a)
        shapes = [s.name for s in configs.runnable_shapes(cfg)]
        if args.shape:
            shapes = [args.shape] if args.shape in shapes else []
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    results, failures = [], 0
    with contextlib.ExitStack() as stack:
        run = map
        if args.jobs > 1:
            run = stack.enter_context(concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn"))
            ).map
        for (a, s, mp), r in zip(cells, run(_cell_or_failure, cells,
                                            [args.device] * len(cells))):
            failures += r["status"] == "FAILED"
            results.append(r)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                tag = f"{a}_{s}_{'mp' if mp else 'sp'}.json"
                with open(os.path.join(args.out, tag), "w") as f:
                    json.dump(r, f, indent=2)
    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\ndry-run: {ok} ok / {failures} failed / "
          f"{len(results) - ok - failures} skipped, {len(results)} cells")
    if args.out:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(results, f, indent=2)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
