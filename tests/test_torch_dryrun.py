"""The port's dry run (``repro_torch.launch.dryrun``) and its cost counter
(``repro_torch.launch.hlo_analysis``) against the reference's, on the CPU.

- The input shapes, their skip rules, ``input_specs`` and
  ``batch_logical`` equal the reference's for every arch.
- The counter: the reference's ``TestHloAnalysis`` cases as eager loops
  count the reference's flops on its jitted scans; ``roofline_terms``
  equals the reference's function over the H100's constants; one
  all-gather and one all-reduce on a fake 4-rank group carry the
  reference's ring bytes; a sampled recurrent scan counts the flops and
  bytes of a run of every trip, forward and backward.
- Flops of reduced qwen1.5-0.5b and yi-6b's prefill, decode and train step
  against the reference's ``hlo.analyze`` on a one-device jit.
- The partitioned decode's collectives over a flattened group and its
  log-sum-exp combine, counted once each with the reference's ring bytes.
- qwen1.5-0.5b's three single-pod cells, from the port's CLI and the
  reference's, both in subprocesses: the report fields that must agree,
  the key sets, each cell's flops against its per-rank program run alone
  under a fake 256-rank group, the partitioned decode's and prefill's
  collectives, the decode's flops against the count derived from the
  config and the reference's, and the train cell's all-gather bytes from
  its placed parameters.
- One 512-rank cell, one cell per model family at published width, a
  110B decode cell that fits a card while allocating nothing, and the
  CLI's failure path.
"""

import dataclasses
import json
import os
import resource
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as ref_configs
from repro.launch import hlo_analysis as rhlo
from repro.models import transformer as RT
from repro.train import optimizer as ropt
from repro.train import train_loop as rtl
from repro_torch import configs
from repro_torch.dist import sharding as dsh
from repro_torch.dist.compat import AbstractMesh
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl

from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
QWEN = "qwen1.5-0.5b"
QWEN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SAME = ("arch", "shape", "kind", "multi_pod", "n_chips", "status",
        "params_total", "params_active", "model_flops_per_device")


def _astuples(shapes) -> list:
    return [dataclasses.astuple(s) for s in shapes]


# ------------------------------------------------------------ (a), (b)
def test_shapes_and_skip_rules_equal_the_reference():
    assert _astuples(configs.ALL_SHAPES) == _astuples(ref_configs.ALL_SHAPES)
    assert sorted(configs.REGISTRY) == sorted(ref_configs.REGISTRY)
    pairs = 0
    for name in configs.REGISTRY:
        assert _astuples(configs.runnable_shapes(configs.get(name))) == \
            _astuples(ref_configs.runnable_shapes(ref_configs.get(name))), \
            name
        if name in configs.ASSIGNED:
            pairs += len(configs.runnable_shapes(configs.get(name)))
    assert configs.ASSIGNED == ref_configs.ASSIGNED
    assert pairs == 31  # x 2 meshes = the sweep's 62 cells


def test_input_specs_equal_the_reference():
    from repro.launch import dryrun as rdry
    for name in configs.ASSIGNED:
        cfg, rcfg = configs.get(name), ref_configs.get(name)
        for shape, rshape in zip(configs.runnable_shapes(cfg),
                                 ref_configs.runnable_shapes(rcfg)):
            got = dryrun.input_specs(cfg, shape)
            want = rdry.input_specs(rcfg, rshape)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).removeprefix("torch.") == \
                    str(want[k].dtype)
            assert dryrun.batch_logical(cfg, shape) == \
                rdry.batch_logical(rcfg, rshape), (name, shape.name)


# ------------------------------------------------------------ (c) counter
def test_loop_flops_equal_the_reference_scans():
    """The reference's TestHloAnalysis cases: a loop of 5 and nested
    loops of 3 x 2 matmuls, run eagerly, count the flops the reference
    counts on its jitted scans (and the closed form)."""
    def f(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, ws)[0]
    ref = rhlo.analyze(jax.jit(f).lower(
        jax.ShapeDtypeStruct((64, 128), jnp.float32),
        jax.ShapeDtypeStruct((5, 128, 128), jnp.float32)).compile().as_text())

    def g(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x
    _, costs, peak = hlo.analyze(g, torch.ones(64, 128),
                                 torch.ones(5, 128, 128))
    assert costs.flops == ref.flops == 5 * 2 * 64 * 128 * 128
    assert peak >= (64 * 128 + 5 * 128 * 128) * 4

    def f2(x, ws):
        def outer(c, pair):
            return jax.lax.scan(lambda ci, w: (ci @ w, None), c, pair)[0], \
                None
        return jax.lax.scan(outer, x, ws)[0]
    ref = rhlo.analyze(jax.jit(f2).lower(
        jax.ShapeDtypeStruct((32, 64), jnp.float32),
        jax.ShapeDtypeStruct((3, 2, 64, 64), jnp.float32)).compile().as_text())

    def g2(x, ws):
        for pair in ws:
            for w in pair:
                x = x @ w
        return x
    _, costs, _ = hlo.analyze(g2, torch.ones(32, 64),
                              torch.ones(3, 2, 64, 64))
    assert costs.flops == ref.flops == 6 * 2 * 32 * 64 * 64


def test_roofline_terms_are_the_reference_formula(monkeypatch):
    t = hlo.roofline_terms(hlo.PEAK_FLOPS_BF16, 0.0, 0.0)
    assert t["bottleneck"] == "compute"
    assert t["roofline_fraction"] == pytest.approx(1.0)
    t = hlo.roofline_terms(1e12, hlo.HBM_BW * 2, 0.0)
    assert t["bottleneck"] == "memory"
    monkeypatch.setattr(rhlo, "PEAK_FLOPS_BF16", hlo.PEAK_FLOPS_BF16)
    monkeypatch.setattr(rhlo, "HBM_BW", hlo.HBM_BW)
    monkeypatch.setattr(rhlo, "ICI_BW", hlo.LINK_BW)
    for args in ((3.4e14, 2.66e13, 2.4e9), (3.3e10, 2.4e11, 0.0),
                 (1e15, 1e12, 5e11), (0.0, 0.0, 0.0)):
        assert hlo.roofline_terms(*args) == rhlo.roofline_terms(*args)
    assert hlo.PEAK_FLOPS_BF16 == 989e12
    assert hlo.HBM_BW == 3.35e12
    assert hlo.LINK_BW == 450e9
    assert dryrun.HBM_PER_CHIP == 80 * 10 ** 9


@pytest.fixture
def fake_group():
    """Rank 0 of a fake 4-rank process group, destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("impl", ["functional", "parallel"])
def test_autograd_collectives_counted_once_each_way(fake_group, impl):
    """An autograd all-gather and reduce-scatter on a fake 4-rank group:
    each counted once in the forward and once in the backward (its
    reverse), with the reference's ring bytes: funcol's
    ``all_gather_tensor_autograd`` / ``reduce_scatter_tensor_autograd``
    and ``dist.parallel``'s own."""
    import warnings
    import torch.distributed._functional_collectives as fc
    from repro_torch.dist import parallel
    from torch.distributed.device_mesh import init_device_mesh
    group = dist.group.WORLD
    if impl == "parallel":
        g = parallel.Group(init_device_mesh("cpu", (4,),
                                            mesh_dim_names=("model",)), 0)

        def ag(t):
            return parallel.all_gather(t, 0, g)

        def rs(t):
            return parallel.reduce_scatter(t, 0, g)
    else:
        def ag(t):
            return fc.wait_tensor(fc.all_gather_tensor_autograd(t, 0, group))

        def rs(t):
            return fc.wait_tensor(
                fc.reduce_scatter_tensor_autograd(t, "sum", 0, group))
    payload = 64 * 32 * 4  # the all-gather's result, float32
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)

        def step(x, fn):
            y = fn(x)
            (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
            return g
        x = torch.zeros(16, 32, requires_grad=True)
        _, c, _ = hlo.analyze(step, x, ag)
        assert c.coll_counts == {"all-gather": 1, "reduce-scatter": 1}
        assert c.coll_bytes == {"all-gather": payload * 3 / 4,
                                "reduce-scatter": payload / 4 * 3}
        x = torch.zeros(64, 32, requires_grad=True)
        _, c, _ = hlo.analyze(step, x, rs)
        assert c.coll_counts == {"all-gather": 1, "reduce-scatter": 1}
        assert c.coll_bytes == {"all-gather": payload * 3 / 4,
                                "reduce-scatter": payload / 4 * 3}


def test_flattened_group_collectives_counted_once(fake_group):
    """The partitioned decode's collectives on rank 0 of a fake 4-rank
    group, mesh (2, 2): an all-reduce and an all-gather over the group
    flattened from both mesh dims (``parallel.mesh_group``, 4 ranks), and
    the log-sum-exp combine over "model" (2 ranks: an all-reduce of the
    max, one of the rescaled sums), each counted once with the reference's
    ring bytes, 2 payload (s - 1) / s and payload (s - 1) / s."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist import parallel
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    flat = parallel.mesh_group(mesh, (0, 1))
    assert (flat.size, flat.rank) == (4, 0)
    assert parallel.mesh_group(mesh, (1, 0)) is flat  # made once a mesh
    model = parallel.mesh_group(mesh, (1,))
    assert model.size == 2

    def step(y, acc, m, l):
        y = parallel.all_reduce(y, flat)
        return parallel.all_gather(y, 1, flat), \
            parallel.combine_attention(acc, m, l, model)
    with FakeTensorMode():
        _, c, _ = hlo.analyze(step, torch.zeros(8, 1, 16),
                              torch.zeros(2, 1, 4, 16), torch.zeros(2, 1, 4),
                              torch.ones(2, 1, 4))
    y = 8 * 16 * 4
    assert c.coll_counts == {"all-reduce": 3, "all-gather": 1}
    assert c.coll_bytes == {
        "all-reduce": 2 * y * 3 / 4 + 2 * (2 * 4 * 4) / 2
        + 2 * (2 * 4 * 17 * 4) / 2,
        "all-gather": 4 * y * 3 / 4}


def test_collective_bytes_on_a_fake_group(fake_group):
    """Shard -> Replicate is one all-gather of payload (s - 1) / s, Partial
    -> Replicate one all-reduce of 2 payload (s - 1) / s, each counted at
    the local shapes; a DTensor product counts its local flops."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    mesh = init_device_mesh("cpu", (4,))
    with FakeTensorMode():
        x = distribute_tensor(torch.zeros(64, 32), mesh, [Shard(0)])
        _, c, _ = hlo.analyze(DTensor.full_tensor, x)
        payload = 64 * 32 * 4
        assert c.coll_bytes == {"all-gather": payload * 3 / 4}
        assert c.coll_counts == {"all-gather": 1}
        p = DTensor.from_local(torch.zeros(64, 32), mesh, [Partial()],
                               run_check=False)
        _, c, _ = hlo.analyze(lambda t: t.redistribute(mesh, [Replicate()]),
                              p)
        assert c.coll_bytes == {"all-reduce": 2 * payload * 3 / 4}
        stats = hlo.collective_stats(DTensor.full_tensor, x)
        assert stats.total_bytes == payload * 3 / 4
        w = distribute_tensor(torch.zeros(32, 16), mesh, [Replicate()])
        _, c, _ = hlo.analyze(torch.matmul, x, w)
        assert c.flops == 2 * 16 * 32 * 16  # rank 0's 16 rows, not 64
        assert c.total_coll_bytes == 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_sampled_scan_counts_every_trip(arch, monkeypatch):
    """A recurrent prefill and a rematerialized train step over 12
    positions: the sampled scans (5 trips run) count the flops and bytes
    of a run of all 12 trips, and their flops equal FlopCounterMode's on
    the plain run."""
    cfg = configs.get(arch).reduced(remat=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    x = torch.zeros((2, 12), dtype=torch.int32)
    batch = {"inputs": x, "labels": x}
    ocfg = opt.AdamWConfig()

    def runs():
        with torch.no_grad():
            pre = hlo.analyze(T.prefill, params, cfg, x)
        train = hlo.analyze(tl.make_train_step(cfg, ocfg), _clone(params),
                            opt.init_state(ocfg, params), batch)
        return pre, train
    sampled = runs()
    monkeypatch.setattr(hlo, "SCAN_TRIPS", 12)
    full = runs()
    for (_, s, speak), (_, f, fpeak) in zip(sampled, full):
        assert s.flops == f.flops
        assert s.hbm_bytes == f.hbm_bytes
        assert abs(speak - fpeak) <= 0.1 * fpeak
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        T.prefill(params, cfg, x)
    assert fc.get_total_flops() == sampled[0][1].flops


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_sampled_partitioned_scan_counts_every_trip(arch, fake_group,
                                                    monkeypatch):
    """The partitioned prefill and rematerialized train step as the dry
    run builds them (rank 0 of a fake 4-rank group, mesh (2, 2), 4 rows of
    192 positions): the sampled scans over the rank's d_inner block or
    heads and the sampled row tiles of its projections (384 gathered rows,
    6 tiles) count the flops, bytes and collectives of a run of every trip
    and tile."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = configs.get(arch).reduced(remat=True)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    def runs():
        out = []
        for kind in ("prefill", "train"):
            shape = configs.InputShape("t", 192, 4, kind)
            with FakeTensorMode(), dsh.axis_rules(dsh.DEFAULT_RULES):
                step, args = dryrun.rank_program(cfg, shape, mesh,
                                                 torch.device("cpu"))
                with dsh.use_mesh(mesh), \
                        torch.set_grad_enabled(kind == "train"):
                    out.append(hlo.analyze(step, *args)[1])
        return out
    sampled = runs()
    monkeypatch.setattr(hlo, "SCAN_TRIPS", 10 ** 6)
    for s, f in zip(sampled, runs(), strict=True):
        assert s == f


def _clone(tree):
    return torch.utils._pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


# ------------------------------------------------------------ (d) flops
# Measured port / reference flop ratios at these sizes (B=2, S=512):
# qwen1.5-0.5b prefill 1.0, decode 1.0, train 1.0;
# yi-6b prefill 1.0, decode 1.0, train 1.0.
@pytest.mark.parametrize("arch", [QWEN, "yi-6b"])
def test_reduced_flops_against_the_reference(arch):
    B, S = 2, 512
    cfg, rcfg = configs.get(arch).reduced(), ref_configs.get(arch).reduced()
    rparams = RT.init_params(rcfg, jax.random.key(0))[0]
    toks = jnp.zeros((B, S), jnp.int32)

    def ref_flops(fn, *args):
        return rhlo.analyze(jax.jit(fn).lower(*args).compile().as_text()
                            ).flops
    rstate = RT.init_decode_state(rcfg, B, S)
    rocfg = ropt.AdamWConfig()
    ref = {"prefill": ref_flops(lambda p, t: RT.prefill(p, rcfg, t),
                                rparams, toks),
           "decode": ref_flops(
               lambda p, s, t: RT.decode_step(p, rcfg, s, t), rparams,
               rstate, toks[:, :1]),
           "train": ref_flops(rtl.make_train_step(rcfg, rocfg), rparams,
                              ropt.init_state(rocfg, rparams),
                              {"inputs": toks, "labels": toks})}
    params = T.init_params(cfg, seed=0, device="cpu")
    x = torch.zeros((B, S), dtype=torch.int32)
    with torch.no_grad():
        got = {"prefill": hlo.analyze(T.prefill, params, cfg, x)[1].flops,
               "decode": hlo.analyze(
                   T.decode_step, params, cfg,
                   T.init_decode_state(cfg, B, S, device="cpu"),
                   x[:, :1])[1].flops}
    ocfg = opt.AdamWConfig()
    got["train"] = hlo.analyze(
        tl.make_train_step(cfg, ocfg), params, opt.init_state(ocfg, params),
        {"inputs": x, "labels": x})[1].flops
    for k, tol in (("prefill", 0.02), ("decode", 0.02), ("train", 0.05)):
        assert got[k] == pytest.approx(ref[k], rel=tol), (k, got[k] / ref[k])


# ------------------------------------------------------------ (e), (h)
@pytest.fixture(scope="module")
def qwen_runs(tmp_path_factory):
    """qwen1.5-0.5b's three single-pod cells from the reference's dry run
    and the port's CLI, each in a subprocess, started together; meanwhile
    the per-rank programs' flops, each run alone without a mesh under
    ``FlopCounterMode``. -> (reference reports, port reports, port exit
    code, port output directory, port output, flops alone)."""
    ref_out = tmp_path_factory.mktemp("ref_dryrun")
    port_out = tmp_path_factory.mktemp("port_dryrun")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    args = ["--arch", QWEN, "--single-pod-only"]
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", *args, "--out",
         str(ref_out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    port = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--device",
         "cpu", "--out", str(port_out)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        alone = _flops_alone()
        ref_log = ref.communicate(timeout=300)[0]
        port_log = port.communicate(timeout=300)[0]
    finally:
        for p in (ref, port):
            p.kill()
    assert ref.returncode == 0, ref_log[-3000:]

    def reports(d):
        return {s: json.loads((d / f"{QWEN}_{s}_sp.json").read_text())
                for s in QWEN_SHAPES}
    return (reports(ref_out), reports(port_out), port.returncode,
            port_out, port_log, alone)


def _flops_alone() -> dict:
    """FlopCounterMode's count of each qwen cell's per-rank program: the
    partitioned train step, prefill and decode as the dry run builds them
    (``dryrun.rank_program``), on rank 0 of a fake 256-rank group under
    the cell's rules (``DEFAULT_RULES``, decode ``SERVE_RULES``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    cfg = configs.get(QWEN)
    shapes = {s.name: s for s in configs.runnable_shapes(cfg)}
    out = {}
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=256)
        try:
            mesh = make_production_mesh(device_type="cpu")
            with FakeTensorMode(), dsh.axis_rules(dryrun.cell_rules(
                    shapes[name], multi_pod=False)):
                step, args = dryrun.rank_program(
                    cfg, shapes[name], mesh, torch.device("cpu"))
                with dsh.use_mesh(mesh), \
                        FlopCounterMode(display=False) as fc, \
                        torch.set_grad_enabled(name == "train_4k"):
                    step(*args)
                del step, args
            out[name] = fc.get_total_flops()
        finally:
            dist.destroy_process_group()
    return out


def test_qwen_cells_agree_with_the_reference(qwen_runs):
    """The report fields that must agree, the key sets, each cell's flops
    against FlopCounterMode's count of its rank program (``_flops_alone``),
    the partitioned decode's collectives: per layer the all-gathers of q,
    k and v and of the attention output, two all-reduces of the log-sum-exp
    combine and those of the row-parallel ``wo`` and ``w2``, plus the
    embedding's all-reduce, no reduce-scatter (the activations are whole);
    and the partitioned prefill's: one reduce-scatter per row-parallel
    projection and one for the embedding, no all-reduce (nothing is
    replicated that a rank reduces)."""
    ref, port, rc, _, log, alone = qwen_runs
    assert rc == 0, log[-3000:]
    assert "dry-run: 3 ok / 0 failed / 0 skipped, 3 cells" in log
    for s in QWEN_SHAPES:
        r, p = ref[s], port[s]
        assert {k: p[k] for k in SAME} == {k: r[k] for k in SAME}, s
        assert set(p) == set(r) - {"xla_cost_analysis_flops_loop_once"}
        assert p["hlo_flops_per_device"] == alone[s], s
        assert p["n_chips"] == 256
    n_layers = configs.get(QWEN).n_layers
    assert port["decode_32k"]["collective_counts"] == {
        "all-gather": 4 * n_layers, "all-reduce": 4 * n_layers + 1}
    assert port["decode_32k"]["collective_bytes_per_device"] > 0
    counts = port["prefill_32k"]["collective_counts"]
    assert counts["reduce-scatter"] == 2 * n_layers + 1
    assert counts["all-gather"] > 0 and "all-reduce" not in counts


def test_qwen_partitioned_flops_near_the_reference(qwen_runs):
    """The partitioned train_4k and prefill_32k rank programs compute what
    the reference's rank does: flops per device within 0.8-1.3x of its
    dry run's (the data-parallel step computed 15.4x, the unpartitioned
    prefill 16x)."""
    ref, port = qwen_runs[:2]
    for s in ("train_4k", "prefill_32k"):
        ratio = (port[s]["hlo_flops_per_device"]
                 / ref[s]["hlo_flops_per_device"])
        assert 0.8 <= ratio <= 1.3, (s, ratio)
        assert port[s]["per_device_bytes"] <= 3 * ref[s]["per_device_bytes"]


def test_qwen_train_gathers_its_placed_parameters(qwen_runs):
    """The train cell's all-gathers, counted and in link bytes (result
    bytes x 15 / 16): each FSDP-sharded leaf gathered over "data" per
    layer, twice under remat (the forward and the backward's recompute),
    the embedding table and the head once; and the sequence of the
    activations (16 rows x 4096 positions x d_model) gathered over
    "model" before each of a layer's two column-parallel blocks, again in
    the recompute and in the backward of each of its two reduce-scatters,
    plus the embedding's reduce-scatter's backward and the loss's gather.
    qwen's 16 heads split evenly over 16 ranks: no leaf is gathered over
    "model"."""
    port = qwen_runs[1]["train_4k"]
    cfg = configs.get(QWEN)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    link, count = [], [0]

    def gathered(axes, leaf, times):
        spec = dsh.fit_spec_to_shape(dsh.spec_for(axes, mesh), leaf.shape,
                                     mesh)
        if "data" not in spec:
            return
        model = 16 if "model" in spec else 1
        size = leaf.numel() * leaf.element_size() / model
        link.append(times * size * 15 / 16)
        count[0] += times
    with FakeTensorMode(), dsh.axis_rules(dsh.DEFAULT_RULES):
        params = T.init_params(cfg, seed=0, device="cpu")
        specs = T.param_specs(cfg)
        for name in ("embed", "head"):
            gathered(specs["embed"][name], params["embed"][name], 1)
        for lspec, lp in zip(specs["layers"], params["layers"]):
            dsh.map_specs(lambda a, t: gathered(a, t, 2), lspec, lp)
    seq = 6 * cfg.n_layers + 2
    act = 16 * 4096 * cfg.d_model * 2
    want = sum(link) + seq * act * 15 / 16
    assert port["collective_counts"]["all-gather"] == count[0] + seq
    assert port["collective_breakdown"]["all-gather"] == pytest.approx(
        want, rel=1e-12)
    assert port["collective_bytes_per_device"] > want  # + grad reductions


def test_qwen_decode_flops_are_the_partitioned_work(qwen_runs):
    """The partitioned decode_32k rank computes its share and no more: its
    flops equal FlopCounterMode's count of the rank program and lie within
    1.0-1.15x of the count derived from the config (attention over the
    rank's 8 rows and 2,048 positions, every head; the body's projections
    on all 128 rows over 1/256 of the columns; the head on the rank's
    vocab block, 151,936 rows over "data" alone); at most 1.3x the
    reference's flops (GSPMD gathers the head and runs it whole on every
    device), a quarter of its collective bytes and 3x its peak."""
    ref, port, _, _, _, alone = qwen_runs
    r, p = ref["decode_32k"], port["decode_32k"]
    cfg = configs.get(QWEN)
    shape = {s.name: s for s in configs.runnable_shapes(cfg)}["decode_32k"]
    B, S, D, V = shape.global_batch, shape.seq_len, cfg.d_model, \
        cfg.vocab_size
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    mesh = AbstractMesh((16, 16), ("data", "model"))
    with dsh.axis_rules(dsh.SERVE_RULES):
        vspec = dsh.fit_spec_to_shape(dsh.spec_for(("vocab",), mesh), (V,),
                                      mesh)
    assert vspec == dsh.PartitionSpec("data")
    # the body's matmul weights: the active parameters but the embedding,
    # the head and each layer's two norm scales (``param_count``'s norms)
    body = cfg.active_param_count() - 2 * V * D - 2 * D * cfg.n_layers
    derived = (4 * B * S * H * hd * cfg.n_layers / 256
               + 2 * body * B / 256 + 2 * B * D * V / 16)
    flops = p["hlo_flops_per_device"]
    assert flops == alone["decode_32k"]
    assert 1.0 <= flops / derived <= 1.15, flops / derived
    assert flops <= 1.3 * r["hlo_flops_per_device"]
    assert p["collective_bytes_per_device"] <= \
        r["collective_bytes_per_device"] / 4
    assert p["per_device_bytes"] <= 3 * r["per_device_bytes"]


def test_cli_writes_the_reference_file_names(qwen_runs):
    out = qwen_runs[3]
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [f"{QWEN}_{s}_sp.json" for s in QWEN_SHAPES] + ["summary.json"])
    summary = json.loads((out / "summary.json").read_text())
    assert [r["shape"] for r in summary] == list(QWEN_SHAPES)
    assert all(r["status"] == "ok" for r in summary)


def test_cli_failing_cell_exits_1(monkeypatch, tmp_path, capsys):
    def boom(*a, **k):
        raise RuntimeError("injected")
    monkeypatch.setattr(dryrun, "dryrun_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", QWEN, "--shape", "decode_32k",
                     "--single-pod-only", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "dry-run: 0 ok / 1 failed / 0 skipped, 1 cells" in \
        capsys.readouterr().out
    (r,) = json.loads((tmp_path / "summary.json").read_text())
    assert r["status"] == "FAILED" and "injected" in r["error"]


def test_no_group_is_left_open(monkeypatch):
    r = dryrun.dryrun_cell(QWEN, "decode_32k", multi_pod=True,
                           device="cpu", verbose=False)
    assert not dist.is_initialized()
    assert r["status"] == "ok" and r["n_chips"] == 512
    assert r["collective_bytes_per_device"] > 0  # the partitioned decode

    def boom(*a, **k):
        raise RuntimeError("injected")
    monkeypatch.setattr(dryrun, "rank_program", boom)
    with pytest.raises(RuntimeError, match="injected"):
        dryrun.dryrun_cell(QWEN, "decode_32k", multi_pod=False,
                           device="cpu", verbose=False)
    assert not dist.is_initialized()
    skipped = dryrun.dryrun_cell(QWEN, "long_500k", multi_pod=False,
                                 device="cpu", verbose=False)
    assert skipped["status"] == "skipped"


# ------------------------------------------------------------ (f), (g)
# collectives of one decode step of a layer, by kind: (all-gathers,
# all-reduces) where the batch is whole on every rank, and the all-gathers
# that a batch split over "data" adds (the rows gathered for a row-parallel
# product or a token shift). attention: q, k, v (+ its output) / the
# combine's max and sums, wo, the FFN's; mamba: in_proj's and dt_proj's
# columns (+ the conv's and the scan's outputs) / x_proj, out_proj, the
# FFN's; rwkv: r/k/v/g's columns (+ x_prev, the scan's output, cm_prev) /
# wo, the channel-mix's wv
DECODE_COLLECTIVES = {"attn": (3, 1, 4), "mamba": (2, 2, 3),
                      "rwkv": (4, 3, 2)}


def _decode_counts(cfg, rows_split: bool) -> dict:
    """The partitioned decode's collectives per step: one all-reduce for
    the embedding and ``DECODE_COLLECTIVES`` per layer."""
    kinds = [T.block_kind(cfg, i) for i in range(cfg.n_layers)]
    return {"all-gather": sum(DECODE_COLLECTIVES[k][0] + rows_split
                              * DECODE_COLLECTIVES[k][1] for k in kinds),
            "all-reduce": 1 + sum(DECODE_COLLECTIVES[k][2] for k in kinds)}


@pytest.mark.parametrize("arch,shape", [
    ("phi3.5-moe-42b", "decode_32k"),
    ("jamba-1.5-large-398b", "long_500k"),
    ("rwkv6-3b", "long_500k"),
    ("hubert-xlarge", "prefill_32k"),
])
def test_one_cell_per_family_at_published_width(arch, shape):
    """Every family's cells run the partitioned programs: the rank holds
    its placed shards (a prefill gathers them a layer at a time), not the
    whole weights; a decode moves activations only (``long_500k``'s one
    row whole on every rank, decode_32k's 128 split over "data"); a
    prefill reduce-scatters each layer's two row-parallel outputs."""
    r = dryrun.dryrun_cell(arch, shape, multi_pod=False, device="cpu",
                           verbose=False)
    assert r["status"] == "ok"
    assert r["hlo_flops_per_device"] > 0 and r["per_device_bytes"] > 0
    cfg = configs.get(arch)
    assert T.partitioned(cfg)
    assert r["per_device_bytes"] < 2 * cfg.param_count()
    if shape in ("decode_32k", "long_500k"):
        assert r["collective_counts"] == _decode_counts(
            cfg, rows_split=shape == "decode_32k")
    else:
        assert r["collective_counts"]["reduce-scatter"] == \
            2 * cfg.n_layers


# ------------------------------------------------------------ recurrent
RECURRENT = ("jamba-1.5-large-398b", "rwkv6-3b")


@pytest.fixture(scope="module")
def recurrent_sweep(tmp_path_factory):
    """Every cell of jamba-1.5-large-398b and rwkv6-3b on 16x16 and
    2x16x16 from the port's CLI in a subprocess (2 cells at once), started
    at the first test that asks. -> the reports."""
    out = tmp_path_factory.mktemp("recurrent_sweep")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         ",".join(RECURRENT), "--device", "cpu", "--jobs", "2", "--out",
         str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads((out / "summary.json").read_text())


def test_recurrent_cells_fit_a_card(recurrent_sweep):
    """jamba's and rwkv6-3b's 16 cells run the partitioned programs on
    fake tensors and each fits the card's 80 GB (the data-parallel step
    and the replicated serve weights took 191.6 GiB for rwkv6-3b's
    train_4k and 748-2,200 GiB for jamba's cells); each report records
    its flops and collective bytes, and a decode moves activations only
    (``_decode_counts``)."""
    want = {(a, s.name, mp) for a in RECURRENT
            for s in configs.runnable_shapes(configs.get(a))
            for mp in (False, True)}
    assert {(r["arch"], r["shape"], r["multi_pod"])
            for r in recurrent_sweep} == want and len(want) == 16
    for r in recurrent_sweep:
        cell = (r["arch"], r["shape"], r["multi_pod"])
        assert r["status"] == "ok" and r["fits_hbm"], cell
        assert r["per_device_bytes"] <= dryrun.HBM_PER_CHIP, cell
        assert r["hlo_flops_per_device"] > 0, cell
        assert r["collective_bytes_per_device"] > 0, cell
        if r["kind"] == "decode":
            assert r["collective_counts"] == _decode_counts(
                configs.get(r["arch"]), rows_split=r["shape"] != "long_500k")


# ------------------------------------------------------------ MoE cells
PHI = "phi3.5-moe-42b"


@pytest.fixture(scope="module")
def phi_runs(tmp_path_factory):
    """phi3.5-moe-42b's three single-pod cells: the reference's dry run in
    a subprocess and, meanwhile, the port's ``dryrun_cell`` in this
    process. -> (reference reports, port reports), by shape."""
    ref_out = tmp_path_factory.mktemp("ref_phi")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", PHI,
         "--single-pod-only", "--out", str(ref_out)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = {s: dryrun.dryrun_cell(PHI, s, multi_pod=False, device="cpu",
                                      verbose=False) for s in QWEN_SHAPES}
        ref_log = ref.communicate(timeout=300)[0]
    finally:
        ref.kill()
    assert ref.returncode == 0, ref_log[-3000:]
    return ({s: json.loads((ref_out / f"{PHI}_{s}_sp.json").read_text())
             for s in QWEN_SHAPES}, port)


def _phi_exact_flops(shape_name: str) -> float:
    """The matmul flops of phi3.5-moe-42b's rank on 16x16, from the config:
    a train / prefill rank (DEFAULT_RULES) takes 1/16 of the rows and
    computes, over the whole gathered sequence, q/k/v/o for its 2 of 32
    heads (its one K/V head of 8, gathered) and attention over every key
    chunk; the router on every position; its one expert of 16 on
    ``B n_groups cap`` dispatch rows (``layers.moe_dispatch_rows``, the
    reference's capacity rule), 3 products of 2 D F; the head on
    its 1/16 of the vocab (a prefill's last position; a train step's
    every position, the vocab-parallel loss). A prefill also projects
    every K/V head of its sequence block into its cache. A train step
    counts its layers and its loss 4 times (the forward, remat's
    recompute and the backward's two products). A decode rank
    (SERVE_RULES) attends over its 8 rows and 2,048 positions with every
    head, runs the attention projections on all 128 rows over 1/256 of
    their columns, the router on every row, its one expert of 16
    (the experts peel to "data") on ``cap`` rows of the batch's one
    dispatch group, and the head on 1/16 of the vocab (over "data")."""
    cfg = configs.get(PHI)
    shape = {s.name: s for s in configs.runnable_shapes(cfg)}[shape_name]
    n, D, H, K = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, F, V, E = cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, \
        cfg.n_experts
    m = 16
    if shape.kind == "decode":
        B, S = shape.global_batch, shape.seq_len
        body = D * H * hd + 2 * D * K * hd + H * hd * D
        return (4 * B * S * H * hd * n / (m * m) + 2 * body * B * n / (m * m)
                + n * (E // m * L.moe_dispatch_rows(cfg, B, 1) * 3 * 2 * D * F
                       + 2 * B * D * E) + 2 * B * D * V / m)
    B, S = shape.global_batch // m, shape.seq_len
    hl = H // m
    layer = (2 * B * S * D * hl * hd + 2 * 2 * B * S * D * hd
             + 4 * B * S * S * hl * hd + 2 * B * S * hl * hd * D
             + 2 * B * S * D * E
             + E // m * L.moe_dispatch_rows(cfg, B, S) * 3 * 2 * D * F)
    if shape.kind == "prefill":
        cache = 2 * 2 * B * (S // m) * D * K * hd
        return n * (layer + cache) + 2 * B * D * V / m
    return 4 * (n * layer + 2 * B * S * D * V / m)


def test_phi_cells_are_expert_parallel(phi_runs):
    """phi3.5-moe-42b's single-pod cells run the partitioned programs and
    fit a card: the train and prefill ranks reduce-scatter each layer's
    attention and MoE outputs (and the prefill its embedding), the decode
    rank moves activations only; each rank's flops are 1.0-1.15x the count
    derived from the config (``_phi_exact_flops``)."""
    port = phi_runs[1]
    cfg = configs.get(PHI)
    n = cfg.n_layers
    assert T.partitioned(cfg)
    for s in QWEN_SHAPES:
        r = port[s]
        assert r["status"] == "ok" and r["fits_hbm"], s
        ratio = r["hlo_flops_per_device"] / _phi_exact_flops(s)
        assert 1.0 <= ratio <= 1.15, (s, ratio)
    assert port["prefill_32k"]["collective_counts"]["reduce-scatter"] == \
        2 * n + 1
    assert port["train_4k"]["collective_counts"]["reduce-scatter"] > 2 * n
    assert port["decode_32k"]["collective_counts"] == {
        "all-gather": 4 * n, "all-reduce": 4 * n + 1}


def test_phi_cells_near_the_reference(phi_runs):
    """Against the reference's dry run of the same cells: train and
    prefill flops a device within 0.8-1.3x (the reference's GSPMD splits
    the experts over "model" too), decode at most 1.3x (the reference
    gathers the experts it does not hold); every peak at most 3x."""
    ref, port = phi_runs
    for s in QWEN_SHAPES:
        ratio = port[s]["hlo_flops_per_device"] / ref[s][
            "hlo_flops_per_device"]
        assert ratio <= 1.3, (s, ratio)
        if s != "decode_32k":
            assert ratio >= 0.8, (s, ratio)
        assert port[s]["per_device_bytes"] <= 3 * ref[s]["per_device_bytes"]


def test_110b_decode_reports_without_allocating():
    """The partitioned decode of qwen1.5-110b fits a card (weights and the
    cache's block of 8 rows by 2,048 positions: ~6 GB; replicated weights
    took 289 GiB) and the fake run allocates none of it."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    r = dryrun.dryrun_cell("qwen1.5-110b", "decode_32k", multi_pod=False,
                           device="cpu", verbose=False)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert r["per_device_bytes"] < 10e9 and r["fits_hbm"]
    assert grown * 1024 < 2e9  # ru_maxrss is in KiB


def test_train_step_with_more_micro_batches_than_rows():
    """A rank's slice with fewer rows than micro-batches (llama4's 256
    rows over the multi-pod mesh's 32 batch ranks in 16 micro-batches)
    takes one row a micro-batch: the step equals the step with as many
    micro-batches as rows, bit for bit."""
    base = configs.get(QWEN).reduced()
    x = torch.randint(0, base.vocab_size, (2, 8),
                      generator=torch.Generator().manual_seed(0))
    batch = {"inputs": x, "labels": x}
    ocfg = opt.AdamWConfig()
    outs = []
    for n in (4, 2):
        cfg = dataclasses.replace(base, micro_batches=n)
        p = T.init_params(cfg, seed=0, device="cpu")
        p, _, m = tl.make_train_step(cfg, ocfg)(p, opt.init_state(ocfg, p),
                                                batch)
        outs.append((m["loss"], torch.utils._pytree.tree_leaves(p)))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1], strict=True):
        assert torch.equal(a, b)


def test_sampled_micro_batches_count_every_one(monkeypatch):
    """A train step in 4 micro-batches: running 2 and counting the second
    twice more gives the flops, bytes and peak of running all 4."""
    cfg = dataclasses.replace(configs.get(QWEN).reduced(), micro_batches=4)
    params = T.init_params(cfg, seed=0, device="cpu")
    x = torch.zeros((4, 16), dtype=torch.int32)
    ocfg = opt.AdamWConfig()

    def run():
        return hlo.analyze(tl.make_train_step(cfg, ocfg), _clone(params),
                           opt.init_state(ocfg, params),
                           {"inputs": x, "labels": x})
    _, sampled, speak = run()
    monkeypatch.setattr(hlo, "MICRO_STEPS", 4)
    _, full, fpeak = run()
    assert sampled == full
    assert speak == fpeak
