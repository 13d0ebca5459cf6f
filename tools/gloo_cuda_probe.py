"""Which collectives a ``gloo`` group runs on CUDA tensors, and which aten
ops the functional collectives' autograd variants dispatch.

``dist/parallel.py`` stages a collective's payload through host memory on
a backend that lacks a device implementation of it. That choice is a
table in the code (``parallel.GLOO_DEVICE_OPS``), never the result of
catching an error; this script is where the table's entries come from.
It opens a fresh two-rank ``gloo`` group on ``cuda:0`` for each op (one
failing op cannot spoil the next), runs the op on CUDA tensors and checks
its values, then prints one JSON line per op and a summary line. It also
prints the torch and CUDA versions and the ops that
``all_gather_tensor_autograd`` / ``reduce_scatter_tensor_autograd`` /
``all_reduce`` dispatch under a fake process group, forward and backward
(``launch/hlo_analysis.py`` counts one collective for each).

Usage (on a machine with a card): ``python3 tools/gloo_cuda_probe.py``
"""

from __future__ import annotations

import datetime
import json
import multiprocessing
import os
import sys
import tempfile
import warnings

OPS = ("all_gather_dim0", "all_gather_dim1", "reduce_scatter_dim0",
       "reduce_scatter_dim1", "all_reduce_sum", "all_reduce_max")


def _one(op: str, rank: int, store: str, q) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    warnings.simplefilter("ignore")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=20))
    g = dist.group.WORLD
    x = (torch.arange(8.0, device="cuda:0").reshape(4, 2) + 10 * rank)
    try:
        if op.startswith("all_gather"):
            d = int(op[-1])
            y = fc.wait_tensor(fc.all_gather_tensor(x, d, g))
            want = torch.cat([x - 10 * rank, x - 10 * rank + 10], dim=d)
        elif op.startswith("reduce_scatter"):
            d = int(op[-1])
            y = fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", d, g))
            full = 2 * (x - 10 * rank) + 10
            want = full.chunk(2, dim=d)[rank]
        else:
            red = op.rsplit("_", 1)[1]
            y = fc.wait_tensor(fc.all_reduce(x, red, g))
            base = x - 10 * rank
            want = 2 * base + 10 if red == "sum" else base + 10
        ok = y.is_cuda and torch.equal(y, want)
        res = dict(op=op, ran=True, device=str(y.device), values_ok=bool(ok))
    except Exception as e:  # a probe: the program never decides this way
        res = dict(op=op, ran=False,
                   error=f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
    if rank == 0:
        q.put(res)
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def _probe(op: str) -> dict:
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_one, args=(op, r, store, q))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if not q.empty():
        return q.get()
    return dict(op=op, ran=False, error="no result",
                exit_codes=[p.exitcode for p in procs])


def _autograd_ops() -> dict:
    """The ops that the functional collectives' autograd variants
    dispatch, forward and backward, on a fake 4-rank group."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils._python_dispatch import TorchDispatchMode
    warnings.simplefilter("ignore")
    seen: list = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "c10d" in str(func):
                seen.append(str(func))
            return func(*args, **(kwargs or {}))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    out = {}
    try:
        g = dist.group.WORLD
        for name, fn in (
                ("all_gather_tensor_autograd",
                 lambda t: fc.all_gather_tensor_autograd(t, 0, g)),
                ("reduce_scatter_tensor_autograd",
                 lambda t: fc.reduce_scatter_tensor_autograd(t, "sum", 0, g)),
                ("all_reduce", lambda t: fc.all_reduce(t, "sum", g))):
            seen.clear()
            x = torch.ones(8, 4, requires_grad=True)
            with Log():
                y = fc.wait_tensor(fn(x))
                fwd = list(seen)
                seen.clear()
                try:
                    y.backward(torch.ones_like(y))
                    bwd = list(seen)
                except Exception as e:
                    bwd = [f"{type(e).__name__}: {str(e).splitlines()[0]}"]
            out[name] = dict(forward=fwd, backward=bwd)
    finally:
        dist.destroy_process_group()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          python=sys.version.split()[0],
                          device=torch.cuda.get_device_name(0))), flush=True)
    results = [_probe(op) for op in OPS]
    for r in results:
        print(json.dumps(r), flush=True)
    print(json.dumps({"autograd_ops": _autograd_ops()}), flush=True)
    print(json.dumps({"gloo_cuda_ok": sorted(
        r["op"] for r in results if r.get("values_ok"))}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
