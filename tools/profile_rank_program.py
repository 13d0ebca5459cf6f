"""One dry-run cell's per-rank program on the card, timed and profiled.

Builds the rank program as ``repro_torch.launch.dryrun.rank_program`` does
(weights from seed 0, zeroed caches and inputs, rank 0 of a fake 256-rank
group on the 16x16 mesh) and runs it for real: a few warm-up runs, then
``--runs`` runs timed by CUDA events beside the host's enqueue time, then
one run under ``torch.profiler``. It prints the card's name and power
limit, each run's event and host ms, the device time of the profiled run
and the share of it that is device-to-device copies (the fake group
emulates an all-gather with one copy per rank of the group), and the
profiler's tables by device time and by host time.

Needs the card. Usage, from the repository root:

  python3 tools/profile_rank_program.py --arch qwen1.5-0.5b --shape decode_32k
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch import configs
    from repro_torch.dist import sharding as dsh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    if not torch.cuda.is_available():
        raise SystemExit("profile_rank_program: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = configs.get(args.arch)
    shape = {s.name: s for s in configs.ALL_SHAPES}[args.shape]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_production_mesh(device_type="cuda")
        with dsh.axis_rules(dryrun.cell_rules(shape, multi_pod=False)):
            step, a = dryrun.rank_program(cfg, shape, mesh, "cuda")
            with dsh.use_mesh(mesh), \
                    torch.set_grad_enabled(shape.kind == "train"):
                for _ in range(3):
                    step(*a)
                torch.cuda.synchronize()
                runs = []
                for _ in range(args.runs):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    e0.record()
                    step(*a)
                    e1.record()
                    host = time.perf_counter() - t0
                    torch.cuda.synchronize()
                    runs.append((round(e0.elapsed_time(e1), 3),
                                 round(host * 1e3, 3)))
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    step(*a)
                    torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    from torch.autograd import DeviceType
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    dtod = sum(e.self_device_time_total for e in kernels
               if e.key.startswith("Memcpy DtoD")) / 1e3
    print(f"{args.arch} {args.shape}: runs (event ms, host ms) {runs}")
    print(f"profiled run: device {device:.3f} ms, of it device-to-device "
          f"copies {dtod:.3f} ms, the rest {device - dtod:.3f} ms")
    print(ev.table(sort_by="self_device_time_total", row_limit=15))
    print(ev.table(sort_by="self_cpu_time_total", row_limit=10))


if __name__ == "__main__":
    main()
