"""Fault tolerance: restart, elasticity, stragglers.

Port of ``repro.train.fault_tolerance``:

1. **Checkpoint/restart** — ``resilient_train`` wraps the train loop:
   periodic async checkpoints, restore-on-start, and a bounded retry loop
   around step execution, so a transient failure resumes from the last
   checkpoint instead of ending the job.

2. **Elasticity** — checkpoints hold host arrays and restore onto the
   devices of the tree they are loaded into (``checkpoint.restore``);
   ``elastic_data_axis`` picks the largest usable data-parallel degree for
   the surviving devices.

3. **Straggler detection** — ``StragglerMonitor`` keeps a running median
   of step time and flags steps slower than a threshold multiple of it. On
   one host the signal is printed and counted.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Iterator

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl


# ------------------------------------------------------------- stragglers
@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps slower than ``threshold`` x the running median."""
    threshold: float = 3.0
    window: int = 50
    min_samples: int = 5
    times: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= self.min_samples:
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                is_straggler = True
                self.events.append((step, dt, med))
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return is_straggler

    def hook(self):
        def _h(state, metrics, dt):
            if self.observe(state.step, dt):
                print(f"[straggler] step {state.step}: {dt*1e3:.0f} ms "
                      f"(median {statistics.median(self.times)*1e3:.0f} ms)")
        return _h


# ------------------------------------------------------------- elasticity
def elastic_data_axis(n_devices: int, model_parallel: int) -> int:
    """Largest data-parallel degree for the surviving device count."""
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot hold model-parallel degree "
            f"{model_parallel}")
    return n_devices // model_parallel


# ------------------------------------------------------------- restart loop
def resilient_train(cfg: ArchConfig,
                    opt_cfg: opt.AdamWConfig,
                    data_fn: Callable[[int], Iterator[dict]],
                    *,
                    num_steps: int,
                    ckpt_dir: str,
                    ckpt_every: int = 50,
                    max_restarts: int = 3,
                    monitor: StragglerMonitor | None = None,
                    fail_injector: Callable[[int], None] | None = None,
                    device=None) -> tl.TrainState:
    """Train with periodic async checkpoints and restore-on-failure, on
    ``device`` (the card unless it names another).

    ``data_fn(start_step)`` rebuilds the (deterministic) data stream from a
    step offset so restarts do not replay or skip batches.
    ``fail_injector(step)`` lets tests raise mid-run to exercise recovery.
    A ``RuntimeError``, ``ValueError`` or ``OSError`` restarts from the
    last checkpoint, at most ``max_restarts`` times.
    """
    saver = ckpt.AsyncCheckpointer(ckpt_dir)
    monitor = monitor or StragglerMonitor()
    restarts = 0

    while True:
        # ---- (re)build state: restore if a checkpoint exists
        params = T.init_params(cfg, seed=0, device=device)
        opt_state = opt.init_state(opt_cfg, params)
        state = tl.TrainState(params, opt_state, 0)
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            (state.params, state.opt_state), step, _ = ckpt.restore(
                ckpt_dir, (state.params, state.opt_state))
            state.step = step
            print(f"[restart] resumed from step {step}")
        step_fn = tl.make_train_step(cfg, opt_cfg)
        data_iter = data_fn(state.step)

        def hook(st, metrics, dt):
            monitor.hook()(st, metrics, dt)
            if st.step % ckpt_every == 0:
                saver.save(st.step, (st.params, st.opt_state))

        try:
            while state.step < num_steps:
                batch = tl.to_device(next(data_iter), state.params)
                if fail_injector is not None:
                    fail_injector(state.step)
                t0 = time.monotonic()
                state.params, state.opt_state, metrics = step_fn(
                    state.params, state.opt_state, batch)
                tl.sync(metrics["loss"])
                state.step += 1
                hook(state, metrics, time.monotonic() - t0)
            saver.wait()
            saver.save(state.step, (state.params, state.opt_state))
            saver.wait()
            return state
        except (RuntimeError, ValueError, OSError) as e:
            restarts += 1
            print(f"[failure] step {state.step}: {e!r} "
                  f"(restart {restarts}/{max_restarts})")
            saver.wait()
            if restarts > max_restarts:
                raise
