"""The train step and loop: micro-batched gradient accumulation, AdamW,
logging.

Port of ``repro.train.train_loop``. ``make_train_step`` is the one train
step: one ``torch.autograd.grad`` of the loss over the parameter leaves per
micro-batch, then ``optimizer.apply_updates`` in place. With
``cfg.micro_batches > 1`` the batch splits on its leading axis, the
gradients accumulate in ``cfg.opt_state_dtype`` and are divided by the
micro-batch count, and the loss is the micro-batches' mean, as the
reference's ``lax.scan`` does; with one micro-batch the gradients keep the
parameters' dtype. Activation memory is bounded by ``cfg.remat``
(``transformer.forward_hidden`` recomputes each layer in the backward) and
by ``lm_loss``'s checkpointed logits chunks.

Batches stay on the host until the loop moves them to the parameters'
device; ``train`` times each step to a device synchronisation on the loss.

Under a mesh (``repro_torch.dist.use_mesh``) the step is data-parallel,
the counterpart of the reference's gradients pinned to the parameter
shardings (``train_loop.py:36-43``) plus GSPMD's batch-sharded reduction.
Parameters and optimizer state are DTensors placed by ``param_specs`` /
``state_specs`` (``dist.place``). Each step gathers full plain leaves,
takes this rank's slice of the batch along the mesh axes ``"batch"``
resolves to (``"data"`` under ``DEFAULT_RULES``, ``("pod", "data")``
under ``MULTIPOD_RULES``), runs the forward and backward above unchanged
(remat and micro-batches included), and reduces each gradient
explicitly: a ``Partial("avg")`` over the batch axes redistributed to the
parameter's placements, a reduce-scatter into an FSDP shard and an
all-reduce where the leaf is replicated (DTensor's backward of
``full_tensor()`` reduces nothing: it assumes every rank computed the same
thing). The loss is averaged over the batch ranks, and AdamW runs on the
DTensor leaves. Compute is not tensor-parallel: every rank runs the whole
model on its slice of the batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as dsh
from repro_torch.models import transformer as T
from repro_torch.train import _tree
from repro_torch.train import optimizer as opt


def make_grad_fn(cfg: ArchConfig, loss_fn: Callable | None = None
                 ) -> Callable:
    """(params, batch) -> (loss, grads): the train step's gradients, over
    ``cfg.micro_batches`` micro-batches; under a mesh, this rank's part of
    the data-parallel step (module docstring). ``params`` is not modified
    (its leaves' ``requires_grad`` included)."""
    loss_fn = loss_fn or (lambda p, b: T.lm_loss(p, cfg, b))
    n_micro = max(1, cfg.micro_batches)
    acc_dt = getattr(torch, cfg.opt_state_dtype)

    def grads_of(params, batch):
        # leaves that alias the parameters' storage and record autograd
        flat = [p.detach().requires_grad_(True)
                for p in _tree.leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_tree.unflatten(params, flat), batch)
            g = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(g)

    def local_grad_fn(params, batch):
        if n_micro == 1:
            loss, grads = grads_of(params, batch)
            return loss, _tree.unflatten(params, grads)
        mb = next(iter(batch.values())).shape[0] // n_micro
        gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                for p in _tree.leaves(params)]
        lsum = None
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = grads_of(params, micro)
            for a, b in zip(gsum, g):
                a.add_(b.to(acc_dt))
            lsum = loss if lsum is None else lsum + loss
        grads = [(a / n_micro).to(acc_dt) for a in gsum]
        return lsum / n_micro, _tree.unflatten(params, grads)

    def grad_fn(params, batch):
        mesh = dsh.active_mesh()
        if mesh is None:
            return local_grad_fn(params, batch)
        return _data_parallel(local_grad_fn, mesh, params, batch)

    return grad_fn


def _plain(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _batch_dims(mesh) -> list[int]:
    """The mesh dims that the logical ``"batch"`` axis resolves to under
    the bound rules (none: every rank takes the whole batch)."""
    spec = dsh.spec_for(("batch",), mesh)
    if not spec:
        return []
    axes = (spec[0],) if isinstance(spec[0], str) else spec[0]
    return [mesh.mesh_dim_names.index(a) for a in axes]


def _data_parallel(local_grad_fn, mesh, params, batch):
    """One rank's part of the data-parallel gradient (module docstring):
    (the loss averaged over the batch ranks, gradients placed as the
    parameters are; a plain parameter leaf counts as replicated and gets
    a plain gradient)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dims = _batch_dims(mesh)
    n, idx = 1, 0
    coord = mesh.get_coordinate()
    for d in dims:  # major first, as the batch dim is sharded
        n, idx = n * mesh.shape[d], idx * mesh.shape[d] + coord[d]
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{n} batch ranks")
    per = rows // n
    local_batch = {k: v[idx * per:(idx + 1) * per] for k, v in batch.items()}
    leaves = _tree.leaves(params)
    full = [_plain(p) for p in leaves]
    loss, grads = local_grad_fn(_tree.unflatten(params, full), local_batch)
    del full
    reduce = [Partial("avg") if d in dims else Replicate()
              for d in range(mesh.ndim)]
    out = []
    for p, g in zip(leaves, _tree.leaves(grads), strict=True):
        target = (p.placements if isinstance(p, DTensor)
                  else [Replicate()] * mesh.ndim)
        gd = DTensor.from_local(g, mesh, reduce, run_check=False
                                ).redistribute(mesh, target)
        out.append(gd if isinstance(p, DTensor) else gd.to_local())
    loss = DTensor.from_local(loss, mesh, reduce, run_check=False
                              ).full_tensor()
    return loss, _tree.unflatten(params, out)


def make_train_step(cfg: ArchConfig, opt_cfg: opt.AdamWConfig,
                    loss_fn: Callable | None = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters and the optimizer state are updated in place."""
    grad_fn = make_grad_fn(cfg, loss_fn)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        new_p, new_o, metrics = opt.apply_updates(opt_cfg, params, grads,
                                                  opt_state)
        if dsh.active_mesh() is not None:  # plain scalars for the caller
            metrics = {k: _plain(v) for k, v in metrics.items()}
        return new_p, new_o, dict(metrics, loss=loss)

    return train_step


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def to_device(batch: dict, params: Any) -> dict:
    """The batch's tensors on the parameters' device."""
    dev = _tree.leaves(params)[0].device
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def sync(t: torch.Tensor) -> None:
    """Wait for the device that holds ``t`` (no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def train(cfg: ArchConfig,
          opt_cfg: opt.AdamWConfig,
          data_iter: Iterator[dict],
          *,
          num_steps: int,
          state: TrainState | None = None,
          jitted_step: Callable | None = None,
          hooks: list[Callable] | None = None,
          log_every: int = 10,
          device=None) -> TrainState:
    """Synchronous training loop (one process, one device).

    Without ``state`` the weights come from ``transformer.init_params(cfg,
    seed=0, device=device)`` (the card unless ``device`` names another).
    ``jitted_step`` keeps the reference's name for a prepared step
    function, by default ``make_train_step(cfg, opt_cfg)``. ``hooks`` are
    called as ``hook(state, metrics, step_time)`` after each step —
    checkpointing, straggler monitoring and eval plug in here.
    """
    if state is None:
        params = T.init_params(cfg, seed=0, device=device)
        state = TrainState(params, opt.init_state(opt_cfg, params), 0)
    step_fn = jitted_step or make_train_step(cfg, opt_cfg)
    hooks = hooks or []
    for _ in range(num_steps):
        batch = to_device(next(data_iter), state.params)
        t0 = time.monotonic()
        state.params, state.opt_state, metrics = step_fn(
            state.params, state.opt_state, batch)
        sync(metrics["loss"])
        dt = time.monotonic() - t0
        state.step += 1
        for h in hooks:
            h(state, metrics, dt)
        if log_every and state.step % log_every == 0:
            print(f"step {state.step}: loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt*1e3:.0f} ms)")
    return state
