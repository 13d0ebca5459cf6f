"""The train step and loop: micro-batched gradient accumulation, AdamW,
logging.

Port of ``repro.train.train_loop``. ``make_train_step`` is the one train
step: one ``torch.autograd.grad`` of the loss over the parameter leaves per
micro-batch, then ``optimizer.apply_updates`` in place. With
``cfg.micro_batches > 1`` the batch splits on its leading axis (into one
row each where it holds fewer rows than micro-batches), the
gradients accumulate in ``cfg.opt_state_dtype`` and are divided by the
micro-batch count, and the loss is the micro-batches' mean, as the
reference's ``lax.scan`` does; with one micro-batch the gradients keep the
parameters' dtype. Activation memory is bounded by ``cfg.remat``
(``transformer.forward_hidden`` recomputes each layer in the backward) and
by ``lm_loss``'s checkpointed logits chunks.

Batches stay on the host until the loop moves them to the parameters'
device; ``train`` times each step to a device synchronisation on the loss.

Under a mesh (``repro_torch.dist.use_mesh``), with parameters and
optimizer state placed as DTensors by ``param_specs`` / ``state_specs``
(``dist.place``), the step is partitioned: the counterpart of the
reference's step jitted with ``in_shardings`` (GSPMD's FSDP, tensor and
sequence parallelism). Each rank takes its slice of the batch along the
mesh axes ``"batch"`` resolves to (``"data"`` under ``DEFAULT_RULES``,
``("pod", "data")`` under ``MULTIPOD_RULES``): a slice of the whole batch,
or the local blocks of a batch placed along its rows (``_local_rows``).
It runs ``lm_loss`` on its parameters' local blocks under a
``dist.parallel.Partition`` (remat and micro-batches included): there is
no ``full_tensor()`` of the parameters.
The collectives' backward leaves each gradient as a local block in its
parameter's placements; ``Partition.reduce_grad`` sums it over the mesh
dims on which the parameter is replicated, it is divided by the batch
ranks, and ``DTensor.from_local`` wraps it. The loss is averaged over the
batch ranks, and AdamW runs on the DTensor leaves. A MoE FFN runs expert
parallel: each rank computes its experts' blocks, gathered over FSDP
alone, and the replicated router's gradient is summed over the mesh like
any replicated leaf's. Mamba and rwkv layers run their recurrences on the
rank's d_inner block or whole heads over the gathered sequence
(``models.ssm``).

Plain (unplaced) parameters under a mesh, and a custom ``loss_fn`` (the
partitioned step computes ``lm_loss``), take the data-parallel step
(``_data_parallel``): each rank gathers full plain leaves, runs the whole
model on its slice of the batch, and reduces each gradient to its
parameter's placements (a ``Partial("avg")`` over the batch axes
redistributed).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import parallel
from repro_torch.dist import sharding as dsh
from repro_torch.models import transformer as T
from repro_torch.train import _tree
from repro_torch.train import optimizer as opt


# (micro_step, n) -> None, calling micro_step(i) for the micro-batches
# i < n in order; None calls every one. A cost count may set a loop of its
# own (``launch.hlo_analysis`` runs two and counts the second once more for
# each later one: micro-batches are alike in shape).
MICRO_LOOP = None


def _each(micro_step: Callable, n: int) -> None:
    for i in range(n):
        micro_step(i)


def make_grad_fn(cfg: ArchConfig, loss_fn: Callable | None = None
                 ) -> Callable:
    """(params, batch) -> (loss, grads): the train step's gradients, over
    ``cfg.micro_batches`` micro-batches; under a mesh, this rank's part of
    the partitioned (or data-parallel) step (module docstring). ``params``
    is not modified (its leaves' ``requires_grad`` included)."""
    custom = loss_fn is not None
    loss_fn = loss_fn or (lambda p, b: T.lm_loss(p, cfg, b))
    n_micro = max(1, cfg.micro_batches)
    acc_dt = getattr(torch, cfg.opt_state_dtype)

    def grads_of(params, batch, loss_fn):
        # leaves that alias the parameters' storage and record autograd
        flat = [p.detach().requires_grad_(True)
                for p in _tree.leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_tree.unflatten(params, flat), batch)
            g = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(g)

    def local_grad_fn(params, batch, loss_fn=loss_fn):
        if n_micro == 1:
            loss, grads = grads_of(params, batch, loss_fn)
            return loss, _tree.unflatten(params, grads)
        rows = next(iter(batch.values())).shape[0]
        # a rank's slice may hold fewer rows than micro-batches (256 rows
        # over 32 batch ranks in 16 micro-batches): one row each then
        n = min(n_micro, rows)
        mb = rows // n
        gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                for p in _tree.leaves(params)]
        lsum = [None]

        def micro_step(i):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = grads_of(params, micro, loss_fn)
            for a, b in zip(gsum, g):
                a.add_(b.to(acc_dt))
            lsum[0] = loss if lsum[0] is None else lsum[0] + loss
        (MICRO_LOOP or _each)(micro_step, n)
        grads = [(a / n).to(acc_dt) for a in gsum]
        return lsum[0] / n, _tree.unflatten(params, grads)

    def grad_fn(params, batch):
        mesh = dsh.active_mesh()
        if mesh is None:
            return local_grad_fn(params, batch)
        if not custom and parallel.placed(params):
            return _partitioned(local_grad_fn, cfg, params, batch)
        return _data_parallel(local_grad_fn, mesh, params, batch)

    return grad_fn


def _rows(batch: dict, n: int, idx: int) -> dict:
    """Rank ``idx`` of ``n`` batch ranks' rows of ``batch``."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{n} batch ranks")
    per = rows // n
    return {k: v[idx * per:(idx + 1) * per] for k, v in batch.items()}


def _local_rows(batch: dict, part) -> dict:
    """This rank's rows of ``batch``: the local blocks of DTensors placed
    along their rows over the batch axes (the reference's batch
    ``in_shardings`` without the sequence split), or a slice of the whole
    batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    placed = [isinstance(v, DTensor) for v in batch.values()]
    if not any(placed):
        return _rows(batch, part.n_batch, part.batch_index)
    for k, v in batch.items():
        want = tuple(Shard(0) if d in part.batch_dims else Replicate()
                     for d in range(part.mesh.ndim))
        if not isinstance(v, DTensor) or tuple(v.placements) != want:
            raise ValueError(f"batch[{k!r}]: a placed batch is sharded "
                             f"along its rows over the batch axes, {want}")
    return {k: v.to_local() for k, v in batch.items()}


def _partitioned(local_grad_fn, cfg, params, batch):
    """One rank's part of the partitioned gradient (module docstring):
    (the loss averaged over the batch ranks, gradients placed as the
    parameters are)."""
    from torch.distributed.tensor import DTensor
    part = T.partition(params, cfg)
    paths, leaves = _tree.flatten(params)
    loss, grads = local_grad_fn(
        parallel.local(params), _local_rows(batch, part),
        lambda p, b: T.lm_loss(p, cfg, b, part=part))
    out = []
    for path, p, g in zip(paths, leaves, _tree.leaves(grads), strict=True):
        g = part.reduce_grad(g, path)
        if part.n_batch > 1:
            g = g / part.n_batch
        out.append(DTensor.from_local(g, p.device_mesh, p.placements,
                                      run_check=False, shape=p.shape,
                                      stride=p.stride()))
    for d in part.batch_dims:
        loss = parallel.all_reduce(loss, part.groups[d])
    return loss / part.n_batch, _tree.unflatten(params, out)


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
    local_batch = _rows(batch, n, idx)
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
