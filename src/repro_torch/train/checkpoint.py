"""Fault-tolerant checkpointing: atomic, async, device-agnostic.

Port of ``repro.train.checkpoint``, with its on-disk protocol (one
directory per step):

    <dir>/step_000000123.tmp/...   (written)
    <dir>/step_000000123/          (atomic rename on completion)
        manifest.json              step, leaf paths, shapes, dtypes, extra
        arr_000000.npy ...         one file per leaf, on the host

The manifest records the tree's structure as its leaves' key paths
(``train._tree``) where the reference records a jax treedef; a bfloat16
leaf is stored as its ``uint16`` bits under the logical dtype
``"bfloat16"``. ``restore`` places every leaf on the device and in the
dtype of the matching leaf of ``tree_like``: the one-card form of the
reference's elastic re-placement, so a checkpoint written from the card
restores on the CPU and the other way round. With ``shardings=`` (a tree
of ``repro_torch.dist.NamedSharding``) ``restore`` re-places every leaf
as a DTensor on that sharding's mesh instead: elastic restart onto
another mesh. A tree of DTensors (a placed train state) saves as full
tensors: every rank calls ``save``, each leaf is gathered, rank 0 writes,
and a barrier holds the ranks until the checkpoint is published; the
format does not change. Saves can run on a background thread
(``AsyncCheckpointer``), which copies the state to the host first, so the
step loop never waits on the disk.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.train import _tree

_MANIFEST = "manifest.json"


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _gathered(tree: Any) -> tuple[Any, bool]:
    """(``tree`` with each DTensor leaf gathered into a plain tensor — a
    collective that every rank of its mesh must join — whether any was)."""
    from torch.distributed.tensor import DTensor
    flat = _tree.leaves(tree)
    if not any(isinstance(t, DTensor) for t in flat):
        return tree, False
    return _tree.unflatten(tree, [
        t.full_tensor() if isinstance(t, DTensor) else t for t in flat]), True


def _host_array(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array to store, its logical dtype name) of a tensor leaf;
    bfloat16 becomes its uint16 bits."""
    t = leaf.detach().cpu()
    logical = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), logical
    return t.numpy(), logical


def save(directory: str, step: int, tree: Any, *,
         extra: dict | None = None) -> str:
    """Synchronous atomic save. Returns the final checkpoint path. A tree
    with DTensor leaves is gathered (every rank calls this), written by
    rank 0, and the ranks meet at a barrier after the publish."""
    tree, placed = _gathered(tree)
    final = _write(directory, step, tree, extra)
    if placed:
        import torch.distributed as dist
        dist.barrier()
    return final


def _write(directory: str, step: int, tree: Any,
           extra: dict | None) -> str:
    """Write a tree of plain tensors; in a process group only rank 0
    writes."""
    final = os.path.join(directory, f"step_{step:09d}")
    if _rank() != 0:
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    paths, flat = _tree.flatten(tree)
    meta = {
        "step": step,
        "paths": paths,
        "n_leaves": len(flat),
        "leaves": [],
        "extra": extra or {},
        "time": time.time(),
    }
    for i, leaf in enumerate(flat):
        arr, logical = _host_array(leaf)
        np.save(os.path.join(tmp, f"arr_{i:06d}.npy"), arr)
        meta["leaves"].append({"shape": list(arr.shape), "dtype": logical})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _gc(directory, keep=3)
    return final


class AsyncCheckpointer:
    """Background-thread checkpoint writer; at most one save in flight.

    ``wait()`` before exiting. A crash mid-save leaves only a .tmp dir,
    which restore ignores — the previous complete checkpoint wins.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> None:
        self.wait()
        # snapshot before the next in-place step (a copy on the CPU too);
        # DTensor leaves are gathered here, on the calling thread
        host_tree = _tree.tree_map(
            lambda t: t.detach().to("cpu", copy=True), _gathered(tree)[0])
        self._thread = threading.Thread(
            target=_write, args=(self.directory, step, host_tree, extra),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, _MANIFEST))]
    return max(steps) if steps else None


def _load_leaf(path: str, i: int, logical: str) -> torch.Tensor:
    arr = np.load(os.path.join(path, f"arr_{i:06d}.npy"))
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, tree_like: Any, *, step: int | None = None,
            shardings: Any = None) -> tuple[Any, int, dict]:
    """Load a checkpoint into the structure of ``tree_like``, each leaf in
    the dtype of ``tree_like``'s leaf at its place and on its device — or,
    where ``shardings`` (a tree of ``NamedSharding`` of that structure,
    refit to the stored shapes) has a sharding, as a DTensor placed by it
    on its mesh: elastic restart after a topology change. Every rank of
    the mesh calls it. Returns (tree, step, extra)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        meta = json.load(f)
    paths_like, flat_like = _tree.flatten(tree_like)
    if meta["n_leaves"] != len(flat_like):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, expected "
            f"{len(flat_like)} — structure changed")
    if meta["paths"] != paths_like:
        bad = next(i for i, (a, b) in enumerate(zip(meta["paths"],
                                                     paths_like)) if a != b)
        raise ValueError(f"leaf {bad}: checkpoint has {meta['paths'][bad]!r}"
                         f", expected {paths_like[bad]!r} — structure changed")
    if shardings is not None:
        from repro_torch.dist import sharding as dsh
        shardings = _tree.leaves(dsh.sanitize_shardings(shardings, tree_like))
    leaves = []
    for i, like in enumerate(flat_like):
        t = _load_leaf(path, i, meta["leaves"][i]["dtype"])
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
        sh = None if shardings is None else shardings[i]
        if sh is None:
            leaves.append(t.to(device=like.device, dtype=like.dtype))
        else:
            leaves.append(dsh.distribute(t.to(like.dtype), sh))
    return (_tree.unflatten(tree_like, leaves), step,
            meta.get("extra", {}))


def _gc(directory: str, keep: int) -> None:
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
