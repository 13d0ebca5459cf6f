"""Meshes of the port: a device-free mesh for resolving rules, and
``make_mesh`` over the default process group.

Port of ``repro.dist.compat``. The reference patches the missing pieces of
jax's modern sharding API into old jax (a two-argument ``AbstractMesh``,
``AxisType``, ``make_mesh(..., axis_types=)``); here each is a plain
definition over ``torch.distributed``:

- ``AbstractMesh(axis_sizes, axis_names)`` names axes and their sizes and
  holds no devices: ``spec_for`` and ``fit_spec_to_shape`` resolve rules
  against it as against a ``DeviceMesh``;
- ``AxisType`` has jax's three members; torch has one behaviour (eager
  SPMD with explicit placements), so ``make_mesh`` drops ``axis_types``,
  as the reference does on a jax without them;
- ``make_mesh`` is ``init_device_mesh`` over the default process group,
  which the caller opens (one process per rank: torch is
  multi-controller where jax is single-controller).

The reference's ``cost_analysis`` shim patches XLA's compile object and
has no counterpart here. Importing this module opens no process group and
touches no device.
"""

from __future__ import annotations

import enum
import math
from typing import Sequence

from repro_torch import resolve_device


class AxisType(enum.Enum):
    Auto = "auto"
    Explicit = "explicit"
    Manual = "manual"


class AbstractMesh:
    """A mesh with axis names and sizes and no devices."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for axes "
                             f"{tuple(axis_names)}")
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}`` in mesh order, as jax's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def __eq__(self, other) -> bool:
        return (isinstance(other, AbstractMesh)
                and self.shape == other.shape
                and self.axis_names == other.axis_names)

    def __hash__(self) -> int:
        return hash((self.axis_sizes, self.axis_names))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.axis_sizes}, {self.axis_names})"


def world_size() -> int:
    """The default process group's size, 1 where none is open."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              axis_types=None, device_type=None):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over every
    rank of the default process group, on ``device_type`` (the card unless
    it names another; ``"cpu"`` with ``gloo``). Ranks fill the mesh in
    row-major order, as ``jax.make_mesh`` fills it with devices.

    ``axis_types`` is accepted and dropped. Raises ``ValueError`` when the
    group's size is not the product of the shape, and ``RuntimeError``
    when no process group is open."""
    del axis_types
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in axis_shapes)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an open process group: call "
            "torch.distributed.init_process_group first (one process per "
            "rank)")
    n = world_size()
    if math.prod(shape) != n:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {n}")
    dev = resolve_device(device_type).type
    return init_device_mesh(dev, shape, mesh_dim_names=tuple(axis_names))
