"""Production and test meshes over the default process group.

Port of ``repro.launch.mesh``. Functions, not module-level constants, so
importing this module opens no process group and touches no device. The
caller opens the group (one process per rank); each function is then
called on every rank.
"""

from __future__ import annotations

import math

from repro_torch import resolve_device
from repro_torch.dist import compat

_POD_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod. Raises
    ``ValueError`` on a process group of any other size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = _POD_AXES if multi_pod else ("data", "model")
    return compat.make_mesh(
        shape, axes, axis_types=(compat.AxisType.Auto,) * len(axes),
        device_type=device_type)


def make_disaggregated_meshes(
        prefill: tuple[int, int, int] = (1, 2, 2),
        decode: tuple[int, int, int] = (1, 2, 2), *, device_type=None):
    """Split the ranks into a prefill slice and a decode slice.

    Both meshes use the ``("pod", "data", "model")`` axis names so the
    ``MULTIPOD_SERVE`` rule set applies verbatim on either slice. The
    prefill slice takes the first ``prod(prefill)`` ranks, the decode
    slice the next ``prod(decode)``; every rank builds both (a rank outside
    a slice has no coordinate in it: ``get_coordinate()`` is None).
    """
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    need_p, need_d = math.prod(prefill), math.prod(decode)
    have = compat.world_size()
    if have < need_p + need_d:
        raise ValueError(
            f"disaggregated serving needs {need_p}+{need_d} devices, "
            f"have {have}")
    dev = resolve_device(device_type).type
    ranks = torch.arange(need_p + need_d)
    return (DeviceMesh(dev, ranks[:need_p].reshape(prefill),
                       mesh_dim_names=_POD_AXES),
            DeviceMesh(dev, ranks[need_p:].reshape(decode),
                       mesh_dim_names=_POD_AXES))


def make_test_mesh(data: int = 2, model: int = 2, *, device_type=None):
    """A small ``("data", "model")`` mesh over every rank of the group."""
    return compat.make_mesh(
        (data, model), ("data", "model"),
        axis_types=(compat.AxisType.Auto,) * 2, device_type=device_type)
