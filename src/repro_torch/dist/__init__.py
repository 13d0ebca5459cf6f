"""Distribution layer: logical-axis sharding rules on ``DeviceMesh`` /
``DTensor`` (``sharding``) and the mesh helpers (``compat``). Importing it
opens no process group and touches no device."""

from repro_torch.dist.compat import AbstractMesh, AxisType, make_mesh
from repro_torch.dist.sharding import (
    DEFAULT_RULES,
    MULTIPOD_RULES,
    MULTIPOD_SERVE_RULES,
    SERVE_RULES,
    NamedSharding,
    PartitionSpec,
    active_mesh,
    axis_rules,
    current_rules,
    fit_spec_to_shape,
    place,
    sanitize_shardings,
    shard,
    spec_for,
    use_mesh,
)

__all__ = [
    "DEFAULT_RULES",
    "MULTIPOD_RULES",
    "MULTIPOD_SERVE_RULES",
    "SERVE_RULES",
    "axis_rules",
    "current_rules",
    "fit_spec_to_shape",
    "sanitize_shardings",
    "shard",
    "spec_for",
    # the port's own: meshes, specs and placement on DTensor
    "AbstractMesh",
    "AxisType",
    "NamedSharding",
    "PartitionSpec",
    "active_mesh",
    "make_mesh",
    "place",
    "use_mesh",
]
