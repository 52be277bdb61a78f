"""Logical-axis sharding: the rules that map the model zoo's logical
axis names onto mesh axes (``partition``) and the activation hints of
model code (``annotate``)."""

from .annotate import (current_mesh, dp_axes, hint, hint_act, hint_heads,
                       use_mesh)
from .partition import (AbstractMesh, DEFAULT_RULES, FallbackEvent,
                        LogicalAxes, NamedSharding, PartitionSpec,
                        Partitioner, axis_names, axis_size, logical)

__all__ = ["AbstractMesh", "DEFAULT_RULES", "FallbackEvent", "LogicalAxes",
           "NamedSharding", "PartitionSpec", "Partitioner", "axis_names",
           "axis_size", "current_mesh", "dp_axes", "hint", "hint_act",
           "hint_heads", "logical", "use_mesh"]
