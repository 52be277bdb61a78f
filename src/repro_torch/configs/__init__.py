"""Architecture configs: the port's own copy of the reference's
``ArchConfig`` and input shapes (``base.py``) and a registry of every
arch the port runs, the LM zoo and the paper's DWN models
(``registry.py``)."""

from .base import (ArchConfig, DWN_SHAPES, SHAPES, ShapeConfig,
                   cell_supported, round_up)
from .registry import assigned_archs, get_arch, list_archs, register

__all__ = ["ArchConfig", "DWN_SHAPES", "SHAPES", "ShapeConfig",
           "assigned_archs", "cell_supported", "get_arch", "list_archs",
           "register", "round_up"]
