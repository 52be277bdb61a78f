"""Architecture configs of the LM side: the port's own copy of the
reference's ``ArchConfig`` (``base.py``) and a registry of the archs the
port serves (``registry.py``)."""

from .base import ArchConfig, round_up
from .registry import get_arch, list_archs, register

__all__ = ["ArchConfig", "get_arch", "list_archs", "register", "round_up"]
