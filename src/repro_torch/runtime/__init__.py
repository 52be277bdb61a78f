"""Runtime services: checkpoints on the reference's on-disk layout and the
straggler monitor."""

from .straggler import StragglerEvent, StragglerMonitor

__all__ = ["StragglerEvent", "StragglerMonitor"]
