"""Runtime services: checkpoints on the reference's on-disk layout, the
restart supervisor with preemption handling, and the straggler monitor.
The same names as the reference's ``repro.runtime``."""

from . import checkpoint, fault, straggler
from .checkpoint import latest_step, restore, restore_latest, save
from .fault import (FaultInjector, PreemptionHandler, RestartPolicy,
                    Supervisor, TrainHandle)
from .straggler import StragglerEvent, StragglerMonitor

__all__ = [
    "FaultInjector", "PreemptionHandler", "RestartPolicy", "StragglerEvent",
    "StragglerMonitor", "Supervisor", "TrainHandle", "checkpoint", "fault",
    "latest_step", "restore", "restore_latest", "save", "straggler",
]
