"""Workload registry: the datasets the port trains and serves (JSC and
MNIST; the reference's ``lm_head`` is ROADMAP.md Queue 1 item 8)."""

from .base import (Workload, get_workload, list_workloads, load_workload,
                   register_workload)

__all__ = [
    "Workload", "get_workload", "list_workloads", "load_workload",
    "register_workload",
]
