"""Workload registry: the datasets the port serves (JSC only for now)."""

from .base import (Workload, get_workload, list_workloads, load_workload,
                   register_workload)

__all__ = [
    "Workload", "get_workload", "list_workloads", "load_workload",
    "register_workload",
]
