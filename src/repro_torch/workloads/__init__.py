"""Workload registry: the datasets the port trains and serves (JSC, MNIST
and the LM-backbone features of ``lm-head``)."""

from .base import (Workload, get_workload, list_workloads, load_workload,
                   register_workload)

__all__ = [
    "Workload", "get_workload", "list_workloads", "load_workload",
    "register_workload",
]
