"""Serving subsystem: pluggable DWN datapath backends, a microbatching
request scheduler, and the engine behind one submit/drain API.

    backends.py    datapath registry + startup bit-exactness check
    scheduler.py   admission-order queue, power-of-two batch buckets,
                   per-request queue/compute latency accounting
    engine.py      ServingEngine
"""

from .backends import (Backend, BoundBackend, DWNModelBundle,
                       available_backends, get_backend, register_backend,
                       verify_backends)
from .engine import ServingEngine
from .scheduler import MicrobatchScheduler, Request, power_of_two_buckets

__all__ = [
    "Backend", "BoundBackend", "DWNModelBundle", "MicrobatchScheduler",
    "Request", "ServingEngine", "available_backends", "get_backend",
    "power_of_two_buckets", "register_backend", "verify_backends",
]
