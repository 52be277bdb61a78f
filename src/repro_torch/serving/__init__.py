"""Serving subsystem: pluggable DWN datapath backends, a microbatching
request scheduler, the continuous-batching loop, and the engine behind
one submit/drain API and one async serve()/submit_async API.

    backends.py    datapath registry + startup bit-exactness check +
                   per-bucket step-time estimates
    scheduler.py   admission-order queue, power-of-two batch buckets,
                   per-request queue/compute latency accounting
    continuous.py  scheduler thread, priority/EDF batch formation,
                   SLO-aware admission, deadline shedding, backpressure
    engine.py      ServingEngine
"""

from .backends import (Backend, BoundBackend, DWNModelBundle,
                       StepTimeEstimator, available_backends, get_backend,
                       register_backend, verify_backends)
from .continuous import (AsyncRequest, ContinuousScheduler, QueueFull,
                         SLOConfig, ServeResult)
from .engine import ServingEngine
from .scheduler import MicrobatchScheduler, Request, power_of_two_buckets

__all__ = [
    "AsyncRequest", "Backend", "BoundBackend", "ContinuousScheduler",
    "DWNModelBundle", "MicrobatchScheduler", "QueueFull", "Request",
    "SLOConfig", "ServeResult", "ServingEngine", "StepTimeEstimator",
    "available_backends", "get_backend", "power_of_two_buckets",
    "register_backend", "verify_backends",
]
