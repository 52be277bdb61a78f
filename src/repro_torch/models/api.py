"""Model-zoo API of the port: family dispatch and the step factories the
serving engine calls (the reference's ``repro.models.api``, serving half).

    make_prefill(cfg, cache_len=None) -> fn(params, batch)
    make_decode_step(cfg)             -> fn(params, cache, batch)
"""

from __future__ import annotations

from ..configs.base import ArchConfig
from . import transformer

MODULES = {"dense": transformer}


def module_for(cfg: ArchConfig):
    """The model module of ``cfg.family``; ``NotImplementedError`` for a
    family the port does not run yet (ROADMAP Queue 1 item 8)."""
    if cfg.family not in MODULES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"Queue 1 item 8); the port runs {sorted(MODULES)}")
    return MODULES[cfg.family]


def make_prefill(cfg: ArchConfig, *, cache_len: int | None = None):
    mod = module_for(cfg)

    def fn(params, batch):
        return mod.prefill(params, cfg, batch, cache_len=cache_len)

    return fn


def make_decode_step(cfg: ArchConfig):
    mod = module_for(cfg)

    def fn(params, cache, batch):
        return mod.decode_step(params, cfg, cache, batch["tokens"])

    return fn


__all__ = ["MODULES", "make_decode_step", "make_prefill", "module_for"]
