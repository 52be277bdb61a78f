"""Architecture registry of the port: ``--arch <id>`` resolves here.

The port registers every arch of the reference: its ten LM archs
(``assigned_archs``) and the paper's own DWN models (``family="dwn"``:
``dwn_jsc``, ``dwn_mnist``, ``dwn_lm_head``).  :data:`NOT_PORTED` names
reference archs the port does not run, so that asking for one says
where the work stands instead of calling the name unknown; it is empty.
"""

from __future__ import annotations

from .base import ArchConfig

_REGISTRY: dict[str, ArchConfig] = {}

#: the reference's LM archs whose families the port does not run yet
NOT_PORTED: tuple[str, ...] = ()


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, cfg.name
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    """The registered config ``name``; ``KeyError`` for any other."""
    _load_all()
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP Queue 1 "
                       f"item 8); the port serves {sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    """Every registered arch, the DWN ones included."""
    _load_all()
    return sorted(_REGISTRY)


def assigned_archs() -> list[str]:
    """The 10 pool architectures (excludes the paper's own DWN models)."""
    _load_all()
    return sorted(n for n, c in _REGISTRY.items() if c.family != "dwn")


def _load_all() -> None:
    from . import (dwn_jsc, dwn_lm_head, dwn_mnist,  # noqa: F401
                   granite_moe_3b_a800m, llava_next_34b, mamba2_1_3b,
                   mixtral_8x7b, phi3_mini_3_8b, qwen2_7b, qwen3_8b,
                   qwen3_14b, recurrentgemma_2b,
                   whisper_large_v3)  # (each registers on import)


__all__ = ["NOT_PORTED", "assigned_archs", "get_arch", "list_archs",
           "register"]
