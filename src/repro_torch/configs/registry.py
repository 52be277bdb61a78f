"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the archs the port serves are registered.  The reference's other LM
archs are named in :data:`NOT_PORTED`, so asking for one says where the
work stands instead of calling the name unknown.
"""

from __future__ import annotations

from .base import ArchConfig

_REGISTRY: dict[str, ArchConfig] = {}

#: the reference's LM archs whose families the port does not run yet
NOT_PORTED = ("llava-next-34b", "mamba2-1.3b", "recurrentgemma-2b",
              "whisper-large-v3")


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
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    from . import (granite_moe_3b_a800m, mixtral_8x7b,  # noqa: F401
                   phi3_mini_3_8b, qwen2_7b, qwen3_8b,
                   qwen3_14b)  # (each registers on import)


__all__ = ["NOT_PORTED", "get_arch", "list_archs", "register"]
