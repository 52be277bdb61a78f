"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the archs the port serves are registered.  The reference's other LM
archs are named in :data:`NOT_PORTED`, so asking for one says where the
work stands instead of calling the name unknown.
"""

from __future__ import annotations

from .base import ArchConfig

_REGISTRY: dict[str, ArchConfig] = {}

#: the reference's LM archs whose families the port does not run yet
NOT_PORTED = ("granite-moe-3b-a800m", "llava-next-34b", "mamba2-1.3b",
              "mixtral-8x7b", "phi3-mini-3.8b", "qwen2-7b", "qwen3-14b",
              "recurrentgemma-2b", "whisper-large-v3")


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
    from . import qwen3_8b  # noqa: F401  (registers on import)


__all__ = ["NOT_PORTED", "get_arch", "list_archs", "register"]
