"""Fused-kernel configuration: which kernel variant serves a batch bucket,
how many samples one CUDA block takes and, for the float fused kernel, how
many LUTs one tile holds.

The reference's timed sweep and its persistent cache are not ported yet;
a model serves on :data:`DEFAULT_CONFIG` unless its bundle's
``tuned_configs`` names a config for the bucket.
"""

from __future__ import annotations

import dataclasses

#: kernel variants (see ``fused/ops.py``).
VARIANTS = ("packed", "batch-major")


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    """One point in the fused-kernel configuration space.

    Attributes:
      variant: "packed" (the full F*T bit tensor in words) or
        "batch-major" (direct-wire first layer).
      block_b: samples one CUDA block of the packed kernels takes at a
        time (a tile), rounded up to a multiple of 32 (a warp's lanes are
        32 samples) and down to what fits a block's shared memory beside
        the model.  The results do not depend on it.  The default, one
        warp's 32 samples, was the fastest of {32, 64, 128, 256} for both
        kernels at dwn-jsc-lg width and 4096 rows on an H100 80GB HBM3 at
        700 W (``chip_smoke.py``; PERF.md).
      block_m: LUTs per tile of the float fused kernel (``fused_dwn``),
        which walks the LUTs tile by tile as the reference's sequential m
        axis does.  No other kernel reads it; the results do not depend
        on it.
    """

    variant: str = "packed"
    block_b: int = 32
    block_m: int = 128

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown fused variant {self.variant!r}; "
                             f"choose one of {VARIANTS}")
        if self.block_b < 1:
            raise ValueError(f"block_b must be >= 1, got {self.block_b}")
        if self.block_m < 1:
            raise ValueError(f"block_m must be >= 1, got {self.block_m}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FusedConfig":
        """Inverse of :meth:`to_dict`; keys it does not know are ignored,
        missing ones take their defaults (as the reference's)."""
        return cls(**{k: d[k] for k in ("variant", "block_b", "block_m")
                      if k in d})


#: what an untuned model serves with.
DEFAULT_CONFIG = FusedConfig()

__all__ = ["DEFAULT_CONFIG", "FusedConfig", "VARIANTS"]
