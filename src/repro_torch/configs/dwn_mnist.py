"""MNIST DWN serving aliases (``dwn-mnist-{sm,md,lg}`` and their
``-xla`` twins): 196 pooled-pixel features, 10 digit classes.  Each is
also a spec preset (``dwn.spec``)."""

import dataclasses as _dc

from .base import ArchConfig
from .registry import register

#: tier -> (LUT-layer width m, default thermometer bits T).  m divides
#: by 10 classes (the popcount-grouping constraint).
_MNIST_TIERS = {"sm": (100, 8), "md": (500, 8), "lg": (2000, 16)}


def _dwn_mnist(name: str, luts: int, bits: int) -> ArchConfig:
    return ArchConfig(
        name=name,
        family="dwn",
        num_layers=1,
        d_model=196,              # 14x14 pooled MNIST pixels
        num_heads=0, num_kv_heads=0, d_ff=0,
        vocab_size=10,            # digit classes
        dwn_luts=luts,
        dwn_bits=bits,
        dwn_fused=True,
        dwn_datapath="fused-packed",
        source="DWN MNIST tiers (Bacellar et al. model family)",
    )


for _tier, (_l, _b) in _MNIST_TIERS.items():
    register(_dwn_mnist(f"dwn-mnist-{_tier}", _l, _b))
    register(_dc.replace(_dwn_mnist(f"dwn-mnist-{_tier}-x", _l, _b),
                         name=f"dwn-mnist-{_tier}-xla",
                         dwn_datapath="packed-xla"))
