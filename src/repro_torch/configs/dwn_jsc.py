"""The paper's own DWN JSC models as archs of the model zoo.

The reference's ``configs/dwn_jsc.py``: the four size tiers, staged and
fused; the serving aliases ``dwn-jsc-{sm,md,lg}`` and their ``-xla``
twins; the datapath variants of lg-2400 (``-opt1`` … ``-opt4``); the
encoder-pruned tiers; the placement variants of the sm alias.  The
serving aliases are also spec presets (``dwn.spec``), which the serve CLI
and ``ServingEngine`` resolve; every other name resolves to the spec
``DWNSpec.from_arch`` derives from its config.
"""

import dataclasses as _dc

from .base import ArchConfig
from .registry import register


def _dwn(name: str, luts: int, fused: bool = False) -> ArchConfig:
    return ArchConfig(
        name=name + ("-fused" if fused else ""),
        family="dwn",
        num_layers=1,
        d_model=16,               # JSC features
        num_heads=0, num_kv_heads=0, d_ff=0,
        vocab_size=5,             # JSC jet classes
        dwn_luts=luts,
        dwn_bits=200,
        dwn_fused=fused,
        source="Mecik & Kumm 2025 (this paper); [13] model sizes",
    )


for _m, _l in (("dwn-jsc-sm10", 10), ("dwn-jsc-sm50", 50),
               ("dwn-jsc-md360", 360), ("dwn-jsc-lg2400", 2400)):
    register(_dwn(_m, _l))
    register(_dwn(_m, _l, fused=True))


# Short serving aliases: the size tiers wired to a serving backend via
# ``dwn_datapath``.  The plain alias serves on the fused packed kernel;
# the -xla twin serves the same packed words through plain tensor ops
# (the port's ``packed-eager``).
for _m, _l in (("dwn-jsc-sm", 50), ("dwn-jsc-md", 360),
               ("dwn-jsc-lg", 2400)):
    register(_dc.replace(_dwn(_m, _l, fused=True), name=_m,
                         dwn_datapath="fused-packed"))
    register(_dc.replace(_dwn(_m, _l, fused=True), name=_m + "-xla",
                         dwn_datapath="packed-xla"))

# datapath variants of the lg-2400 prefill (``models.dwn_arch``)
_BASE = _dwn("dwn-jsc-lg2400-x", 2400)
register(_dc.replace(_BASE, name="dwn-jsc-lg2400-opt1",
                     dwn_datapath="gather"))
register(_dc.replace(_BASE, name="dwn-jsc-lg2400-opt2",
                     dwn_datapath="gather", dwn_grouping="strided"))
register(_dc.replace(_BASE, name="dwn-jsc-lg2400-opt3",
                     dwn_datapath="gather", dwn_grouping="strided",
                     dwn_fused=True))


# Encoder-column pruning (the paper's future-work item (i)): only the
# thermometer columns the trained mapping wires are encoded.  sm-50 uses
# 209/3200 distinct columns, md-360 1237/3200; dwn_bits is the
# per-feature ceiling.
register(_dc.replace(_dwn("dwn-jsc-md360-x", 360), name="dwn-jsc-md360-pruned",
                     dwn_bits=78, dwn_datapath="gather",
                     dwn_grouping="strided"))
register(_dc.replace(_dwn("dwn-jsc-sm50-x", 50), name="dwn-jsc-sm50-pruned",
                     dwn_bits=14, dwn_datapath="gather",
                     dwn_grouping="strided"))
register(_dc.replace(_BASE, name="dwn-jsc-lg2400-opt4",
                     dwn_datapath="gather", dwn_grouping="strided",
                     dwn_bits=170))   # lg-2400: ~2700/3200 used -> 169/feature


#: serving-alias tiers the sweep grids draw from: tier -> LUT-layer width m
SWEEP_TIERS = {"sm-10": 10, "sm-50": 50, "md-360": 360, "lg-2400": 2400}


# placement variants of the sm serving alias (--arch dwn-jsc-sm-uniform)
for _pl in ("uniform", "gaussian"):
    register(_dc.replace(_dwn("dwn-jsc-sm-x", 50, fused=True),
                         name=f"dwn-jsc-sm-{_pl}", dwn_encoding=_pl,
                         dwn_datapath="fused-packed"))
