"""DWN artifact API: typed ``DWNSpec`` -> ``DWNArtifact`` lifecycle::

    spec = get_spec("dwn-jsc-lg")
    art = DWNArtifact(spec).fit(x_train, seed=0).freeze().pack("cuda")
    engine = ServingEngine(art)
"""

from .artifact import DWNArtifact, LifecycleError, PackedOperands, STAGES
from .spec import (DATAPATH_ALIASES, DWNSpec, GROUPINGS, VARIANTS,
                   get_spec, has_spec, resolve_spec, serving_datapath,
                   spec_presets)

__all__ = [
    "DATAPATH_ALIASES", "DWNArtifact", "DWNSpec", "GROUPINGS",
    "LifecycleError", "PackedOperands", "STAGES", "VARIANTS", "get_spec",
    "has_spec", "resolve_spec", "serving_datapath", "spec_presets",
]
