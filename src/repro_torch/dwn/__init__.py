"""DWN artifact API: typed ``DWNSpec`` -> ``DWNArtifact`` lifecycle::

    spec = get_spec("dwn-jsc-lg")
    art = DWNArtifact(spec).fit(x_train, seed=0).freeze().pack("cuda")
    engine = ServingEngine(art)
"""

from .artifact import DWNArtifact, LifecycleError, PackedOperands, STAGES
from .spec import (DWNSpec, GROUPINGS, VARIANTS, get_spec, has_spec,
                   resolve_spec, spec_presets)

__all__ = [
    "DWNArtifact", "DWNSpec", "GROUPINGS", "LifecycleError",
    "PackedOperands", "STAGES", "VARIANTS", "get_spec", "has_spec",
    "resolve_spec", "spec_presets",
]
