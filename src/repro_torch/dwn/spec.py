"""DWNSpec: the single typed description of a DWN build.

The PyTorch counterpart of ``repro.dwn.spec``.  The encoding variant
(TEN/PEN), thermometer resolution T, threshold placement, PEN input width
and the serving knobs live in one frozen dataclass validated at
construction.  ``to_dict`` and ``fingerprint`` give the reference's values
for the same spec, so a spec names the same build in both packages.

The serving aliases ``dwn-jsc-{sm,md,lg}`` are registered here as named
specs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from ..core.model import DWNConfig
from ..core.thermometer import PLACEMENTS

#: encoding variants: TEN receives pre-encoded thermometer bits, PEN
#: receives fixed-point features and encodes on chip (paper §II).
VARIANTS = ("TEN", "PEN")

#: popcount grouping modes (contig = paper Fig. 1; strided = the
#: shard-aligned variant).
GROUPINGS = ("contig", "strided")


def _workload_presets(workload: str):
    """Tier name -> base DWNConfig for a workload (registry lookup)."""
    from ..workloads import get_workload
    return get_workload(workload).presets


def _serving_datapaths() -> list[str]:
    from ..serving.backends import available_backends
    return available_backends()


@dataclasses.dataclass(frozen=True)
class DWNSpec:
    """One validated DWN build point.

    Attributes:
      preset: tier ("sm-10" | "sm-50" | "md-360" | "lg-2400" for JSC) —
        fixes the LUT-layer width m.
      variant: "TEN" (bits arrive pre-encoded) or "PEN" (on-chip encoder).
      bits: thermometer bits per feature T, >= 1.
      placement: threshold placement ("distributive" | "uniform" |
        "gaussian").
      input_bits: PEN fixed-point input width in *total* bits (1 sign + n
        fractional); set iff ``variant == "PEN"``.
      datapath: serving backend name, validated against the registry.
      grouping: popcount grouping ("contig" | "strided").
      workload: registered workload name ("jsc").

    Raises ``ValueError`` at construction for any invalid combination.
    """

    preset: str
    variant: str = "TEN"
    bits: int = 200
    placement: str = "distributive"
    input_bits: int | None = None
    datapath: str = "fused-packed"
    grouping: str = "contig"
    workload: str = "jsc"

    def __post_init__(self):
        try:
            presets = _workload_presets(self.workload)
        except KeyError as e:
            raise ValueError(str(e.args[0])) from None
        if self.preset not in presets:
            raise ValueError(
                f"unknown DWN preset {self.preset!r} for workload "
                f"{self.workload!r}; known tiers: {sorted(presets)} "
                f"(each fixes the LUT-layer width m)")
        if self.variant not in VARIANTS:
            raise ValueError(
                f"unknown encoding variant {self.variant!r}; choose 'TEN' "
                f"(pre-encoded thermometer bits) or 'PEN' (on-chip encoder)")
        if not isinstance(self.bits, int) or self.bits < 1:
            raise ValueError(
                f"thermometer resolution bits={self.bits!r} is invalid: T "
                f"must be an integer >= 1")
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"unknown threshold placement {self.placement!r}; "
                f"supported placements: {list(PLACEMENTS)}")
        if self.variant == "PEN":
            if self.input_bits is None:
                raise ValueError(
                    "variant='PEN' requires input_bits (total fixed-point "
                    "input width, sign included — e.g. input_bits=9 for "
                    "the paper's (1, 8) grid)")
            if not isinstance(self.input_bits, int) or self.input_bits < 2:
                raise ValueError(
                    f"input_bits={self.input_bits!r} is invalid for PEN: "
                    f"need at least 2 (1 sign bit + >= 1 fractional bit)")
        elif self.input_bits is not None:
            raise ValueError(
                f"variant='TEN' must not set input_bits (got "
                f"{self.input_bits}); use variant='PEN' for on-chip "
                f"encoding")
        if self.grouping not in GROUPINGS:
            raise ValueError(
                f"unknown popcount grouping {self.grouping!r}; supported: "
                f"{list(GROUPINGS)}")
        allowed = _serving_datapaths()
        if self.datapath not in allowed:
            raise ValueError(
                f"unregistered serving datapath {self.datapath!r}; "
                f"registered backends: {sorted(allowed)}")

    @property
    def luts(self) -> int:
        """LUT-layer width m of the preset tier."""
        return _workload_presets(self.workload)[self.preset].lut_counts[-1]

    @property
    def frac_bits(self) -> int | None:
        """Fractional bits of the (1, n) fixed-point grid; None for TEN."""
        return None if self.input_bits is None else self.input_bits - 1

    @property
    def label(self) -> str:
        b = "" if self.input_bits is None else f"@{self.input_bits}b"
        wl = "" if self.workload == "jsc" else f"{self.workload}:"
        return (f"{wl}{self.preset}/{self.variant}{b}/T{self.bits}/"
                f"{self.placement}")

    def dwn_config(self) -> DWNConfig:
        """The core model config this spec builds."""
        return dataclasses.replace(
            _workload_presets(self.workload)[self.preset],
            bits_per_feature=self.bits, encoding=self.placement)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # the default workload is omitted, as in the reference, so a spec
        # fingerprints the same in both packages
        if d["workload"] == "jsc":
            del d["workload"]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DWNSpec":
        return cls(**d)

    def fingerprint(self) -> str:
        """Stable 16-hex-char content hash of the spec."""
        blob = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# spec presets: the serving aliases
# ---------------------------------------------------------------------------

#: name -> DWNSpec kwargs (validated into a DWNSpec on first access, since
#: validation imports the serving registry).
_PRESETS: dict[str, "DWNSpec | dict"] = {
    f"dwn-jsc-{tier}": {"preset": preset, "datapath": "fused-packed"}
    for tier, preset in (("sm", "sm-50"), ("md", "md-360"),
                         ("lg", "lg-2400"))
}


def spec_presets() -> list[str]:
    return sorted(_PRESETS)


def has_spec(name: str) -> bool:
    return name in _PRESETS


def get_spec(name: str) -> DWNSpec:
    """Resolve a registered spec preset by name."""
    if name not in _PRESETS:
        raise KeyError(f"unknown DWN spec preset {name!r}; registered: "
                       f"{sorted(_PRESETS)}")
    entry = _PRESETS[name]
    if isinstance(entry, dict):
        entry = _PRESETS[name] = DWNSpec(**entry)
    return entry


def resolve_spec(target) -> DWNSpec:
    """A DWNSpec as-is, or a registered preset name as its spec."""
    if isinstance(target, DWNSpec):
        return target
    return get_spec(target)


__all__ = [
    "DWNSpec", "GROUPINGS", "VARIANTS", "get_spec", "has_spec",
    "resolve_spec", "spec_presets",
]
