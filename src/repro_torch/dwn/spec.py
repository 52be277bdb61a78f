"""DWNSpec: the single typed description of a DWN build.

The PyTorch counterpart of ``repro.dwn.spec``.  The encoding variant
(TEN/PEN), thermometer resolution T, threshold placement, PEN input width
and the serving knobs live in one frozen dataclass validated at
construction.  ``to_dict`` and ``fingerprint`` give the reference's values
for the same spec, so a spec names the same build in both packages.

The reference's spec presets (the JSC serving aliases
``dwn-jsc-{sm,md,lg}``, their ``-xla`` twins and
``dwn-jsc-sm-{uniform,gaussian}``; the MNIST tiers
``dwn-mnist-{sm,md,lg}[-xla]``) are registered here as named specs, and
its other JSC DWN arch names resolve through a table (:data:`ARCH_SPECS`)
to the specs the reference derives.
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


#: datapath names of the reference that the port serves on a backend of
#: another name: the reference's ``packed-xla`` (packed words through
#: plain XLA ops) is the port's ``packed-eager``.
DATAPATH_ALIASES = {"packed-xla": "packed-eager"}


def serving_datapath(name: str) -> str:
    """The backend (or ``"auto"``) that serves the datapath ``name``."""
    return DATAPATH_ALIASES.get(name, name)


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
      datapath: serving backend name, validated against the registry, or
        ``"auto"`` (per-bucket selection), or a name of
        :data:`DATAPATH_ALIASES`.  The name is kept as given, so the
        fingerprint is the reference's for every name both accept.
      grouping: popcount grouping ("contig" | "strided").
      workload: registered workload name ("jsc" | "mnist").

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
        allowed = _serving_datapaths() + ["auto"] + list(DATAPATH_ALIASES)
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
# spec presets and the reference's other DWN arch names
# ---------------------------------------------------------------------------

#: MNIST tier -> (LUT-layer width m, default thermometer bits T), as the
#: reference registers them (``repro/configs/dwn_mnist.py``).
_MNIST_TIERS = {"sm": (100, 8), "md": (500, 8), "lg": (2000, 16)}

#: name -> DWNSpec kwargs (validated into a DWNSpec on first access, since
#: validation imports the serving registry): the reference's spec presets,
#: the JSC serving aliases with their ``-xla`` twins, the sm tier's
#: placement variants and the MNIST tiers with their ``-xla`` twins.
_PRESETS: dict[str, "DWNSpec | dict"] = {
    **{f"dwn-jsc-{tier}{suffix}": {"preset": preset, "datapath": datapath}
       for tier, preset in (("sm", "sm-50"), ("md", "md-360"),
                            ("lg", "lg-2400"))
       for suffix, datapath in (("", "fused-packed"),
                                ("-xla", "packed-xla"))},
    **{f"dwn-jsc-sm-{pl}": {"preset": "sm-50", "placement": pl,
                            "datapath": "fused-packed"}
       for pl in ("uniform", "gaussian")},
    **{f"dwn-mnist-{tier}{suffix}": {"preset": f"mnist-{tier}",
                                     "workload": "mnist", "bits": bits,
                                     "datapath": datapath}
       for tier, (_, bits) in _MNIST_TIERS.items()
       for suffix, datapath in (("", "fused-packed"),
                                ("-xla", "packed-xla"))},
}

#: the reference's other JSC DWN arch names -> the kwargs of the spec its
#: ``DWNSpec.from_arch`` derives from each (datapaths that are not serving
#: backends, such as ``gather``, become ``fused-packed``; ``-fused`` does
#: not enter a spec).  A table, since the port imports nothing of the
#: reference.
ARCH_SPECS: dict[str, dict] = {
    **{f"dwn-jsc-{name}{fused}": {"preset": preset}
       for name, preset in (("sm10", "sm-10"), ("sm50", "sm-50"),
                            ("md360", "md-360"), ("lg2400", "lg-2400"))
       for fused in ("", "-fused")},
    "dwn-jsc-lg2400-opt1": {"preset": "lg-2400"},
    "dwn-jsc-lg2400-opt2": {"preset": "lg-2400", "grouping": "strided"},
    "dwn-jsc-lg2400-opt3": {"preset": "lg-2400", "grouping": "strided"},
    "dwn-jsc-lg2400-opt4": {"preset": "lg-2400", "bits": 170,
                            "grouping": "strided"},
    "dwn-jsc-md360-pruned": {"preset": "md-360", "bits": 78,
                             "grouping": "strided"},
    "dwn-jsc-sm50-pruned": {"preset": "sm-50", "bits": 14,
                            "grouping": "strided"},
}

#: the reference's DWN names whose workloads the port does not run yet ->
#: the ROADMAP.md item that ports them
NOT_PORTED: dict[str, str] = {"dwn-lm-head": "Queue 1 item 8"}


def spec_presets() -> list[str]:
    return sorted(_PRESETS)


def dwn_names() -> list[str]:
    """Every DWN name :func:`resolve_spec` takes: the spec presets (JSC and
    MNIST) and the reference's other JSC arch names."""
    return sorted([*_PRESETS, *ARCH_SPECS])


def has_spec(name: str) -> bool:
    return name in _PRESETS


def _not_ported(name: str) -> KeyError:
    return KeyError(f"DWN name {name!r} is not ported yet (ROADMAP.md "
                    f"{NOT_PORTED[name]}); the port resolves {dwn_names()}")


def get_spec(name: str) -> DWNSpec:
    """Resolve a registered spec preset by name."""
    if name in NOT_PORTED:
        raise _not_ported(name)
    if name not in _PRESETS:
        raise KeyError(f"unknown DWN spec preset {name!r}; registered: "
                       f"{sorted(_PRESETS)}")
    entry = _PRESETS[name]
    if isinstance(entry, dict):
        entry = _PRESETS[name] = DWNSpec(**entry)
    return entry


def resolve_spec(target) -> DWNSpec:
    """A DWNSpec as-is, a spec preset's name (JSC or MNIST) as its spec,
    or one of the reference's other JSC arch names as the spec the
    reference derives from it.  ``KeyError`` for any other name, naming
    the ROADMAP item for a DWN name the port does not run yet."""
    if isinstance(target, DWNSpec):
        return target
    if target in ARCH_SPECS:
        return DWNSpec(**ARCH_SPECS[target])
    return get_spec(target)


__all__ = [
    "ARCH_SPECS", "DATAPATH_ALIASES", "DWNSpec", "GROUPINGS", "NOT_PORTED",
    "VARIANTS", "dwn_names", "get_spec", "has_spec", "resolve_spec",
    "serving_datapath", "spec_presets",
]
