"""DWNSpec: the single typed description of a DWN build.

The PyTorch counterpart of ``repro.dwn.spec``.  The encoding variant
(TEN/PEN), thermometer resolution T, threshold placement, PEN input width
and the serving knobs live in one frozen dataclass validated at
construction.  ``to_dict`` and ``fingerprint`` give the reference's values
for the same spec, so a spec names the same build in both packages.

The reference's spec presets (the JSC serving aliases
``dwn-jsc-{sm,md,lg}``, their ``-xla`` twins and
``dwn-jsc-sm-{uniform,gaussian}``; the MNIST tiers
``dwn-mnist-{sm,md,lg}[-xla]``; ``dwn-lm-head``, the DWN head on the
qwen3-8b backbone) are registered here as named specs.  Every other
DWN arch of the registry (``configs.dwn_jsc``) resolves to the spec
:meth:`DWNSpec.from_arch` derives from its config, as in the reference;
:meth:`DWNSpec.arch_config` is the way back.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from ..configs.base import ArchConfig
from ..core.model import DWNConfig, JSC_PRESETS
from ..core.thermometer import PLACEMENTS

#: encoding variants: TEN receives pre-encoded thermometer bits, PEN
#: receives fixed-point features and encodes on chip (paper §II).
VARIANTS = ("TEN", "PEN")

#: popcount grouping modes (contig = paper Fig. 1; strided = the
#: shard-aligned variant).
GROUPINGS = ("contig", "strided")

#: JSC tier -> LUT-layer width m
TIERS = {name: cfg.lut_counts[-1] for name, cfg in JSC_PRESETS.items()}

_LUTS_TO_TIER = {m: name for name, m in TIERS.items()}


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
      workload: registered workload name ("jsc" | "mnist" | "lm-head").
      backbone: arch name of a feature-extractor backbone stage, for
        specs whose features come from a model (the DWN head on an LM);
        None inherits the workload's backbone (None for plain datasets).

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
    backbone: str | None = None

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

    @property
    def effective_backbone(self) -> str | None:
        """The backbone arch: the ``backbone`` field, else the workload's
        registered backbone, else None (a plain dataset)."""
        if self.backbone is not None:
            return self.backbone
        from ..workloads import get_workload
        return get_workload(self.workload).backbone

    def dwn_config(self) -> DWNConfig:
        """The core model config this spec builds."""
        return dataclasses.replace(
            _workload_presets(self.workload)[self.preset],
            bits_per_feature=self.bits, encoding=self.placement)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # the default workload and backbone are omitted, as in the
        # reference, so a spec fingerprints the same in both packages
        if d["workload"] == "jsc":
            del d["workload"]
        if d["backbone"] is None:
            del d["backbone"]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DWNSpec":
        return cls(**d)

    def arch_config(self, name: str | None = None) -> ArchConfig:
        """A servable (unregistered) ArchConfig view of this spec, for
        code that speaks ``ArchConfig`` (engine reports, the model zoo's
        shapes)."""
        cfg = self.dwn_config()
        return ArchConfig(
            name=name or f"dwn-{self.preset}-T{self.bits}-{self.placement}",
            family="dwn",
            num_layers=1, d_model=cfg.num_features,
            num_heads=0, num_kv_heads=0, d_ff=0,
            vocab_size=cfg.num_classes,
            dwn_luts=self.luts, dwn_bits=self.bits,
            dwn_encoding=self.placement, dwn_fused=True,
            dwn_datapath=self.datapath, dwn_grouping=self.grouping,
            source="repro.dwn.DWNSpec")

    @classmethod
    def from_arch(cls, cfg: ArchConfig, *, variant: str = "TEN",
                  input_bits: int | None = None) -> "DWNSpec":
        """The spec of a DWN ``ArchConfig`` of a JSC tier width.

        ``dwn_datapath`` values that are not serving backends (the
        prefill variants ``corner`` / ``gather`` of ``models.dwn_arch``)
        become ``fused-packed``, as in the reference.
        """
        if cfg.family != "dwn":
            raise ValueError(f"arch {cfg.name!r} is family={cfg.family!r}, "
                             f"not a DWN — no spec can be derived")
        preset = _LUTS_TO_TIER.get(cfg.dwn_luts)
        if preset is None:
            raise ValueError(
                f"arch {cfg.name!r} has dwn_luts={cfg.dwn_luts}, which is "
                f"not a JSC tier width ({sorted(_LUTS_TO_TIER)}); register "
                f"a preset tier first")
        datapath = cfg.dwn_datapath
        if datapath not in (_serving_datapaths() + ["auto"]
                            + list(DATAPATH_ALIASES)):
            datapath = "fused-packed"
        grouping = cfg.dwn_grouping if cfg.dwn_grouping in GROUPINGS \
            else "contig"
        return cls(preset=preset, variant=variant, bits=cfg.dwn_bits,
                   placement=cfg.dwn_encoding, input_bits=input_bits,
                   datapath=datapath, grouping=grouping)

    @classmethod
    def from_point(cls, point, *, datapath: str = "fused-packed",
                   grouping: str = "contig") -> "DWNSpec":
        """The spec of one ``repro_torch.sweep.grid.SweepPoint`` (adds the
        serving knobs a grid point does not carry)."""
        return cls(preset=point.preset, variant=point.variant,
                   bits=point.bits, placement=point.placement,
                   input_bits=point.input_bits, datapath=datapath,
                   grouping=grouping,
                   workload=getattr(point, "workload", "jsc"))

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
    "dwn-lm-head": {"preset": "lm-head-50", "workload": "lm-head",
                    "bits": 64, "placement": "uniform",
                    "backbone": "qwen3-8b", "datapath": "fused-packed"},
}

#: the reference's DWN names whose workloads the port does not run yet ->
#: the ROADMAP.md item that ports them (none since ``dwn-lm-head``)
NOT_PORTED: dict[str, str] = {}


def spec_presets() -> list[str]:
    return sorted(_PRESETS)


def _dwn_archs() -> list[str]:
    from ..configs import get_arch, list_archs
    return [n for n in list_archs() if get_arch(n).family == "dwn"]


def dwn_names() -> list[str]:
    """Every DWN name :func:`resolve_spec` takes: the spec presets (JSC,
    MNIST and the LM head) and the registered DWN archs."""
    return sorted({*_PRESETS, *_dwn_archs()})


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
    """A DWNSpec as-is; a spec preset's name (JSC, MNIST or the LM head)
    as its spec; a registered DWN arch name or a DWN ``ArchConfig`` as
    the spec :meth:`DWNSpec.from_arch` derives from the config (a config
    that shadows a spec preset resolves to the preset).  ``KeyError`` for
    an unknown name, naming the ROADMAP item for a DWN name the port does
    not run yet; ``ValueError`` for an arch that is not a DWN."""
    if isinstance(target, DWNSpec):
        return target
    if isinstance(target, str):
        if has_spec(target) or target in NOT_PORTED:
            return get_spec(target)
        from ..configs import get_arch
        try:
            target = get_arch(target)
        except KeyError:
            raise KeyError(f"unknown DWN name {target!r}; the port "
                           f"resolves {dwn_names()}") from None
    if has_spec(target.name):
        return get_spec(target.name)
    return DWNSpec.from_arch(target)


__all__ = [
    "DATAPATH_ALIASES", "DWNSpec", "GROUPINGS", "NOT_PORTED", "TIERS",
    "VARIANTS", "dwn_names", "get_spec", "has_spec", "resolve_spec",
    "serving_datapath", "spec_presets",
]
