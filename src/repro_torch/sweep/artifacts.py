"""Paper-artifact regeneration: Table I/III rows, Fig. 2/5/6 data.

The port's copy of the reference's ``repro.sweep.artifacts`` (the logic
behind the reference's ``benchmarks/{table1,fig2,fig5,fig6}*``), reading
the port's ``hw.cost`` and ``hw.report``.  Everything returns plain data
(rows, dicts, points) so the sweep CLI and the tests regenerate the same
numbers from the same code.  ``encoding_mode_accuracy`` draws its init
from ``torch.Generator().manual_seed(seed)``, so it trains another model
than the reference's for the same seed.

Units: LUT/FF counts are physical LUT6/flip-flop counts from the
technology-mapped cost model (``hw.cost``); accuracies are fractions in
[0, 1] except where a row explicitly stores the paper's percent figures.
"""

from __future__ import annotations

import dataclasses

from ..hw.cost import dwn_hw_report
from ..hw.report import PAPER_TABLE1, PAPER_TABLE2, PAPER_TABLE3
from .grid import SweepPoint

#: Documented reproduction tolerance of the Table I TEN LUT counts
#: (relative error of our structural generator vs the paper's Vivado
#: results; see docs/reproduction.md).  Vivado cross-optimizes the tiny
#: sm-10 design further than any structural generator can, hence its
#: looser bound.
TABLE1_TEN_TOLERANCE = {"sm-10": 0.45, "sm-50": 0.10,
                        "md-360": 0.05, "lg-2400": 0.05}

#: Model sizes in Table I order — every per-preset artifact walks these.
PRESETS = ("sm-10", "sm-50", "md-360", "lg-2400")


def paper_reference(point: SweepPoint) -> int | None:
    """The paper's LUT count for a sweep point, if it matches a published
    operating point (T=200, distributive placement), else None.

    TEN points land on the Table I/III TEN rows.  PEN points land on the
    PEN+FT row when ``input_bits`` equals the fine-tuned width, or the
    plain PEN row when it equals the PTQ-only width.
    """
    if point.bits != 200 or point.placement != "distributive":
        return None
    row = PAPER_TABLE3.get(point.preset)
    if row is None:
        return None
    if point.variant == "TEN":
        return row["ten_luts"]
    if point.input_bits == row["ft_bits"]:
        return row["ft_luts"]
    if point.input_bits == row["pen_bits"]:
        return row["pen_luts"]
    return None


def lut_error_pct(total_luts: int, paper_luts: int | None) -> float | None:
    """Signed relative LUT error vs the paper, in percent (None w/o ref)."""
    if not paper_luts:
        return None
    return 100.0 * (total_luts - paper_luts) / paper_luts


# ---------------------------------------------------------------------------
# Table I — hardware comparison rows (TEN and PEN+FT per preset)
# ---------------------------------------------------------------------------

def table1_model_rows(bundle: dict, name: str) -> list[tuple]:
    """Table I rows for one trained bundle.

    Args:
      bundle: trained-model dict with ``frozen_ten``, ``frozen_ft`` and
        ``ft_bits`` keys (the reference's ``benchmarks/common.py`` bundle).
      name: preset name, used for the paper lookup.

    Returns ``[(variant, HWReport, paper_row_dict, err_pct), ...]`` for
    the TEN and PEN+FT variants.
    """
    rep_ten = dwn_hw_report(bundle["frozen_ten"], variant="TEN", name=name)
    rep_ft = dwn_hw_report(bundle["frozen_ft"], variant="PEN+FT", name=name,
                           input_bits=bundle["ft_bits"])
    rows = []
    for variant, rep in (("TEN", rep_ten), ("PEN+FT", rep_ft)):
        paper = PAPER_TABLE1.get((name, variant), {})
        err = (100.0 * (rep.total_luts - paper["luts"]) / paper["luts"]
               if paper else float("nan"))
        rows.append((variant, rep, paper, err))
    return rows


# ---------------------------------------------------------------------------
# Fig. 2 — distributive vs uniform encoding (sample rows + accuracy delta)
# ---------------------------------------------------------------------------

def placement_popcounts(data, modes=("distributive", "uniform"),
                        num_features: int = 16, bits: int = 200,
                        sample: int = 0) -> dict:
    """Per-feature set-bit counts of one JSC sample under each placement.

    Returns {mode: (num_features,) array, entry f in [0, bits]} — how
    many of feature f's thresholds the sample exceeds, the encodings'
    side-by-side comparison (Fig. 2's left panel).
    """
    from ..core.thermometer import ThermometerSpec, fit_thresholds, encode_np
    x0 = data.x_train[sample:sample + 1]
    out = {}
    for mode in modes:
        spec = ThermometerSpec(num_features, bits, mode)
        th = fit_thresholds(data.x_train, spec)
        out[mode] = encode_np(x0, th, flatten=False)[0].sum(axis=1)
    return out


def encoding_mode_accuracy(data, preset: str, mode: str, *,
                           epochs: int = 6, batch: int = 128,
                           lr: float = 1e-3, seed: int = 0,
                           device=None) -> float:
    """Hard-inference accuracy of ``preset`` trained under one placement.

    The training recipe (warmstart, epochs, batch, lr, seed) is the
    reference's Fig. 2 recipe; the init comes from a torch generator
    seeded by ``seed`` on the host, and training runs on ``device``
    (default ``cuda``; raises without a card).
    """
    import torch
    from ..core import JSC_PRESETS, train_dwn, freeze, eval_accuracy_hard
    from ..core.warmstart import warmstart_dwn
    cfg = dataclasses.replace(JSC_PRESETS[preset], encoding=mode)
    params, buffers = warmstart_dwn(torch.Generator().manual_seed(seed),
                                    cfg, data.x_train, data.y_train)
    res = train_dwn(cfg, data, epochs=epochs, batch=batch, lr=lr,
                    params=params, buffers=buffers, verbose=False,
                    device=device)
    return eval_accuracy_hard(freeze(res.params, res.buffers, cfg),
                              data.x_test, data.y_test,
                              device=res.buffers["thresholds"].device)


# ---------------------------------------------------------------------------
# Fig. 5 — component LUT breakdown vs input bit-width
# ---------------------------------------------------------------------------

def breakdown_rows(frozen, name: str,
                   bits_range=(6, 7, 8, 9, 10, 11, 12)) -> list[tuple]:
    """PEN+FT component breakdown per input bit-width for one model.

    Returns ``[(input_bits, {component: LUTs}, total_luts), ...]`` — the
    Fig. 5 stacked-bar data.
    """
    rows = []
    for bits in bits_range:
        rep = dwn_hw_report(frozen, variant="PEN+FT", name=name,
                            input_bits=bits)
        rows.append((bits, rep.luts, max(rep.total_luts, 1)))
    return rows


# ---------------------------------------------------------------------------
# Fig. 6 — accuracy vs LUTs scatter (literature + our points)
# ---------------------------------------------------------------------------

def literature_points() -> list[tuple]:
    """Table II's non-DWN rows as ``(label, acc_pct, luts)`` points."""
    return [(m, a, l) for (m, a, l, *_r) in PAPER_TABLE2
            if not m.startswith("DWN")]


def our_points(bundle: dict, name: str) -> list[tuple]:
    """Our TEN and PEN+FT operating points for one trained bundle,
    as ``(label, acc_pct, luts)`` (accuracy in percent, Fig. 6's axis)."""
    ten = dwn_hw_report(bundle["frozen_ten"], variant="TEN", name=name)
    ft = dwn_hw_report(bundle["frozen_ft"], variant="PEN+FT", name=name,
                       input_bits=bundle["ft_bits"])
    return [(f"DWN-TEN({name})[ours]", 100 * bundle["float_acc"],
             ten.total_luts),
            (f"DWN-PEN+FT({name})[ours]", 100 * bundle["ft_acc"],
             ft.total_luts)]


__all__ = [
    "PRESETS", "TABLE1_TEN_TOLERANCE", "breakdown_rows",
    "encoding_mode_accuracy", "literature_points", "lut_error_pct",
    "our_points", "paper_reference", "placement_popcounts",
    "table1_model_rows",
]
