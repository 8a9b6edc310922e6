"""Per-lane-iteration cost gate: FLOPs / HBM bytes / collectives.

Port of ``repro.tracecheck.costmodel``. The reference reads its counters
off the compiled HLO of the loop's body. The port compiles nothing: a
cell's counters are the ``utils.opcount.OpCounter`` report of one steady
lane iteration of a recorded case (:mod:`.capture`; the second loop
iteration, the mean over its lanes): FLOPs by rate, HBM bytes (a kernel
call charged by its own formula, inputs read once and outputs written
once, whichever version runs), collective wire bytes and the collectives'
count. Seconds come from :func:`repro_torch.utils.roofline.static_cost_terms`,
so the cost model and the dry run's roofline never disagree on a rate.

Counts do not depend on the device, only on the path: a card case
reckoned on the CPU with the card's products (:func:`.capture.reckon_case`)
counts what the card runs. :func:`check_reckoned` holds a card cell to
that reckoning (FLOPs equal, bytes within :data:`RECKON_REL`), and the
committed baseline (``costmodel_baseline.json`` beside this module) is
written from a CPU run, card cells reckoned so.

Gating is the reference's: :func:`check_costs` fails a counter that grew
past its relative tolerance (:data:`DEFAULT_TOLERANCES`, the reference's
numbers), warns on a cell with no baseline, and never fails a shrink;
``python -m repro_torch.tracecheck --matrix --update-cost-baseline``
rewrites the baseline.
"""
from __future__ import annotations

import json
import os

from .rules import ERROR, WARNING, Finding

__all__ = [
    "COST_RULE",
    "RECKON_RULE",
    "COSTMODEL_BASELINE",
    "DEFAULT_TOLERANCES",
    "RECKON_REL",
    "iteration_cost",
    "cost_cells",
    "check_costs",
    "check_reckoned",
    "load_cost_baseline",
    "write_cost_baseline",
    "build_costmodel_report",
]

COST_RULE = "cost-regression"
RECKON_RULE = "cost-device"

COSTMODEL_BASELINE = os.path.join(os.path.dirname(__file__), "costmodel_baseline.json")

# relative growth allowed per counter before the gate fails (the reference's):
# the collective *count* is exact
DEFAULT_TOLERANCES = {
    "flops": 0.15,
    "hbm_bytes": 0.25,
    "collective_wire_bytes": 0.10,
    "n_collectives": 0.0,
}
RECKON_REL = 1e-6  # a card cell's bytes against its CPU reckoning (FLOPs: equal)

_METRICS = tuple(DEFAULT_TOLERANCES)


def iteration_cost(art) -> dict | None:
    """Per-lane-iteration counters of ``art``'s steady loop iteration, or None
    where it recorded no loop (a kernel artifact)."""
    from ..utils.opcount import OpReport
    from ..utils.roofline import static_cost_terms

    it = art.steady_iteration()
    if it is None or not it.lanes:
        return None
    rep = OpReport.combine([(1.0 / len(it.lanes), ln.report) for ln in it.lanes])
    return {
        "flops": rep.flops,
        "flops_by_dtype": dict(rep.flops_by_dtype),
        "dot_flops": rep.dot_flops,
        "fusion_flops": rep.fusion_flops,
        "kernel_flops": rep.kernel_flops,
        "hbm_bytes": rep.hbm_bytes,
        "collective_wire_bytes": rep.collective_wire_bytes,
        "n_collectives": rep.n_collectives,
        "kernel_calls": dict(rep.kernel_calls),
        "lanes": len(it.lanes),
        "device": art.device,
        "roofline": static_cost_terms(rep.flops_by_dtype, rep.hbm_bytes, rep.collective_wire_bytes),
    }


def cost_cells(artifacts) -> dict[str, dict]:
    """{artifact name: per-lane-iteration counters} of the looping artifacts."""
    cells: dict[str, dict] = {}
    for art in artifacts:
        cost = iteration_cost(art)
        if cost is not None:
            cells[art.name] = cost
    return cells


def check_costs(cells: dict, baseline: dict, tolerances: dict | None = None) -> list:
    """Findings for cells whose counters regressed past tolerance: one a
    (cell, counter), key ``<counter>``; a cell with no baseline warns."""
    tolerances = DEFAULT_TOLERANCES if tolerances is None else tolerances
    findings: list[Finding] = []
    for name in sorted(cells):
        cost = cells[name]
        base = baseline.get(name)
        if base is None:
            findings.append(Finding(
                rule=COST_RULE, severity=WARNING, artifact=name, key="missing-baseline",
                message=(
                    "no committed cost baseline for this cell — regenerate "
                    "costmodel_baseline.json (--update-cost-baseline) and commit it"
                ),
            ))
            continue
        for metric, tol in tolerances.items():
            have = float(cost.get(metric, 0.0))
            want = float(base.get(metric, 0.0))
            if have <= want * (1.0 + tol) + 1e-9:
                continue
            growth = have / want - 1.0 if want else float("inf")
            findings.append(Finding(
                rule=COST_RULE, severity=ERROR, artifact=name, key=metric,
                message=(
                    f"per-lane-iteration {metric} grew {growth * 100:.1f}% over the "
                    f"committed baseline ({want:.4g} -> {have:.4g}, tolerance "
                    f"{tol * 100:.0f}%) — the cost of one MWU step regressed"
                ),
                detail={"metric": metric, "baseline": want, "current": have, "tolerance": tol},
            ))
    return findings


def check_reckoned(cells: dict, reckoned: dict) -> list:
    """Findings for card cells whose counts differ from their CPU reckoning:
    FLOPs and the collectives' count unequal, or HBM and wire bytes apart by
    more than :data:`RECKON_REL` (relative)."""
    findings: list[Finding] = []
    for name in sorted(set(cells) & set(reckoned)):
        have, want = cells[name], reckoned[name]
        for metric, rel in (("flops", 0.0), ("n_collectives", 0.0), ("hbm_bytes", RECKON_REL),
                            ("collective_wire_bytes", RECKON_REL)):
            a, b = float(have[metric]), float(want[metric])
            if abs(a - b) <= rel * max(abs(b), 1.0):
                continue
            findings.append(Finding(
                rule=RECKON_RULE, severity=ERROR, artifact=name, key=metric,
                message=f"{metric} a lane iteration on {have.get('device')} is {a!r}, its CPU reckoning {b!r} — "
                        "the card runs another path than the one the cost model counts",
                detail={"metric": metric, "device": a, "reckoned": b},
            ))
    return findings


def load_cost_baseline(path: str | None = None) -> dict:
    path = path or COSTMODEL_BASELINE
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f).get("cells", {})


def write_cost_baseline(cells: dict, path: str | None = None) -> str:
    """Persist the gated counters (only) of every cell as the new baseline."""
    path = path or COSTMODEL_BASELINE
    slim = {name: {m: cost.get(m, 0) for m in _METRICS} for name, cost in sorted(cells.items())}
    with open(path, "w") as f:
        json.dump({"cells": slim}, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def build_costmodel_report(cells: dict, baseline: dict, findings, reckoned: dict | None = None) -> dict:
    """The COSTMODEL.json payload (cells, reckonings, comparison, verdict)."""
    return {
        "cells": {name: dict(cost) for name, cost in sorted(cells.items())},
        "reckoned": {name: dict(cost) for name, cost in sorted((reckoned or {}).items())},
        "baseline": {name: dict(b) for name, b in sorted(baseline.items())},
        "findings": [f.as_dict() for f in findings],
        "ok": not any(f.severity == ERROR for f in findings),
    }
