"""Programmatic runner behind ``python -m repro_torch.tracecheck``.

Port of ``repro.tracecheck.cli``. :func:`run_matrix` records every case,
applies the three passes and builds the report dict; :mod:`.__main__`
wraps it in argument parsing and the exit code; ``chip_smoke.py``'s phase
14 calls it on the card.

The passes, in order:

1. **rules** -- the per-artifact invariants (:mod:`.rules`);
2. **parity** -- the differential proofs (:mod:`.diff`): each family's
   ``solve`` on the card against the CPU's, and each family's
   identity-plan ``DistSolver`` against the plain ``Solver``'s
   ``solve_batch``, paired from the recorded artifacts;
3. **costmodel** -- per-lane-iteration counters of every looping cell
   against the committed baseline, and each card cell against its CPU
   reckoning (:mod:`.costmodel`).

A capture that raises does not abort the sweep: the failed cell becomes
an error finding naming its family, backend and plan (rule
``capture-error``), and the other artifacts are still checked. A card
case on a host with no card is listed under ``skipped``; its costs are
still reckoned on the CPU (:func:`.capture.reckon_case`).
"""
from __future__ import annotations

from .matrix import Case, default_matrix
from .report import build_report, load_baseline, prune_baseline, summarize, write_report
from .rules import run_rules

__all__ = ["run_matrix", "CAPTURE_RULE"]

CAPTURE_RULE = "capture-error"


def _capture_finding(case, exc):
    from .rules import ERROR, Finding

    bits = [f"family `{case.family or '-'}`", f"backend `{case.backend}`"]
    if case.entry == "dist":
        bits.append(f"mesh plan pod{case.pod}x{case.data}")
    return Finding(
        rule=CAPTURE_RULE, severity=ERROR, artifact=case.name, key=type(exc).__name__,
        message=(
            f"capture of `{case.entry}` ({', '.join(bits)}) raised "
            f"{type(exc).__name__}: {exc} — the entry point no longer runs; "
            "remaining artifacts were still checked"
        ),
        detail={"entry": case.entry, "family": case.family, "backend": case.backend, "pod": case.pod,
                "data": case.data, "error": f"{type(exc).__name__}: {exc}"},
    )


def _parity_findings(artifacts) -> list:
    """The differential proofs over the recorded artifact pairs."""
    from .diff import check_backend_parity, check_dist_identity

    by_name = {a.name: a for a in artifacts}
    findings = []
    fams = []
    for a in artifacts:
        parts = a.name.split(":")
        if parts[0] == "solve" and len(parts) == 3 and parts[1] not in fams:
            fams.append(parts[1])
    for fam in fams:
        cpu, card = by_name.get(f"solve:{fam}:plain"), by_name.get(f"solve:{fam}:kernel")
        if cpu is not None and card is not None:
            findings.extend(check_backend_parity(cpu, card, f"parity:{fam}:backend"))
        batch, ident = by_name.get(f"solve_batch:{fam}:plain"), by_name.get(f"dist:{fam}:plain:pod1x1")
        if batch is not None and ident is not None:
            findings.extend(check_dist_identity(batch, ident, f"parity:{fam}:dist"))
    return findings


def run_matrix(
    cases: list[Case] | None = None,
    *,
    quick: bool = False,
    baseline: str | None = None,
    out: str | None = None,
    costmodel_out: str | None = None,
    cost_baseline: str | None = None,
    update_cost_baseline: bool = False,
    prune: bool = False,
    verbose: bool = True,
) -> dict:
    """Record and check the sweep; returns the report dict (see its ``ok``).

    The report also holds ``cost_cells`` (the looping cells' names),
    ``costs`` (each cell's counters), ``reckoned`` (each card cell's CPU
    reckoning) and, for ``chip_smoke.py``, the artifacts themselves under
    ``_artifacts`` (not written to ``out``). ``update_cost_baseline``
    rewrites the committed cost baseline from this run's cells (a card cell
    from its reckoning where this host has no card); ``prune`` drops
    baseline fingerprints that no longer fire.
    """
    from . import costmodel as _cm
    from .capture import capture_case, reckon_case

    cases = default_matrix(quick=quick) if cases is None else cases
    artifacts, skipped, findings, reckoned = [], [], [], []
    for case in cases:
        try:
            got = capture_case(case)
            if case.device != "cpu":
                rk = reckon_case(case)
                reckoned.extend([] if rk is None else rk if isinstance(rk, list) else [rk])
        except Exception as exc:  # noqa: BLE001 - any capture failure is the finding
            findings.append(_capture_finding(case, exc))
            continue
        if got is None:
            skipped.append(case.name)
            continue
        artifacts.extend(got if isinstance(got, list) else [got])

    findings.extend(run_rules(artifacts))
    findings.extend(_parity_findings(artifacts))

    cells = _cm.cost_cells(artifacts)
    reckoned_cells = _cm.cost_cells(reckoned)
    findings.extend(_cm.check_reckoned(cells, reckoned_cells))
    if update_cost_baseline:
        path = _cm.write_cost_baseline({**reckoned_cells, **cells}, cost_baseline)
        if verbose:
            print(f"costmodel: baseline rewritten with {len({**reckoned_cells, **cells})} cell(s) at {path}")
    cost_base = _cm.load_cost_baseline(cost_baseline)
    gated = {**{k: v for k, v in reckoned_cells.items() if k in skipped}, **cells}
    cost_findings = _cm.check_costs(gated, cost_base)
    findings.extend(cost_findings)
    if costmodel_out:
        write_report(_cm.build_costmodel_report(cells, cost_base, cost_findings, reckoned_cells), costmodel_out)

    allow = load_baseline(baseline)
    report = build_report(cases, artifacts, findings, allow, skipped=skipped)
    report["cost_cells"] = sorted(gated)
    report["costs"] = gated
    report["reckoned"] = reckoned_cells
    if prune:
        removed = prune_baseline(findings, baseline)
        report["pruned"] = removed
        if verbose:
            for fp in removed:
                print(f"pruned stale baseline fingerprint: {fp}")
            if not removed:
                print("baseline: nothing to prune")
    if out:
        write_report({k: v for k, v in report.items() if not k.startswith("_")}, out)
    report["_artifacts"] = artifacts
    if verbose:
        print(summarize(report))
    return report
