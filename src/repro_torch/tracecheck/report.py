"""Baseline allowlist and TRACECHECK.json reporting.

Port of ``repro.tracecheck.report``, unchanged in kind. The baseline
(``baseline.json`` beside this module, shipped empty, or a file passed with
``--baseline``) is ``{"allow": [<fingerprint>, ...]}``: the
:attr:`~.rules.Finding.fingerprint` strings of known, accepted
violations, each with its reason in the PR that adds it. The gate fails
only on *new* error findings; warnings never fail it. A report is written
only to a path the caller gives.
"""
from __future__ import annotations

import json
import os

from .rules import ERROR, Finding

__all__ = [
    "DEFAULT_BASELINE",
    "load_baseline",
    "prune_baseline",
    "split_findings",
    "build_report",
    "write_report",
    "summarize",
]

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: str | None = None) -> set[str]:
    """Allowed fingerprints from a baseline file (missing file = empty)."""
    path = path or DEFAULT_BASELINE
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        data = json.load(f)
    return set(data.get("allow", []))


def prune_baseline(findings: list[Finding], path: str | None = None) -> list[str]:
    """Drop allowlist fingerprints that no longer fire; returns the removed.
    The file is rewritten only when something was removed."""
    path = path or DEFAULT_BASELINE
    allow = load_baseline(path)
    live = {f.fingerprint for f in findings}
    removed = sorted(allow - live)
    if removed:
        with open(path, "w") as f:
            json.dump({"allow": sorted(allow & live)}, f, indent=2)
            f.write("\n")
    return removed


def split_findings(findings: list[Finding], allow: set[str]):
    """(new, baselined) partition of findings by baseline fingerprint."""
    new = [f for f in findings if f.fingerprint not in allow]
    old = [f for f in findings if f.fingerprint in allow]
    return new, old


def build_report(cases, artifacts, findings, allow, *, skipped=()) -> dict:
    """The TRACECHECK.json payload. ``ok`` gates the process exit code."""
    new, baselined = split_findings(findings, allow)
    new_errors = [f for f in new if f.severity == ERROR]
    return {
        "matrix": [c.name for c in cases],
        "artifacts": [a.name for a in artifacts],
        "skipped": list(skipped),
        "findings": [{**f.as_dict(), "baselined": f.fingerprint in allow} for f in findings],
        "n_findings": len(findings),
        "n_new_errors": len(new_errors),
        "n_baselined": len(baselined),
        "ok": not new_errors,
    }


def write_report(report: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")


def summarize(report: dict) -> str:
    """A one-screen summary for the CLI and chip_smoke.py."""
    lines = [
        f"tracecheck: {len(report['artifacts'])} artifact(s) from {len(report['matrix'])} case(s)"
        + (f", {len(report['skipped'])} skipped (no card)" if report["skipped"] else "")
    ]
    for f in report["findings"]:
        tag = "baselined" if f["baselined"] else f["severity"]
        lines.append(f"  [{tag}] {f['fingerprint']}: {f['message']}")
    if not report["findings"]:
        lines.append("  no findings")
    lines.append("PASS" if report["ok"] else f"FAIL: {report['n_new_errors']} new error finding(s)")
    return "\n".join(lines)
