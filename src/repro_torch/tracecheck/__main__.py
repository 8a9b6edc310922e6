"""CLI entry: ``python -m repro_torch.tracecheck --matrix`` / ``--ast``.

Port of ``repro.tracecheck.__main__``::

    python -m repro_torch.tracecheck --ast                 # seconds, no torch
    python -m repro_torch.tracecheck --matrix --quick      # the CPU cases; card cases skipped
    python -m repro_torch.tracecheck --matrix --out TRACECHECK.json --costmodel-out COSTMODEL.json

``--ast`` lints the source tree (stdlib only: :mod:`.astlint` never
imports torch or jax, and the package ``__init__`` is lazy, so this path
works where torch is absent). There is no ``--devices``: the dist cases
run over a fake process group in this process.

Exit status is the reference's: 0 iff no error finding is missing from the
baseline allowlist (:mod:`.report`); ``--ast`` exits nonzero on any
unsuppressed finding (no baseline for the source lint); 2 with neither
``--ast`` nor ``--matrix`` nor ``--list``.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tracecheck",
        description="source lint and recorded-run analysis of the solver's performance invariants",
    )
    ap.add_argument("--matrix", action="store_true", help="run the default case sweep")
    ap.add_argument("--ast", nargs="*", default=None, metavar="PATH",
                    help="AST source lint (RPR rule codes); default path: the repro_torch package")
    ap.add_argument("--quick", action="store_true", help="trimmed sweep")
    ap.add_argument("--list", action="store_true", help="print the case names and exit")
    ap.add_argument("--out", default=None, metavar="PATH", help="write TRACECHECK.json here")
    ap.add_argument("--costmodel-out", default=None, metavar="PATH", help="write COSTMODEL.json here")
    ap.add_argument("--baseline", default=None, metavar="PATH", help="allowlist file override")
    ap.add_argument("--cost-baseline", default=None, metavar="PATH",
                    help="cost baseline file override (default: costmodel_baseline.json)")
    ap.add_argument("--update-cost-baseline", action="store_true",
                    help="rewrite the per-lane-iteration cost baseline from this run's cells")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="drop baseline fingerprints that no longer fire (prints removals)")
    args = ap.parse_args(argv)

    if args.ast is not None:
        from . import astlint  # stdlib only: never touches torch

        findings = astlint.lint_paths(args.ast or [astlint.default_root()])
        print(astlint.format_findings(findings))
        if findings:
            return 1
        if not args.matrix:
            return 0
    if args.list:
        from .matrix import default_matrix

        for case in default_matrix(quick=args.quick):
            print(case.name)
        return 0
    if not args.matrix:
        ap.print_help()
        return 2

    from .cli import run_matrix

    report = run_matrix(
        quick=args.quick,
        baseline=args.baseline,
        out=args.out,
        costmodel_out=args.costmodel_out,
        cost_baseline=args.cost_baseline,
        update_cost_baseline=args.update_cost_baseline,
        prune=args.prune_baseline,
    )
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
