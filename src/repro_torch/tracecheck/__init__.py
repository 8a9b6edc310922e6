"""The port's gate on the MWU loop's performance invariants.

Port of ``repro.tracecheck``. The paper's speedups live or die on the
per-iteration cost of the loop: the kernels on the hot path, one host read
a loop iteration, exactly the plan's collectives, a dtype that never
silently widens. Three passes check that:

1. **AST lint** (:mod:`.astlint`, ``--ast``): source-level RPR rule codes
   for the patterns that produce those regressions (host reads and device
   queries in loops, hard-coded f64, stray synchronizes, kernel wrappers
   the op counter cannot see, raw DeprecationWarnings). Stdlib only;
   suppression is per line (``# repro: noqa[RPR00x]``).
2. **recorded-run rules and the two parity proofs** (:mod:`.rules`,
   :mod:`.diff`, ``--matrix``): every hot entry point (``Solver.feasible``
   / ``solve_batch`` per family, ``solve_traced``, the lpserve dispatch
   keys, ``DistSolver`` mesh plans over a fake process group, each kernel
   wrapper) runs a few iterations under a recorder (:mod:`.capture`), and
   its op stream is checked. The card's stream may differ from the CPU's
   only inside kernel regions; an identity-plan ``DistSolver`` run is
   token for token the plain ``Solver``'s.
3. **cost model** (:mod:`.costmodel`): per-lane-iteration FLOPs, HBM
   bytes and collectives from the op counter (``utils.opcount``), gated
   against the committed ``costmodel_baseline.json``.

There is no jaxpr and no HLO in the port, so the reference's
``hlo_ir.py`` and ``jaxpr_scan.py`` have no counterpart: the recorded
eager run takes the place of the trace, ``utils/opcount.py`` that of the
HLO analyzer.

Intentional deviations are recorded per fingerprint in ``baseline.json``
(``{"allow": [...]}``), never by disabling a rule (:mod:`.report`).

Everything importing torch loads lazily (PEP 562), so ``import
repro_torch.tracecheck`` and the ``--ast`` path work without torch.
"""
from __future__ import annotations

__all__ = [
    "ERROR",
    "WARNING",
    "Finding",
    "Rule",
    "TraceArtifact",
    "run_rules",
]


def __getattr__(name):
    if name in __all__:
        from . import rules

        return getattr(rules, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
