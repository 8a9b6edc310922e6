"""Differential proofs over recorded op streams: canonicalize two and diff them.

Port of ``repro.tracecheck.diff``. The port makes two parity claims:

* **dist identity** -- on the identity :class:`~repro_torch.dist.mesh.MeshPlan`,
  ``DistSolver.solve_batch`` runs the *same ops* as ``Solver.solve_batch``
  (no wrapper, no slab, no collective): the two recorded solves are equal
  token for token (:func:`check_dist_identity`).
* **backend parity** -- a case run on the card may differ from the same
  case on the CPU *only inside kernel regions*: each divergent region of
  a steady loop iteration must hold a kernel token on one side (the kernel
  there, its plain version's expression on the other: the operators'
  products are ``index_add_`` on the CPU and the scatter kernel on the
  card), and no read, collective or lane boundary on either side
  (:func:`check_backend_parity`). The first loop iteration is not
  compared: ``kernels.loader.scratch`` allocates on a kernel's first
  launch.

Canonicalization happens as the recorder writes a token
(:mod:`.capture`): an op's name with its operands' and outputs' dtypes and
shapes, devices dropped, a commutative op's operands sorted, a kernel call
one token whichever version runs, a composite op that reaches the mode
whole (``matmul``, ``einsum`` under ``inference_mode``) one token on both
sides. :func:`canonical_tokens` lays a recorded solve, loop iteration or
lane iteration out as one stream with its lane brackets. There is no
jaxpr and no HLO, hence no hierarchical diff: a recorded stream is flat.

Every divergence is a :class:`~.rules.Finding` (rules
``stream-parity-dist`` / ``stream-parity-backend``); a deliberate one is
named in ``baseline.json`` with its reason, never silenced here.
"""
from __future__ import annotations

import difflib
from dataclasses import dataclass

from .rules import ERROR, Finding, LaneIteration, LoopIteration, SolveRecord, TraceArtifact

__all__ = [
    "canonical_tokens",
    "diff_tokens",
    "DiffRegion",
    "check_dist_identity",
    "check_backend_parity",
    "DIST_PARITY_RULE",
    "BACKEND_PARITY_RULE",
]

DIST_PARITY_RULE = "stream-parity-dist"
BACKEND_PARITY_RULE = "stream-parity-backend"

_STRUCTURAL = ("read:", "coll:", "lane ", "end lane", "loop", "solve", "start", "finalize")


def canonical_tokens(x) -> list[str]:
    """The token stream of a recorded artifact (all its solves), solve,
    loop iteration or lane iteration, with its structure as tokens."""
    if isinstance(x, LaneIteration):
        return [f"lane {x.lane}"] + list(x.tokens) + ["end lane"]
    if isinstance(x, LoopIteration):
        return ["loop"] + [t for ln in x.lanes for t in canonical_tokens(ln)] + list(x.tokens)
    if isinstance(x, SolveRecord):
        out = ["start"] + list(x.start)
        for it in x.iterations:
            out += canonical_tokens(it)
        return out + ["finalize"] + list(x.finalize)
    if isinstance(x, TraceArtifact):
        return [t for s in x.solves for t in ["solve"] + canonical_tokens(s)]
    raise TypeError(f"canonical_tokens: not a recorded stream: {type(x).__name__}")


@dataclass
class DiffRegion:
    """One divergent run between two canonical token streams."""

    kind: str  # replace | delete | insert
    a_start: int
    a_tokens: list
    b_start: int
    b_tokens: list

    def has_kernel(self) -> bool:
        return any(t.startswith("kernel:") for t in self.a_tokens + self.b_tokens)

    def structural(self) -> list[str]:
        return sorted({t for t in self.a_tokens + self.b_tokens if t.startswith(_STRUCTURAL)})

    def summary(self, n: int = 3) -> str:
        def clip(toks):
            shown = [t[:90] for t in toks[:n]]
            more = f" …+{len(toks) - n}" if len(toks) > n else ""
            return "; ".join(shown) + more

        return f"a[{self.a_start}]: {clip(self.a_tokens) or '∅'}  <->  b[{self.b_start}]: {clip(self.b_tokens) or '∅'}"


def diff_tokens(a: list, b: list) -> list[DiffRegion]:
    """Non-equal opcode runs of a sequence alignment of two token streams."""
    sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    return [DiffRegion(kind=tag, a_start=i1, a_tokens=a[i1:i2], b_start=j1, b_tokens=b[j1:j2])
            for tag, i1, i2, j1, j2 in sm.get_opcodes() if tag != "equal"]


def _finding(rule, artifact, message, *, key="", **detail) -> Finding:
    return Finding(rule=rule, severity=ERROR, artifact=artifact, message=message, key=key, detail=detail)


def _regions(head) -> list[dict]:
    return [{"kind": r.kind, "a_start": r.a_start, "b_start": r.b_start, "a": r.a_tokens[:6], "b": r.b_tokens[:6]}
            for r in head]


def check_dist_identity(art_solver: TraceArtifact, art_dist: TraceArtifact, artifact: str) -> list[Finding]:
    """Prove an identity-plan DistSolver run == the plain Solver run, token
    for token over their solves (``_start``, the loop, ``_finalize``)."""
    a, b = canonical_tokens(art_solver), canonical_tokens(art_dist)
    regions = diff_tokens(a, b)
    if not regions and a:
        return []
    if not a and not b:
        return [_finding(DIST_PARITY_RULE, artifact, "neither run recorded an MWU solve", key="empty")]
    head = regions[:4]
    return [_finding(
        DIST_PARITY_RULE, artifact,
        f"identity-MeshPlan DistSolver stream diverges from Solver in {len(regions)} region(s) — the "
        "1-rank parity contract is broken: " + " | ".join(r.summary() for r in head),
        key="diverged", n_regions=len(regions), regions=_regions(head),
    )]


def check_backend_parity(art_cpu: TraceArtifact, art_card: TraceArtifact, artifact: str) -> list[Finding]:
    """The card's steady loop iteration may differ from the CPU's only inside
    kernel regions (module docstring)."""
    a_it, b_it = art_cpu.steady_iteration(), art_card.steady_iteration()
    if a_it is None or b_it is None:
        return [_finding(BACKEND_PARITY_RULE, artifact, "a side recorded no loop iteration to compare",
                         key="missing-loop")]
    regions = diff_tokens(canonical_tokens(a_it), canonical_tokens(b_it))
    bad = [r for r in regions if r.structural() or not r.has_kernel()]
    if not bad:
        return []
    head = bad[:4]
    touched = sorted({t for r in head for t in r.structural()}) or ["ops outside any kernel region"]
    return [_finding(
        BACKEND_PARITY_RULE, artifact,
        f"{len(bad)} card-vs-CPU divergence region(s) outside the kernel regions ({touched}) — the two "
        "devices no longer run the same loop: " + " | ".join(r.summary() for r in head),
        key="structural-drift", n_regions=len(regions), n_bad=len(bad), regions=_regions(head),
    )]
