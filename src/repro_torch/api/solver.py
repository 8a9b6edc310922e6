"""One driver for every graph LP: bound search over feasibility solves, in PyTorch.

Port of ``repro.api.solver``, sequential path. ``Solver`` turns a
:class:`~repro_torch.api.problem.Problem` into a :class:`Solution` by
reducing optimization to feasibility (paper §2.2) and searching the
objective bound. ``batch_width`` K keeps the reference's search shape:
each round probes K candidate bounds and shrinks the bracket by ~(K+1)x.
The reference solves those K bounds in one vmapped call; here they are
solved one after another. Each is an independent solve, so the search,
its bounds and its result are the same.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.mwu import MWUOptions, MWUResult, Status, solve, solve_traced
from .problem import Problem

__all__ = [
    "Solution",
    "Solver",
    "feasibility_solution",
    "not_found_solution",
    "certify_solution",
]


@dataclass
class Solution:
    """Result of a ``Solver`` run.

    ``objective`` is the certified value of ``x`` after the (1+eps)
    rescale (max: divide by packing overshoot; min: exploit covering
    slack); for densest-subgraph it is the certified density bound.
    ``trace`` (optional) is a list of per-feasibility-call dicts, each with
    the probed ``bound`` plus the ``max_violation`` / ``alpha`` / ``probes``
    arrays of Figure 3.
    """

    problem: str
    status: int  # core Status code of the certifying solve
    x: np.ndarray | None  # best feasible solution (original variables), on the host
    objective: float
    bound: float  # final search bound
    max_px: float  # certificates at exit
    min_cx: float
    feasibility_calls: int
    mwu_iters_total: int
    ls_probes_total: int
    last_result: MWUResult | None = None
    trace: list | None = None

    @property
    def found(self) -> bool:
        return self.x is not None

    @property
    def feasible(self) -> bool:
        return self.status == Status.FEASIBLE and self.found


class Solver:
    """The public facade: Problem in, Solution out.

    Parameters
    ----------
    opts:        core MWU configuration (eps, step rule, iteration cap).
    batch_width: candidate bounds probed per search round; 1 reproduces
                 the paper's sequential binary search.
    rel_tol:     bound-search granularity (default eps/2).
    max_calls:   total feasibility-solve budget per ``solve``.
    """

    def __init__(
        self,
        opts: MWUOptions | None = None,
        *,
        batch_width: int = 4,
        rel_tol: float | None = None,
        max_calls: int = 64,
    ):
        self.opts = opts if opts is not None else MWUOptions()
        if batch_width < 1:
            raise ValueError("batch_width must be >= 1")
        self.batch_width = int(batch_width)
        self.rel_tol = rel_tol
        self.max_calls = int(max_calls)

    def feasible(self, problem: Problem, bound=None, trace: bool = False):
        """One feasibility solve at a concrete bound.

        Returns ``MWUResult`` (or ``(MWUResult, trace_dict)`` with ``trace=True``).
        """
        P, C, pm, cm = problem.instantiate(bound)
        if trace:
            return solve_traced(P, C, self.opts, p_mask=pm, c_mask=cm)
        return solve(P, C, self.opts, p_mask=pm, c_mask=cm)

    def solve(self, problem: Problem, *, trace: bool = False) -> Solution:
        """Optimize ``problem`` via bound search over feasibility calls."""
        if problem.bound_mode == "none":
            return self._solve_feasibility(problem, trace)
        return self._bound_search(problem, trace)

    # pure feasibility problems skip the search entirely
    def _solve_feasibility(self, problem: Problem, trace: bool) -> Solution:
        traces = None
        if trace:
            res, tr = self.feasible(problem, trace=True)
            traces = [dict(bound=float("nan"), **tr)]
        else:
            res = self.feasible(problem)
        stats = {"calls": 1, "iters": res.iters, "probes": res.ls_probes}
        return feasibility_solution(problem, res, stats, traces)

    def _probe(self, problem, bounds, trace, traces, stats):
        """Evaluate feasibility at each bound, one solve after another."""
        outs = []
        for b in bounds:
            if trace:
                res, tr = self.feasible(problem, b, trace=True)
                traces.append(dict(bound=float(b), **tr))
            else:
                res = self.feasible(problem, b)
            outs.append((res.status == Status.FEASIBLE, res))
        stats["calls"] += len(bounds)
        stats["iters"] += sum(r.iters for _, r in outs)
        stats["probes"] += sum(r.ls_probes for _, r in outs)
        return outs

    def _bound_search(self, problem: Problem, trace: bool) -> Solution:
        is_max = problem.feasible_side == "lo"
        lo, hi = float(problem.lo), float(problem.hi)
        rel = self.rel_tol if self.rel_tol is not None else self.opts.eps / 2
        K = 1 if trace else self.batch_width
        stats = {"calls": 0, "iters": 0, "probes": 0}
        traces: list = [] if trace else None
        best = best_bound = None

        # min-like senses: the feasible side is hi; check it up front and
        # bail immediately when even hi fails.
        if not is_max:
            (ok, res), = self._probe(problem, [hi], trace, traces, stats)
            if not ok:
                return not_found_solution(problem, hi, res, stats, traces)
            best, best_bound = res, hi

        first = True
        while hi / max(lo, 1e-300) > 1.0 + rel and stats["calls"] < self.max_calls:
            r = hi / max(lo, 1e-300)
            if first and is_max and K > 1:
                # fold the feasible-side endpoint lo into round 1's batch
                pts = [lo * r ** (k / K) for k in range(K)]
            else:
                pts = [lo * r ** (k / (K + 1)) for k in range(1, K + 1)]
            outs = self._probe(problem, pts, trace, traces, stats)
            feas = [ok for ok, _ in outs]
            if is_max:
                # feasible for small bounds: push lo up to the largest
                # feasible probe, pull hi down to the smallest infeasible.
                f_idx = [i for i, ok in enumerate(feas) if ok]
                if f_idx:
                    j = f_idx[-1]
                    lo, best, best_bound = pts[j], outs[j][1], pts[j]
                elif first and K > 1:  # round 1 included lo itself
                    return not_found_solution(problem, lo, outs[0][1], stats, traces)
                i_idx = [i for i, ok in enumerate(feas) if not ok]
                if i_idx:
                    hi = pts[i_idx[0]]
            else:
                # feasible for large bounds: mirror image
                f_idx = [i for i, ok in enumerate(feas) if ok]
                if f_idx:
                    j = f_idx[0]
                    hi, best, best_bound = pts[j], outs[j][1], pts[j]
                i_idx = [i for i, ok in enumerate(feas) if not ok]
                if i_idx:
                    lo = pts[i_idx[-1]]
            first = False

        if best is None:  # only reachable for sense="max" (lo never probed)
            (ok, res), = self._probe(problem, [lo], trace, traces, stats)
            if not ok:
                return not_found_solution(problem, lo, res, stats, traces)
            best, best_bound = res, lo

        return certify_solution(problem, best, best_bound, stats, traces)


# -- Solution construction ------------------------------------------------
def feasibility_solution(problem, res, stats, traces=None) -> Solution:
    """Solution for a single feasibility solve (``bound_mode="none"``)."""
    ok = res.status == Status.FEASIBLE
    return Solution(
        problem=problem.name,
        status=res.status,
        x=res.x.cpu().numpy() if ok else None,
        objective=float("nan"),
        bound=float("nan"),
        max_px=res.max_px,
        min_cx=res.min_cx,
        feasibility_calls=stats["calls"],
        mwu_iters_total=stats["iters"],
        ls_probes_total=stats["probes"],
        last_result=res,
        trace=traces,
    )


def not_found_solution(problem, bound, res, stats, traces=None) -> Solution:
    """Solution reporting that even the easy endpoint bound was infeasible."""
    return Solution(
        problem=problem.name,
        status=res.status,
        x=None,
        objective=0.0,
        bound=float(bound),
        max_px=res.max_px,
        min_cx=res.min_cx,
        feasibility_calls=stats["calls"],
        mwu_iters_total=stats["iters"],
        ls_probes_total=stats["probes"],
        last_result=res,
        trace=traces,
    )


def certify_solution(problem, best, best_bound, stats, traces=None) -> Solution:
    """Rescale the raw MWU point into a certified solution (§2.2)."""
    x = best.x.cpu().numpy()
    if problem.sense == "max":
        # Px <= 1+eps: dividing by the overshoot certifies Px <= 1
        # at an objective loss of at most (1+eps).
        x = x / max(best.max_px, 1.0)
        objective = float(np.dot(problem.c.cpu().numpy(), x))
    elif problem.bound_mode == "objective_packing":
        # covering slack is free objective: x/min(Cx) stays feasible
        x = x / max(best.min_cx, 1.0)
        objective = float(np.dot(problem.c.cpu().numpy(), x))
    else:
        # densest-style: the bound itself is the certified objective
        objective = float(best_bound)
    return Solution(
        problem=problem.name,
        status=best.status,
        x=x,
        objective=objective,
        bound=float(best_bound),
        max_px=best.max_px,
        min_cx=best.min_cx,
        feasibility_calls=stats["calls"],
        mwu_iters_total=stats["iters"],
        ls_probes_total=stats["probes"],
        last_result=best,
        trace=traces,
    )
