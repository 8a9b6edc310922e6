"""Optimization via feasibility + binary search (paper §2.2, §3), in PyTorch.

Port of ``repro.core.feasibility``: DEPRECATED SHIMS. The binary-search
functions that lived here are the ``batch_width=1`` mode of
:class:`repro_torch.api.Solver`; these wrappers keep the original
signatures and return type (:class:`BinarySearchResult`) and delegate to
it. New code should build a :class:`repro_torch.api.Problem` and call
``Solver.solve``.

The reduction: MWU solves *feasibility* mixed packing/covering LPs;
optimization embeds the objective as one extra constraint row and
binary-searches its bound:

* pure packing    max <c,x> : Px <= 1   ->  add covering row <c,x>/M >= 1
* pure covering   min <c,x> : Cx >= 1   ->  add packing  row <c,x>/M <= 1
* densest subgraph: binary search the density bound D of the dual (15).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..utils.deprecation import warn_once
from .mwu import MWUOptions, MWUResult
from .operators import LinOp

warn_once(
    "repro_torch.core.feasibility",
    "repro_torch.core.feasibility is deprecated; build a repro_torch.api.Problem and use "
    "repro_torch.api.Solver.solve",
)

__all__ = [
    "BinarySearchResult",
    "maximize_packing",
    "minimize_covering",
    "densest_subgraph_search",
]


@dataclass
class BinarySearchResult:
    x: np.ndarray  # best feasible solution found (original variable space)
    objective: float  # certified objective value of x (after 1+eps rescale)
    bound: float  # final binary-search bound
    feasibility_calls: int
    mwu_iters_total: int
    ls_probes_total: int
    last_result: MWUResult | None = None

    @property
    def found(self):
        return self.x is not None


def _from_solution(sol) -> BinarySearchResult:
    return BinarySearchResult(
        x=sol.x,
        objective=sol.objective if sol.found else 0.0,
        bound=sol.bound,
        feasibility_calls=sol.feasibility_calls,
        mwu_iters_total=sol.mwu_iters_total,
        ls_probes_total=sol.ls_probes_total,
        last_result=sol.last_result,
    )


def _solve(problem, opts: MWUOptions, rel_tol):
    # imported lazily: repro_torch.api imports repro_torch.core at module load
    from ..api import Solver

    return _from_solution(Solver(opts, batch_width=1, rel_tol=rel_tol).solve(problem))


def _objective_problem(name: str, kind: str, sense: str, bound_mode: str, op: LinOp, side: str, c, lo, hi):
    from ..api import Problem

    c = c if isinstance(c, torch.Tensor) else torch.as_tensor(np.asarray(c), device=op.colmax().device)
    return Problem(name=name, kind=kind, sense=sense, bound_mode=bound_mode, **{side: op}, c=c, lo=float(lo),
                   hi=float(hi), n_vars=op.shape[1], nnz=op.nnz, device=c.device, dtype=c.dtype)


def maximize_packing(
    P: LinOp,
    c,
    lo: float,
    hi: float,
    opts: MWUOptions = MWUOptions(),
    rel_tol: float | None = None,
) -> BinarySearchResult:
    """max <c, x>  s.t.  P x <= 1, x >= 0.  (deprecated shim)

    ``lo`` must be an achievable objective value, ``hi`` an upper bound
    (from a combinatorial heuristic, see graphs/baselines.py).
    Feasible at M means objective >= M is reachable with Px <= (1+eps);
    dividing x by (1+eps) certifies objective >= M/(1+eps).
    """
    prob = _objective_problem("packing", "packing", "max", "objective_covering", P, "P", c, lo, hi)
    return _solve(prob, opts, rel_tol)


def minimize_covering(
    C: LinOp,
    c,
    lo: float,
    hi: float,
    opts: MWUOptions = MWUOptions(),
    rel_tol: float | None = None,
) -> BinarySearchResult:
    """min <c, x>  s.t.  C x >= 1, x >= 0.  (deprecated shim)

    Feasible at M certifies opt <= M (1+eps); infeasible certifies opt > M.
    Searches the smallest feasible M in [lo, hi] at eps/2 granularity.
    """
    prob = _objective_problem("covering", "covering", "min", "objective_packing", C, "C", c, lo, hi)
    return _solve(prob, opts, rel_tol)


def densest_subgraph_search(
    make_PC: Callable[[float], tuple[LinOp, LinOp]],
    lo: float,
    hi: float,
    opts: MWUOptions = MWUOptions(),
    rel_tol: float | None = None,
) -> BinarySearchResult:
    """min D s.t. the dual feasibility LP (15) is feasible.  (deprecated shim)

    ``make_PC(D)`` builds (P, C) = (O/D, W). Feasible iff D >= rho*
    (the maximum density), so we search the smallest feasible D
    (eps/2 granularity; see minimize_covering). Prefer the declarative
    ``graphs.problems.densest_subgraph_lp`` (bound_mode="scale_packing").
    """
    from ..api import Problem

    prob = Problem(name="densest", kind="densest", sense="min", bound_mode="callable", make_ops=make_PC,
                   lo=float(lo), hi=float(hi))
    return _solve(prob, opts, rel_tol)
