"""One solver facade for every graph LP: bound search over lane-batched feasibility solves, in PyTorch.

Port of ``repro.api.solver``. ``Solver`` turns a
:class:`~repro_torch.api.problem.Problem` into a :class:`Solution` by
reducing optimization to feasibility (paper §2.2) and searching the
objective bound. Two execution modes, as in the reference:

* ``batch_width == 1`` — the paper's sequential geometric binary search,
  one feasibility solve per probe.
* ``batch_width K > 1`` — speculative bracket evaluation: each round
  instantiates K candidate bounds and solves them as the K lanes of one
  loop (:meth:`Solver.solve_batch`, ``core.mwu.solve_lanes``), shrinking
  the bracket by ~(K+1)x per round. The reference ``jax.vmap``s its loop
  across the bounds; here the lanes launch the kernels one lane after
  another on their own rows and the host reads the loop's state once an
  iteration for all of them. Each lane equals the sequential solve at its
  bound bit for bit, so the search, its bounds and its result are those of
  a sequential run of the same rounds.

``solve_batch`` exposes the raw fan-out: a batched ``MWUResult`` across an
array of bounds, optionally also across stacked same-shape graph
instances (:func:`stack_problems`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.mwu import MWUOptions, MWUResult, Status, solve, solve_lanes, solve_traced
from ..core.operators import LinOp
from .problem import Problem

__all__ = [
    "Solution",
    "Solver",
    "stack_problems",
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


# -- instance batching ------------------------------------------------------
# A Problem as the reference's pytree sees it: these fields are its leaves
# (None is an empty subtree, lo and hi are numbers); the rest is static. An
# operator's tensors are leaves and its other fields static.
_LEAF_FIELDS = ("P", "C", "c", "p_mask", "c_mask", "lo", "hi")
_STATIC_FIELDS = ("name", "kind", "sense", "bound_mode", "n_vars", "nnz", "make_ops", "device", "dtype")


def _node(value) -> bool:
    """Whether an operator's field is part of the tree (a tensor, an
    operator, a tuple of operators or None) rather than static."""
    if isinstance(value, tuple):
        return bool(value) and all(isinstance(v, LinOp) for v in value)
    return value is None or isinstance(value, (LinOp, torch.Tensor))


def _flatten(value, path: str):
    """``(leaves, structure)``: the (path, leaf) pairs of ``value`` and a
    hashable description of everything else."""
    if isinstance(value, LinOp):
        leaves, struct = [], [type(value).__name__]
        for f in dataclasses.fields(value):
            sub = getattr(value, f.name)
            if _node(sub):
                lv, st = _flatten(sub, f"{path}.{f.name}")
                leaves += lv
                struct.append((f.name, st))
            else:
                struct.append((f.name, repr(sub)))
        return leaves, tuple(struct)
    if isinstance(value, tuple):
        flat = [_flatten(v, f"{path}[{i}]") for i, v in enumerate(value)]
        return [l for lv, _ in flat for l in lv], ("tuple", tuple(st for _, st in flat))
    if value is None:
        return [], None
    return [(path, value)], "leaf"


def _flatten_problem(p: Problem):
    flat = [_flatten(getattr(p, f), f".{f}") for f in _LEAF_FIELDS]
    return [l for lv, _ in flat for l in lv], tuple(st for _, st in flat)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, (torch.Tensor, np.ndarray)) else ()


def _check_stackable(problems: list[Problem]) -> None:
    """Raise a ValueError naming the first mismatched static field / leaf
    (the reference's checks and messages)."""
    ref = problems[0]
    ref_flat, ref_tree = _flatten_problem(ref)
    for i, p in enumerate(problems[1:], start=1):
        for f in _STATIC_FIELDS:
            a, b = getattr(ref, f), getattr(p, f)
            if a != b:
                raise ValueError(
                    f"stack_problems: problem 0 and problem {i} differ in "
                    f"static field {f!r}: {a!r} vs {b!r}; only problems of "
                    "the same family can be instance-batched"
                )
        flat, tree = _flatten_problem(p)
        if tree != ref_tree:
            keys0 = {k for k, _ in ref_flat}
            keys = {k for k, _ in flat}
            diff = sorted(keys0.symmetric_difference(keys)) or ["<nested structure>"]
            raise ValueError(
                f"stack_problems: problem 0 and problem {i} have different "
                f"pytree structure (mismatched leaves: {', '.join(diff)}); "
                "pad differently-shaped problems into a common bucket first"
            )
        for (key, leaf0), (_, leaf) in zip(ref_flat, flat):
            s0, s1 = _shape(leaf0), _shape(leaf)
            if s0 != s1:
                raise ValueError(
                    f"stack_problems: leaf {key!r} has "
                    f"shape {s1} in problem {i} but {s0} in problem 0; pad "
                    "differently-sized graphs into a common shape bucket "
                    "first"
                )


def _map(fn, values: list):
    """Rebuild ``values[0]``'s structure with ``fn`` of the matching leaves."""
    v0 = values[0]
    if isinstance(v0, LinOp):
        kw = {}
        for f in dataclasses.fields(v0):
            sub = getattr(v0, f.name)
            kw[f.name] = _map(fn, [getattr(v, f.name) for v in values]) if _node(sub) else sub
        return type(v0)(**kw)
    if isinstance(v0, tuple):
        return tuple(_map(fn, [v[i] for v in values]) for i in range(len(v0)))
    return None if v0 is None else fn(values)


def _leaf_stack(leaves: list):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.asarray([float(v) for v in leaves])


def stack_problems(problems: list[Problem]) -> Problem:
    """Stack same-shape Problems for instance-batched ``solve_batch``.

    All problems must share structure and leaf shapes (same vertex/edge
    counts). Every leaf gains a leading lane dim: tensors are stacked, the
    bounds ``lo`` and ``hi`` become numpy arrays. Mismatches raise a
    ``ValueError`` naming the offending field or leaf, as the reference's
    ``stack_problems`` does.
    """
    if not problems:
        raise ValueError("stack_problems: need at least one problem")
    problems = list(problems)
    _check_stackable(problems)
    p0 = problems[0]
    kw = {f: _map(_leaf_stack, [getattr(p, f) for p in problems]) for f in _LEAF_FIELDS}
    return dataclasses.replace(p0, **kw, graph=None)


def _lane_problem(stacked: Problem, j: int) -> Problem:
    """Lane j of a stacked Problem: views of its rows."""
    def pick(leaves):
        v = leaves[0]
        return float(v[j]) if isinstance(v, np.ndarray) else v[j]

    return dataclasses.replace(stacked, **{f: _map(pick, [getattr(stacked, f)]) for f in _LEAF_FIELDS})


class Solver:
    """The public facade: Problem in, Solution out.

    Parameters
    ----------
    opts:        core MWU configuration (eps, step rule, iteration cap).
    batch_width: candidate bounds probed per search round, as the lanes
                 of one batched solve; 1 reproduces the paper's sequential
                 binary search.
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

    def solve_batch(self, problem: Problem, bounds, *, batched_problem: bool = False) -> MWUResult:
        """Batched feasibility: one loop whose lanes are ``bounds``.

        With ``batched_problem=True``, ``problem`` carries a leading lane
        dim on every leaf (see :func:`stack_problems`) matching ``bounds``
        — fan-out across independent graph instances; each lane runs the
        kernels over its own operators. Otherwise the lanes share the
        problem's graph operators (and their scatter CSR), and only the
        bound-dependent row differs (``Problem.instantiate``).

        Returns an ``MWUResult`` whose every field has leading dim
        ``len(bounds)``; lane j equals ``feasible`` at bounds[j] bit for
        bit.
        """
        bounds = np.atleast_1d(np.asarray(bounds, dtype=np.float64))
        if batched_problem:
            K = len(np.atleast_1d(problem.lo))
            if K != len(bounds):
                raise ValueError(f"solve_batch: {len(bounds)} bounds for {K} stacked problems")
            lanes = [_lane_problem(problem, j).instantiate(float(b)) for j, b in enumerate(bounds)]
        else:
            lanes = [problem.instantiate(float(b)) for b in bounds]
        return solve_lanes(lanes, self.opts)

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
        """Evaluate feasibility at each bound; batched when width allows."""
        outs = []
        if len(bounds) > 1 and not trace:
            batch = self.solve_batch(problem, bounds)
            for j in range(len(bounds)):
                lane = batch.lane(j)
                outs.append((lane.status == Status.FEASIBLE, lane))
        else:
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
