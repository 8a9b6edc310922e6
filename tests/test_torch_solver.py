"""The port's Solver vs the reference Solver, family by family, on one instance.

Each reference ``repro.api.Problem`` is turned into plain fields (numpy
arrays, operators by class name) and rebuilt with
``repro_torch.api.problem_from_numpy``, so both packages solve the very
same LP. The bars (ROADMAP.md): the same status, the bound within rel
1e-5, the objective within rel 2*eps — the pallas-vs-xla bar of
tests/test_kernel_dispatch.py, since ulp differences steer the branchy
step-size search onto other trajectories.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.api import MWUOptions as RefOptions
from repro.api import Solver as RefSolver
from repro.core import operators as R
from repro.graphs import bipartite_ratings, build, grid2d, rgg
from repro.graphs.problems import generalized_matching_problem
from repro_torch.api import MWUOptions, Solver, Status, problem_from_numpy

EPS = 0.1


def _fields(obj):
    """A reference Problem or operator as plain fields for problem_from_numpy."""
    if isinstance(obj, R.LinOp):
        return {"op": type(obj).__name__, **{f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple):
        return tuple(_fields(o) for o in obj)
    if isinstance(obj, jax.Array):
        return np.asarray(obj)
    return obj


def port_problem(ref, device="cpu"):
    keys = ("name", "kind", "sense", "bound_mode", "P", "C", "c", "p_mask", "c_mask", "lo", "hi", "n_vars", "nnz")
    return problem_from_numpy({k: _fields(getattr(ref, k)) for k in keys}, device=device)


def _gen_match(g):
    s = g.bipartite_split
    deg = g.degrees()
    lb, ub = np.zeros(g.n), np.ones(g.n)
    lb[:s] = np.minimum(1, deg[:s])
    ub[:s], ub[s:] = 5, 8
    return generalized_matching_problem(g, lb, ub)


def _instance(family, gname):
    if family in ("bmatch", "gen-match"):
        g = bipartite_ratings(*{"small": (20, 12), "large": (60, 40)}[gname], avg_ratings=6.0, seed=1)
        return _gen_match(g) if family == "gen-match" else build("bmatch", g)
    g = {"grid4": grid2d(4), "grid5": grid2d(5), "grid6": grid2d(6), "rgg8": rgg(8, seed=0)}[gname]
    return build(family, g)


CASES = [(f, g, 1) for f in ("match", "vcover", "dom-set", "dense-sub") for g in ("grid4", "grid6", "rgg8")]
CASES += [(f, "grid5", 4) for f in ("match", "vcover", "dense-sub")] + [("dom-set", "grid4", 4)]
CASES += [(f, g, k) for f in ("bmatch", "gen-match") for g, k in (("small", 1), ("large", 4))]


@pytest.mark.parametrize("family,gname,K", CASES, ids=[f"{f}-{g}-K{k}" for f, g, k in CASES])
def test_solver_matches_reference(family, gname, K):
    ref_prob = _instance(family, gname)
    ref = RefSolver(RefOptions(eps=EPS, step_rule="newton"), batch_width=K).solve(ref_prob)
    got = Solver(MWUOptions(eps=EPS, step_rule="newton"), batch_width=K).solve(port_problem(ref_prob))
    assert got.status == int(ref.status), (got.status, int(ref.status))
    assert got.found == ref.found
    if ref_prob.bound_mode == "none":
        assert np.isnan(got.objective) and np.isnan(ref.objective)
        return
    assert got.bound == pytest.approx(ref.bound, rel=1e-5)
    assert got.objective == pytest.approx(ref.objective, rel=2 * EPS)


def test_dom_set_borderline_probe():
    """dom-set on grid2d(5) at K=4: the round-3 probe at bound 6.22797 lies
    inside the (1+eps) band below the exact LP value 6.2727 (HiGHS), where
    MWU may answer either way. The reference ends that solve INFEASIBLE
    (alpha < 1 after 410 iterations), the port FEASIBLE (max Px = 1.0099
    after 466), so the final bounds differ (6.3168 vs 6.2280; ROADMAP.md
    queue 3). Both are within the paper's band of the exact value."""
    from repro.graphs import baselines

    ref_prob = _instance("dom-set", "grid5")
    ref = RefSolver(RefOptions(eps=EPS, step_rule="newton"), batch_width=4).solve(ref_prob)
    got = Solver(MWUOptions(eps=EPS, step_rule="newton"), batch_width=4).solve(port_problem(ref_prob))
    exact, _ = baselines.exact_lp("dom-set", ref_prob.graph)
    assert got.status == int(ref.status) == Status.FEASIBLE
    for sol in (got, ref):
        assert abs(sol.objective - exact) <= 1.5 * EPS * exact
        assert sol.bound * (1 + EPS) >= exact  # a bound the relaxed LP admits
    assert got.objective == pytest.approx(ref.objective, rel=2 * EPS)


def test_binary_rule_stalls_at_certified_bound_as_reference():
    """The binary rule at a bmatch's certified bound, in the port and in the
    reference (ROADMAP.md queue 3). On bipartite_ratings(300, 60) (2,945
    edges) both Newton solves certify 60; at that bound the binary rule's
    solve stalls in both: alpha equal to rel 1e-6 for its first 80
    iterations (then the bisections part on ulps), the violation held at
    ~0.8662 from iteration ~100 (min Cx ~0.134), and both end INFEASIBLE
    once a search returns alpha < 1 (the reference after 661 iterations,
    the port after 939). The stall is the reference's own: the port's rule
    follows it."""
    from repro.core.mwu import solve_traced as ref_traced
    from repro_torch.core import solve_traced

    ref_prob = build("bmatch", bipartite_ratings(300, 60, avg_ratings=10.0, seed=0))
    prob = port_problem(ref_prob)
    newton = RefSolver(RefOptions(eps=EPS, step_rule="newton")).solve(ref_prob)
    bound = newton.bound
    assert Solver(MWUOptions(eps=EPS, step_rule="newton")).solve(prob).bound == bound == 60.0
    ref, ref_tr = ref_traced(*ref_prob.instantiate(bound)[:2], RefOptions(eps=EPS, step_rule="binary"),
                             p_mask=ref_prob.p_mask)
    got, tr = solve_traced(*prob.instantiate(bound)[:2], MWUOptions(eps=EPS, step_rule="binary"), p_mask=prob.p_mask)
    assert got.status == int(ref.status) == Status.INFEASIBLE
    ra, pa = np.asarray(ref_tr["alpha"]), np.asarray(tr["alpha"])
    np.testing.assert_allclose(pa[:80], ra[:80], rtol=1e-6)
    for it in (100, min(got.iters, int(ref.iters)) - 1):  # the plateau, to its end
        assert tr["max_violation"][it] == pytest.approx(ref_tr["max_violation"][it], abs=1e-3)
    assert got.min_cx == pytest.approx(float(ref.min_cx), rel=2e-3) and got.min_cx < 0.2


def test_feasibility_certificates_hold():
    """The port's certified x: Mx <= 1 for match, covering for vcover."""
    ref_prob = _instance("match", "rgg8")
    prob = port_problem(ref_prob)
    sol = Solver(MWUOptions(eps=EPS)).solve(prob)
    g = ref_prob.graph
    loads = np.bincount(g.u, sol.x, g.n) + np.bincount(g.v, sol.x, g.n)
    assert sol.x.min() >= 0 and loads.max() <= 1.0 + 1e-9
    assert sol.objective == pytest.approx(sol.x.sum())
    sol = Solver(MWUOptions(eps=EPS)).solve(port_problem(_instance("vcover", "rgg8")))
    assert (sol.x[g.u] + sol.x[g.v]).min() >= 1.0 - 1e-9


def test_traced_solve_layout():
    """trace=True gives one dict per feasibility call, in the reference's layout."""
    ref_prob = _instance("match", "grid4")
    sol = Solver(MWUOptions(eps=EPS)).solve(port_problem(ref_prob), trace=True)
    ref = RefSolver(RefOptions(eps=EPS)).solve(ref_prob, trace=True)
    assert len(sol.trace) == sol.feasibility_calls == len(ref.trace)
    for t, r in zip(sol.trace, ref.trace):
        assert set(t) == set(r)
        assert t["bound"] == pytest.approx(r["bound"], rel=1e-12)
        assert len(t["alpha"]) == len(t["probes"]) and len(t["max_violation"]) >= len(t["alpha"])
    assert sol.trace[-1]["max_violation"][-1] <= EPS + 1e-9 or not sol.feasible

