"""The port's MWU loop and Solver vs exact answers (HiGHS), on the CPU.

The reference's own acceptance bars, applied to the port alone: each
family within 1.5*eps of the exact LP value (tests/test_graph_problems.py),
Dense-operator feasibility agreeing with the reference's status and with
scipy (tests/test_mwu_solver.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from repro.core import Dense as RefDense
from repro.core import MWUOptions as RefOptions
from repro.core.mwu import solve as ref_solve
from repro_torch.api import MWUOptions, Solver, Status
from repro_torch.core import Dense, solve, solve_traced
from repro_torch.core.mwu import init_x
from repro_torch.graphs import Graph, baselines, bipartite_ratings, build, generalized_matching_lp

EPS = 0.1
OPTS = MWUOptions(eps=EPS, step_rule="newton", max_iter=20000)


def _port(g):
    return Graph(n=g.n, u=g.u, v=g.v, name=g.name, bipartite_split=g.bipartite_split)


@pytest.mark.parametrize("problem", ["match", "vcover", "dom-set", "dense-sub"])
@pytest.mark.parametrize("gname", ["grid6", "kron8", "er", "star", "triangle"])
def test_within_eps_of_exact(problem, gname, small_graphs):
    g = _port(small_graphs[gname])
    sol = Solver(OPTS).solve(build(problem, g, device="cpu"))
    exact, _ = baselines.exact_lp(problem, g)
    assert sol.found
    val = sol.bound if problem == "dense-sub" else sol.objective
    assert abs(val - exact) <= 1.5 * EPS * max(abs(exact), 1e-12), (problem, gname, exact, val)


def test_bmatch_within_eps_of_exact():
    g = bipartite_ratings(60, 40, avg_ratings=12.0, seed=0)
    exact = baselines.hopcroft_karp_bmatch(g)
    sol = Solver(OPTS).solve(build("bmatch", g, device="cpu"))
    assert sol.found
    assert (1 - 1.5 * EPS) * exact <= sol.objective <= exact * (1 + 1e-6) + 1e-6


def test_gen_match_feasibility():
    g = bipartite_ratings(50, 30, avg_ratings=15.0, seed=1)
    deg, s = g.degrees(), g.bipartite_split
    lb, ub = np.zeros(g.n), np.ones(g.n)
    lb[:s] = np.minimum(1, deg[:s])
    ub[:s], ub[s:] = 5, 8
    P, C, c_mask = generalized_matching_lp(g, lb, ub, device="cpu")
    res = solve(P, C, OPTS, c_mask=c_mask)
    assert res.status == Status.FEASIBLE
    x = res.x.numpy()
    loads = np.bincount(g.u, x, g.n) + np.bincount(g.v, x, g.n)
    assert (loads <= ub * 1.1 + 1e-9).all()
    assert (loads >= lb * (1 - 1e-9) - 1e-9)[lb > 0].all()
    assert x.max() <= 1.0 + EPS + 1e-9  # the x <= 1 box rows


def _dense(a):
    return Dense(mat=torch.as_tensor(a, dtype=torch.float64)), RefDense(mat=jnp.asarray(a))


@pytest.mark.parametrize("rule", ["std", "binary", "newton"])
def test_simple_feasible(rule):
    P, C = Dense(mat=torch.eye(2, dtype=torch.float64)), Dense(mat=torch.tensor([[0.9, 0.9]], dtype=torch.float64))
    res = solve(P, C, MWUOptions(eps=0.1, step_rule=rule, max_iter=20000))
    assert res.status == Status.FEASIBLE and res.max_px <= 1.1 + 1e-6 and res.min_cx >= 1.0


@pytest.mark.parametrize("rule", ["binary", "newton"])
def test_simple_infeasible(rule):
    P, C = Dense(mat=torch.eye(2, dtype=torch.float64)), Dense(mat=torch.tensor([[1.0, 1.0]], dtype=torch.float64) / 3)
    assert solve(P, C, MWUOptions(eps=0.1, step_rule=rule)).status == Status.INFEASIBLE


def test_masked_covering_rows():
    """Masked covering rows must not influence the solve."""
    P = Dense(mat=torch.eye(2, dtype=torch.float64))
    C = Dense(mat=torch.tensor([[0.9, 0.9], [10.0, 10.0]], dtype=torch.float64))
    res = solve(P, C, MWUOptions(eps=0.1, step_rule="newton"), c_mask=torch.tensor([True, False]))
    assert res.status == Status.FEASIBLE


def _random_mixed_lp(rng, mp=8, mc=6, n=12, density=0.5):
    P = rng.random((mp, n)) * (rng.random((mp, n)) < density)
    C = rng.random((mc, n)) * (rng.random((mc, n)) < density)
    P[rng.integers(0, mp), :] += 0.05
    C[:, rng.integers(0, n)] += 0.05
    return P, C


@pytest.mark.parametrize("seed", range(6))
def test_dense_status_matches_reference_and_scipy(seed):
    P, C = _random_mixed_lp(np.random.default_rng(seed))
    (tP, rP), (tC, rC) = _dense(P), _dense(C)
    res = solve(tP, tC, OPTS)
    ref = ref_solve(rP, rC, RefOptions(eps=EPS, step_rule="newton", max_iter=20000))
    assert res.status == int(ref.status)
    feasible = linprog(np.zeros(P.shape[1]), A_ub=np.vstack([P, -C]),
                       b_ub=np.concatenate([np.ones(P.shape[0]), -np.ones(C.shape[0])]), method="highs").success
    if res.status == Status.FEASIBLE:
        x = res.x.numpy()
        assert (P @ x <= 1.1 + 1e-6).all() and (C @ x >= 1.0 - 1e-9).all()
    else:
        assert not feasible or res.status == Status.ITER_LIMIT


def test_traced_matches_untraced_and_x_grows():
    P, C = _random_mixed_lp(np.random.default_rng(3))
    tP, tC = Dense(mat=torch.as_tensor(P)), Dense(mat=torch.as_tensor(C))
    r1 = solve(tP, tC, OPTS)
    r2, trace = solve_traced(tP, tC, OPTS)
    assert (r1.status, r1.iters, r1.ls_probes) == (r2.status, r2.iters, r2.ls_probes)
    assert len(trace["alpha"]) == len(trace["probes"]) == r2.iters
    assert int(trace["probes"].sum()) == r2.ls_probes
    if r1.status == Status.FEASIBLE:
        assert trace["max_violation"][-1] <= 0.1 + 1e-9
    # MWU only ever adds nonnegative multiples of x (multiplicative update)
    assert (r1.x >= init_x(tP, EPS, torch.float64) - 1e-15).all()
