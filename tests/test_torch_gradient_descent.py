"""The port's MPCSolver baseline against the reference's, at f64.

``benchmarks/bench_convergence.py::build_instance``'s generalized matching
(users lb = min(3, deg), ub = 5; items ub = 200), cut to 300 users and 140
items, goes through ``repro.core.mpc_solve`` (x64) and
``repro_torch.core.mpc_solve`` (``device="cpu"``), with its covering mask
and without one. The bars: the same iteration count, the violation trace
within rel 1e-9, and x within rel 1e-9.
"""
import jax
import numpy as np
import pytest

from repro.core import MPCOptions as RefMPCOptions
from repro.core import mpc_solve as ref_mpc_solve
from repro.graphs import bipartite_ratings as ref_bipartite_ratings
from repro.graphs import generalized_matching_lp as ref_generalized_matching_lp
from repro_torch.core import MPCOptions, mpc_solve
from repro_torch.graphs import Graph, generalized_matching_lp

jax.config.update("jax_enable_x64", True)

RTOL = 1e-9


def _bounds(g):
    deg, s = g.degrees(), g.bipartite_split
    lb, ub = np.zeros(g.n), np.ones(g.n)
    lb[:s] = np.minimum(3, deg[:s])
    ub[:s] = 5
    ub[s:] = 200
    return lb, ub


@pytest.mark.parametrize("masked", [True, False], ids=["c_mask", "no_mask"])
def test_mpc_solve_matches_reference(masked):
    g = ref_bipartite_ratings(300, 140, avg_ratings=18.0, seed=0)
    lb, ub = _bounds(g)
    rP, rC, rmask = ref_generalized_matching_lp(g, lb, ub)
    pg = Graph(n=g.n, u=g.u, v=g.v, name=g.name, bipartite_split=g.bipartite_split)
    P, C, mask = generalized_matching_lp(pg, lb, ub, device="cpu")
    opts = dict(eps=0.05, max_iter=3000)
    rx, rtr = ref_mpc_solve(rP, rC, RefMPCOptions(**opts), c_mask=rmask if masked else None)
    x, tr = mpc_solve(P, C, MPCOptions(**opts), c_mask=mask if masked else None)
    assert tr["iters"] == rtr["iters"] and len(tr["max_violation"]) == tr["iters"]
    np.testing.assert_allclose(tr["max_violation"], rtr["max_violation"], rtol=RTOL, atol=0)
    np.testing.assert_allclose(x, np.asarray(rx), rtol=RTOL, atol=0)
    assert x.dtype == np.float64 and x.shape == (g.m,)
    assert 1 < tr["iters"] < 3000 and tr["max_violation"][-1] <= 0.05  # reached eps before the cap


def test_mpc_solve_stops_at_eps_or_cap():
    """The loop ends at the first violation <= eps, or at the cap."""
    g = ref_bipartite_ratings(300, 140, avg_ratings=18.0, seed=0)
    lb, ub = _bounds(g)
    pg = Graph(n=g.n, u=g.u, v=g.v, name=g.name, bipartite_split=g.bipartite_split)
    P, C, mask = generalized_matching_lp(pg, lb, ub, device="cpu")
    _, tr = mpc_solve(P, C, MPCOptions(eps=0.05, max_iter=7), c_mask=mask)
    assert tr["iters"] == 7 and (tr["max_violation"][:-1] > 0.05).all()
    _, tr = mpc_solve(P, C, MPCOptions(eps=10.0), c_mask=mask)
    assert tr["iters"] == 1 and tr["max_violation"][0] <= 10.0
