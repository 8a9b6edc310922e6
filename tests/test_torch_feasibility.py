"""The port's deprecated binary-search shims and its warn_once.

Each shim of ``repro_torch.core.feasibility`` must give what
``Solver(opts, batch_width=1).solve`` gives on the same ``Problem``, bit
for bit (the shim builds that Problem and delegates), and come within the
solver bars of the reference's shim on the same LP: the bound within rel
1e-5, the objective within rel 2*eps (tests/test_torch_solver.py). The
port's ``warn_once`` passes the cases of tests/test_deprecation.py, and the
package resolves the shims lazily, warning once.
"""
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ScaledRows as RefScaledRows
from repro.core.feasibility import densest_subgraph_search as ref_densest
from repro.core.feasibility import maximize_packing as ref_maximize
from repro.core.feasibility import minimize_covering as ref_minimize
from repro.graphs import build as ref_build
from repro.graphs import grid2d as ref_grid2d
from repro.api import MWUOptions as RefOptions
from repro_torch import core
from repro_torch.api import MWUOptions, Problem, Solver
from repro_torch.core import OnesRow, ScaledRows
from repro_torch.core.feasibility import BinarySearchResult, densest_subgraph_search, maximize_packing, \
    minimize_covering
from repro_torch.utils import deprecation
from repro_torch.utils.deprecation import warn_once
from test_torch_solver import port_problem

EPS = 0.1
OPTS = MWUOptions(eps=EPS, step_rule="newton")
REF_OPTS = RefOptions(eps=EPS, step_rule="newton")


def _make_pc(P, C, n, scaled, array):
    def make_pc(D):
        return scaled(scale=array(np.full(n, 1.0 / D)), inner=P), C

    return make_pc


def _shim_calls(family):
    """(reference result, port shim result, port Problem the shim stands for)."""
    ref = ref_build(family, ref_grid2d(5))
    prob = port_problem(ref)
    lo, hi = float(ref.lo), float(ref.hi)
    if family == "match":
        want = Problem(name="packing", kind="packing", sense="max", bound_mode="objective_covering", P=prob.P,
                       c=prob.c, lo=lo, hi=hi, n_vars=prob.P.shape[1], nnz=prob.P.nnz, device="cpu")
        return (ref_maximize(ref.P, ref.c, lo, hi, REF_OPTS), maximize_packing(prob.P, prob.c, lo, hi, OPTS), want)
    if family == "vcover":
        want = Problem(name="covering", kind="covering", sense="min", bound_mode="objective_packing", C=prob.C,
                       c=prob.c, lo=lo, hi=hi, n_vars=prob.C.shape[1], nnz=prob.C.nnz, device="cpu")
        return (ref_minimize(ref.C, ref.c, lo, hi, REF_OPTS),
                minimize_covering(prob.C, prob.c.numpy(), lo, hi, OPTS), want)
    n = prob.P.shape[0]
    make_pc = _make_pc(prob.P, prob.C, n, ScaledRows, lambda a: torch.from_numpy(a))
    want = Problem(name="densest", kind="densest", sense="min", bound_mode="callable", make_ops=make_pc, lo=lo,
                   hi=hi, device="cpu")
    return (ref_densest(_make_pc(ref.P, ref.C, n, RefScaledRows, jnp.asarray), lo, hi, REF_OPTS),
            densest_subgraph_search(make_pc, lo, hi, OPTS), want)


@pytest.mark.parametrize("family", ["match", "vcover", "dense-sub"])
def test_shim_equals_sequential_solver_and_reference(family):
    ref, got, prob = _shim_calls(family)
    sol = Solver(OPTS, batch_width=1).solve(prob)
    assert isinstance(got, BinarySearchResult) and got.found and ref.found
    assert (got.feasibility_calls, got.mwu_iters_total, got.ls_probes_total) == \
        (sol.feasibility_calls, sol.mwu_iters_total, sol.ls_probes_total)
    assert got.bound == sol.bound and got.objective == sol.objective and np.array_equal(got.x, sol.x)
    assert got.bound == pytest.approx(ref.bound, rel=1e-5)
    assert got.objective == pytest.approx(float(ref.objective), rel=2 * EPS)


def test_shim_not_found_as_reference():
    """max <c,x> : x <= 1 (one variable) cannot reach an objective of 10."""
    P = OnesRow(c=torch.ones(1, dtype=torch.float64), inv_bound=torch.tensor(1.0, dtype=torch.float64))
    res = maximize_packing(P, torch.ones(1, dtype=torch.float64), 10.0, 20.0, OPTS)
    assert not res.found and res.objective == 0.0


def test_core_resolves_shims_lazily(monkeypatch):
    """repro_torch.core's shim names warn once, on first use."""
    monkeypatch.setattr(deprecation, "_WARNED", set())
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert core.maximize_packing is maximize_packing
        assert core.densest_subgraph_search is densest_subgraph_search
        assert core.BinarySearchResult is BinarySearchResult
        assert core.mpc_solve is not None and core.solve is not None  # plain exports: no warning
    assert [r.category for r in rec] == [DeprecationWarning]
    assert "repro_torch.core.feasibility" in str(rec[0].message)
    with pytest.raises(AttributeError):
        core.no_such_name


# -- warn_once: the cases of tests/test_deprecation.py ------------------------
def test_warns_once_per_key(monkeypatch):
    monkeypatch.setattr(deprecation, "_WARNED", set())
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        warn_once("k1", "shim k1 is deprecated")
        warn_once("k1", "shim k1 is deprecated")
        warn_once("k1", "different text, same key")
    assert len(rec) == 1
    assert issubclass(rec[0].category, DeprecationWarning)
    assert "k1" in str(rec[0].message)


def test_distinct_keys_each_warn(monkeypatch):
    monkeypatch.setattr(deprecation, "_WARNED", set())
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        warn_once("a", "A")
        warn_once("b", "B")
        warn_once("a", "A again")
    assert [str(r.message) for r in rec] == ["A", "B"]


def test_thread_safe_reentry(monkeypatch):
    """16 threads racing on one fresh key produce exactly one warning."""
    monkeypatch.setattr(deprecation, "_WARNED", set())
    n = 16
    barrier = threading.Barrier(n)

    def hit():
        barrier.wait()
        warn_once("raced", "raced shim")

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        threads = [threading.Thread(target=hit) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(rec) == 1
    assert "raced" in str(rec[0].message)
