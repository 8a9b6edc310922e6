"""The port's lane-batched feasibility solves, on the CPU.

``Solver.solve_batch`` and ``stack_problems`` against the reference's, at
the reference's own bars (tests/test_api.py:101-145): per-lane status
equal, ``max_px`` within 5e-3, ``iters`` within max(2, iters/20). Against
the port itself the bar is bits: each lane of a batch runs the launches of
a solve of that lane alone, so it equals ``Solver.feasible`` at its bound
in status, iterations, probes, certificates and x. Below the loop, the
step form of the Newton search (its plain version) and the device-step
form of the axpy are held to the forms they replace, bit for bit.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import MWUOptions as RefOptions
from repro.api import Problem as RefProblem
from repro.api import Solver as RefSolver
from repro.api import stack_problems as ref_stack_problems
from repro.core import Dense as RefDense
from repro.graphs import build as ref_build
from repro.graphs import erdos as ref_erdos
from repro.graphs import grid2d as ref_grid2d
from repro_torch import kernels as K
from repro_torch.api import MWUOptions, Problem, Solver, stack_problems
from repro_torch.core import Dense, mwu
from repro_torch.core import stepsize as T
from repro_torch.kernels.linesearch_probe import ops as probe_ops
from repro_torch.graphs import bipartite_ratings, build, erdos, generalized_matching_problem, grid2d, rgg
from test_torch_solver import port_problem
from test_torch_stepsize import CASES, LS_EPS, _state

EPS = 0.1
OPTS = MWUOptions(eps=EPS, step_rule="newton", max_iter=20000)
REF_OPTS = RefOptions(eps=EPS, step_rule="newton", max_iter=20000)


def _bits(x: float) -> bytes:
    return struct.pack("d", x)


# ------------------------------------------------ against the reference --
def _ref_case(case):
    """(reference problem, port problem, bounds, batched_problem)."""
    if case == "stacked-erdos":
        refs = [ref_build("match", ref_erdos(60, 150, seed=s)) for s in (0, 1)]
        bounds = np.asarray([np.sqrt(float(p.lo) * float(p.hi)) for p in refs])
        return ref_stack_problems(refs), stack_problems([port_problem(p) for p in refs]), bounds, True
    family, K = {"match-grid6": ("match", 3), "vcover-grid6": ("vcover", 4)}[case]
    ref = ref_build(family, ref_grid2d(6))
    return ref, port_problem(ref), np.geomspace(float(ref.lo), float(ref.hi), K), False


@pytest.mark.parametrize("case", ["match-grid6", "vcover-grid6", "stacked-erdos"])
def test_solve_batch_matches_reference(case):
    """match at 3 geometric bounds, the vcover fan-out at 4, and two
    stacked erdos(60, 150) instances: the reference's bars per lane."""
    ref_prob, prob, bounds, stacked = _ref_case(case)
    ref = RefSolver(REF_OPTS).solve_batch(ref_prob, jnp.asarray(bounds), batched_problem=stacked)
    got = Solver(OPTS).solve_batch(prob, bounds, batched_problem=stacked)
    K = len(bounds)
    assert got.x.shape == (K, prob.n_vars)
    assert got.status.shape == got.iters.shape == got.ls_probes.shape == got.max_px.shape == (K,)
    for j in range(K):
        assert int(got.status[j]) == int(np.asarray(ref.status)[j]), j
        assert abs(float(got.max_px[j]) - float(np.asarray(ref.max_px)[j])) <= 5e-3, j
        ref_iters = int(np.asarray(ref.iters)[j])
        assert abs(int(got.iters[j]) - ref_iters) <= max(2, ref_iters // 20), (j, int(got.iters[j]), ref_iters)


def test_speculative_search_uses_fanout():
    """batch_width 4 evaluates its bounds as the lanes of one batch and
    lands within the band of the sequential search."""
    prob = build("vcover", grid2d(6), device="cpu")
    seq = Solver(OPTS, batch_width=1).solve(prob)
    fan = Solver(OPTS, batch_width=4).solve(prob)
    assert fan.found and seq.found
    assert abs(fan.objective - seq.objective) <= 3.0 * EPS * seq.objective
    assert fan.feasibility_calls >= 2


# ------------------------------------------ each lane equals its own solve --
def _family(family):
    if family in ("bmatch", "gen-match"):
        g = bipartite_ratings(60, 40, avg_ratings=6.0, seed=1)
        if family == "bmatch":
            return build("bmatch", g, device="cpu")
        s, deg = g.bipartite_split, g.degrees()
        lb, ub = np.zeros(g.n), np.ones(g.n)
        lb[:s] = np.minimum(1, deg[:s])
        ub[:s], ub[s:] = 5, 8
        return generalized_matching_problem(g, lb, ub, device="cpu")
    return build(family, rgg(8, seed=0), device="cpu")


def _assert_lane_equals(batch, j, res):
    assert int(batch.status[j]) == res.status
    assert int(batch.iters[j]) == res.iters and int(batch.ls_probes[j]) == res.ls_probes
    assert _bits(float(batch.max_px[j])) == _bits(res.max_px) and _bits(float(batch.min_cx[j])) == _bits(res.min_cx)
    assert torch.equal(batch.x[j], res.x)


@pytest.mark.parametrize("family", ["match", "bmatch", "vcover", "dom-set", "dense-sub", "gen-match"])
def test_lanes_equal_feasible(family):
    """Every lane of a 4-bound batch equals feasible() at its bound, bit for
    bit (gen-match has no bound: its four lanes are one problem)."""
    prob = _family(family)
    bounds = np.geomspace(prob.lo, prob.hi, 4) if prob.bound_mode != "none" else np.ones(4)
    solver = Solver(MWUOptions(eps=EPS, step_rule="newton"))
    batch = solver.solve_batch(prob, bounds)
    for j, b in enumerate(bounds):
        _assert_lane_equals(batch, j, solver.feasible(prob, float(b)))


def test_stacked_lanes_equal_feasible():
    """Instance lanes run over their own operators: each equals feasible()
    of its own problem, bit for bit."""
    probs = [build("match", erdos(60, 150, seed=s), device="cpu") for s in (0, 1, 2)]
    bounds = [np.sqrt(p.lo * p.hi) for p in probs]
    solver = Solver(OPTS)
    batch = solver.solve_batch(stack_problems(probs), bounds, batched_problem=True)
    for j, (p, b) in enumerate(zip(probs, bounds)):
        _assert_lane_equals(batch, j, solver.feasible(p, float(b)))
    with pytest.raises(ValueError, match="3 stacked problems"):
        solver.solve_batch(stack_problems(probs), bounds[:2], batched_problem=True)


def test_finished_lane_keeps_its_bits(monkeypatch):
    """A lane that ends first (an infeasible bound, a few iterations) runs no
    iteration after its end, keeps its bits while the other runs on, and
    equals its own solve; the loop's iterations are the longest lane's."""
    prob = build("match", grid2d(6), device="cpu")
    bounds = [prob.hi, prob.lo]  # infeasible (ends early), feasible (runs long)
    runs = []
    iteration = mwu._iteration
    monkeypatch.setattr(mwu, "_iteration", lambda ln, *a: runs.append(ln.k) or iteration(ln, *a))
    solver = Solver(OPTS)
    batch = solver.solve_batch(prob, bounds)
    assert int(batch.iters[0]) < int(batch.iters[1])
    assert runs.count(0) == int(batch.iters[0]) and runs.count(1) == int(batch.iters[1])
    last = max(i for i, k in enumerate(runs) if k == 0)
    assert all(k == 1 for k in runs[last + 1:])  # lane 0 launched nothing after its end
    monkeypatch.setattr(mwu, "_iteration", iteration)
    for j, b in enumerate(bounds):
        _assert_lane_equals(batch, j, solver.feasible(prob, float(b)))


def test_probe_rounds_go_through_solve_batch(monkeypatch):
    """Solver._probe sends a round of more than one bound through
    solve_batch, unless tracing; a round of one bound is a single solve."""
    calls = []
    batch = Solver.solve_batch
    monkeypatch.setattr(Solver, "solve_batch", lambda self, p, b, **kw: calls.append(len(b)) or batch(self, p, b, **kw))
    prob = build("vcover", grid2d(5), device="cpu")
    sol = Solver(OPTS, batch_width=4).solve(prob)
    assert calls and all(k == 4 for k in calls)
    assert sol.feasibility_calls == 1 + 4 * len(calls)  # vcover checks hi alone first
    calls.clear()
    Solver(OPTS, batch_width=4).solve(prob, trace=True)
    assert calls == []


@pytest.mark.parametrize("rule", ["binary", "std"])
def test_host_rule_lanes_equal_feasible(rule):
    """Lanes of the binary and standard rules (their step decided on the
    device, as the Newton lanes' is) equal their own solves too."""
    prob = build("match", grid2d(5), device="cpu")
    solver = Solver(MWUOptions(eps=EPS, step_rule=rule, max_iter=3000))
    bounds = np.geomspace(prob.lo, prob.hi, 3)
    batch = solver.solve_batch(prob, bounds)
    for j, b in enumerate(bounds):
        _assert_lane_equals(batch, j, solver.feasible(prob, float(b)))


@pytest.mark.parametrize("rule", ["binary", "std"])
def test_rule_lanes_read_once_a_loop_iteration(rule, monkeypatch):
    """A binary and a standard solve of three lanes call the rule's record
    function once a lane iteration and read the host once a loop iteration
    for all lanes (the record), plus once to start and once to finish. The
    binary search's plain version, which stands for one launch, is not
    counted."""
    prob = build("match", grid2d(5), device="cpu")
    lanes = [prob.instantiate(b) for b in np.geomspace(prob.lo, prob.hi, 3)]
    fn = {"binary": "binary_step_record", "std": "standard_step_record"}[rule]
    calls, reads = [], []
    record = getattr(mwu, fn)
    monkeypatch.setattr(mwu, fn, lambda *a, **k: calls.append(fn) or record(*a, **k))
    for method_name in ("item", "tolist"):
        method = getattr(torch.Tensor, method_name)
        monkeypatch.setattr(torch.Tensor, method_name, lambda t, _m=method, _n=method_name: reads.append(_n) or _m(t))
    plain = probe_ops.binary_step_ref

    def uncounted(*a, **k):
        n = len(reads)
        out = plain(*a, **k)
        del reads[n:]
        return out

    monkeypatch.setattr(probe_ops, "binary_step_ref", uncounted)
    res = mwu.solve_lanes(lanes, MWUOptions(eps=EPS, step_rule=rule, max_iter=3000))
    monkeypatch.undo()
    assert calls == [fn] * int(res.iters.sum()) and int(res.iters.min()) > 0
    assert len(reads) == int(res.iters.max()) + 2 and set(reads) == {"tolist"}
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}


# ------------------------------------------------------- stack_problems --
def _dense_problem(cls, dense, rows, array):
    return cls(name="x", kind="packing", sense="max", bound_mode="objective_covering",
               P=dense(mat=array(np.ones((rows, 4)))), c=array(np.ones(4)), n_vars=4, nnz=12)


def _mismatch(case):
    """(reference problems, port problems) that stack_problems refuses."""
    if case == "family":
        refs = [ref_build(f, ref_erdos(60, 150, seed=0)) for f in ("match", "vcover")]
    elif case == "n_vars":
        refs = [ref_build("match", ref_erdos(60, m, seed=0)) for m in (150, 151)]
    else:  # leaf shape: one static structure, two shapes of P's matrix
        refs = [_dense_problem(RefProblem, RefDense, r, jnp.asarray) for r in (3, 5)]
        return refs, [_dense_problem(Problem, Dense, r, torch.from_numpy) for r in (3, 5)]
    return refs, [port_problem(p) for p in refs]


@pytest.mark.parametrize("case", ["family", "n_vars", "leaf"])
def test_stack_problems_refuses_as_reference(case):
    """The reference's ValueError, with its message up to its pointer to the
    reference's padding helper."""
    refs, probs = _mismatch(case)
    with pytest.raises(ValueError) as ref_err:
        ref_stack_problems(refs)
    with pytest.raises(ValueError) as err:
        stack_problems(probs)
    assert str(err.value).split("; pad")[0] == str(ref_err.value).split("; pad")[0]
    assert ("static field" if case != "leaf" else "leaf '.P.mat'") in str(err.value)


def test_stack_problems_stacks_every_leaf():
    probs = [build("match", erdos(60, 150, seed=s), device="cpu") for s in (0, 1)]
    st = stack_problems(probs)
    assert st.P.u.shape == (2, 150) and st.c.shape == (2, 150) and st.P.n_vertices == 60
    assert list(st.lo) == [p.lo for p in probs] and st.graph is None
    with pytest.raises(ValueError):
        stack_problems([])


# ---------------------------------------- the step form of the search --
def _record(y, z, dy, dz, d_max, alpha_prev):
    ap = torch.tensor([alpha_prev], dtype=torch.float64)
    rec = T.newton_step_record(y, z, dy, dz, 50.0, LS_EPS, torch.tensor(d_max, dtype=y.dtype), ap)
    return rec.tolist(), float(ap)


@pytest.mark.parametrize("alpha_prev", [1.0, 37.0])
@pytest.mark.parametrize("d_max", [1e-3, 0.0], ids=["dmax>0", "dmax=0"])
@pytest.mark.parametrize("dy_scale", [1.0, 30.0], ids=["feasible", "alpha<1"])
def test_newton_step_record_equals_host_loop(dy_scale, d_max, alpha_prev):
    """The record of the search's plain step form against _newton_step_host
    on the seeded states of test_torch_stepsize.py (off the bisection tie):
    alpha bit for bit, probes and completes; step = alpha unless max(d) <= 0
    or alpha < 1, then 0 and bad; alpha_prev updated only when the step is
    taken. dy x 30 makes f(1) < 1, so the search backs off below 1."""
    below = 0
    for seed, kind in CASES:
        y, z, dy, dz = (torch.from_numpy(t) for t in _state(seed, kind))
        dy = dy * dy_scale
        host = T._newton_step_host(y, z, dy, dz, 50.0, ls_eps=LS_EPS, alpha0=alpha_prev)
        (alpha, probes, completes, step, bad), ap = _record(y, z, dy, dz, d_max, alpha_prev)
        assert (_bits(alpha), int(probes), bool(completes)) == (_bits(host.alpha), host.probes, host.completes)
        want_bad = d_max <= 0 or host.alpha < 1
        assert bool(bad) == want_bad and _bits(step) == _bits(0.0 if want_bad else host.alpha)
        assert _bits(ap) == _bits(alpha_prev if want_bad else host.alpha)
        below += host.alpha < 1
    assert (below == len(CASES)) == (dy_scale > 1) and (below == 0) == (dy_scale == 1)


def test_newton_search_step_form_on_cpu():
    y, z, dy, dz = (torch.from_numpy(t) for t in _state(0))
    out = torch.empty(5, dtype=torch.float64)
    rec = K.newton_search(y, dy, z, dz, 50.0, LS_EPS, torch.ones(1, dtype=torch.float64),
                          d_max=torch.tensor(1.0, dtype=torch.float64), out=out)
    assert rec is out and K.launch_counts()["newton_search"] == 0
    host = K.newton_search(y, dy, z, dz, 50.0, LS_EPS, 1.0)
    assert out[:3].tolist() == host.tolist()


# --------------------------------------------------- the device-step axpy --
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("alpha", [3.25, 1.0 / 3.0, 0.0])
def test_axpy_device_step_equals_host_float(dtype, alpha):
    """alpha as a one-value float64 tensor gives the host float's bits, in
    place too, and writes [min, max] (float64) into the caller's slot."""
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.standard_normal(1030)).to(dtype)
    dy = torch.from_numpy(rng.random(1030)).to(dtype)
    out, mn, mx = K.axpy_reduce(y, dy, alpha)
    red = torch.zeros(4, dtype=torch.float64)
    inplace = y.clone()
    got, gmn, gmx = K.axpy_reduce(inplace, dy, torch.tensor([alpha], dtype=torch.float64), out=inplace,
                                  red=red[1:3])
    assert got is inplace and torch.equal(got, out) and got.dtype == dtype
    assert mn.dtype == torch.float64 and red.tolist() == [0.0, float(mn), float(mx), 0.0]
    assert _bits(float(gmn)) == _bits(float(out.min())) and _bits(float(gmx)) == _bits(float(out.max()))
