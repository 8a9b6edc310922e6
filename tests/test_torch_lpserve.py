"""The port's lpserve vs the reference's ``repro.lpserve``, on the CPU.

The reference's own graphs and seeds (tests/test_lpserve.py) go through
both packages: a reference ``Problem`` is rebuilt in the port with
``problem_from_numpy`` (tests/test_torch_solver.py's ``port_problem``), so
both pad, solve and serve the very same LP. The bars:

- bucket policy, problem dims and padding: equal (every padded operator
  array and both masks exactly, as numpy);
- padded solves: the solver bars of ROADMAP.md (same status, bound within
  rel 1e-5, objective within rel 2*eps);
- the incremental bound search against the port's own sequential solver:
  the same calls, objective within rel 1e-12 (tests/test_lpserve.py:212);
- the engine against the reference's engine: the same found and feasible
  per request, objectives within rel 2*eps, the same stats keys; and each
  lane of an engine round equal to ``feasible()`` of its padded request at
  its bound, bit for bit;
- the engine on a (2, 2) ``MeshPlan`` over four gloo ranks against the
  reference's sequential engine (tests/test_dist_solver.py's mesh case).
"""
import dataclasses
import struct

import jax
import numpy as np
import pytest
import torch

from repro.api import MWUOptions as RefOptions
from repro.api import Solver as RefSolver
from repro.core import operators as R
from repro.graphs import Graph as RefGraph
from repro.graphs import build as ref_build
from repro.graphs import erdos as ref_erdos
from repro.graphs.problems import generalized_matching_problem as ref_gen_match
from repro.lpserve import BucketPolicy as RefPolicy
from repro.lpserve import BucketSpec as RefSpec
from repro.lpserve import LPEngine as RefEngine
from repro.lpserve import LPServeConfig as RefConfig
from repro.lpserve import pad_problem as ref_pad
from repro.dist import MeshPlan as RefMeshPlan
from repro.lpserve import problem_dims as ref_dims
from repro_torch.api import MWUOptions, Solver, stack_problems
from repro_torch.dist import MeshPlan
from repro_torch.graphs import build, erdos
from repro_torch.lpserve import (BoundSearch, BucketPolicy, BucketSpec, LPEngine, LPServeConfig, pad_problem,
                                 pad_problems, padding_waste, problem_dims)
from repro_torch.lpserve.__main__ import main as serve_main
from test_torch_ranks import run_ranks
from test_torch_solver import port_problem

EPS = 0.1
OPTS = MWUOptions(eps=EPS, step_rule="newton", max_iter=20000)
REF_OPTS = RefOptions(eps=EPS, step_rule="newton", max_iter=20000)
SIZE_TIERS = [(40, 100), (60, 160), (80, 220)]  # tests/test_lpserve.py's tiers
FAMILIES = ["match", "vcover", "dom-set", "dense-sub"]


def _bits(x: float) -> bytes:
    return struct.pack("d", x)


def _star_gen_match():
    """tests/test_lpserve.py's feasibility-only request (the VStack + box-Coo rules)."""
    g = RefGraph.from_edges(6, np.array([[0, i] for i in range(1, 6)]), "star6")
    lb = np.zeros(6)
    lb[0] = 2.0
    return ref_gen_match(g, lb, np.full(6, 3.0))


def _pair(ref):
    """(reference problem, the same LP in the port, its source graph kept)."""
    return ref, dataclasses.replace(port_problem(ref), graph=ref.graph)


# --------------------------------------------------------------- policy --
POLICIES = [dict(), dict(vertex_floor=8, edge_floor=8), dict(vertex_floor=48, edge_floor=100, growth=1.5),
            dict(vertex_floor=3, edge_floor=7, growth=3.0), dict(vertex_sizes=(100, 200, 5000), edge_sizes=(500, 90000))]


@pytest.mark.parametrize("kw", POLICIES, ids=["default", "floor8", "growth1.5", "growth3", "explicit"])
def test_bucket_for_matches_reference(kw):
    """bucket_for on a grid of dims, rung edges included: the same bucket,
    or the same ValueError past an explicit ladder."""
    ref, got = RefPolicy(**kw), BucketPolicy(**kw)
    dims = sorted({d + o for d in (1, 3, 7, 8, 9, 48, 63, 64, 65, 100, 101, 255, 256, 257, 1000, 4096, 65537, 10**6)
                   for o in (-1, 0, 1) if d + o > 0})
    for n in dims:
        for m in dims[::3]:
            try:
                want = ref.bucket_for(n, m)
            except ValueError as e:
                with pytest.raises(ValueError) as err:
                    got.bucket_for(n, m)
                assert str(err.value) == str(e)
                continue
            b = got.bucket_for(n, m)
            assert (b.n_vertices, b.n_edges) == (want.n_vertices, want.n_edges) and str(b) == str(want), (n, m)


@pytest.mark.parametrize("kw", [dict(growth=1.0), dict(growth=0.5), dict(vertex_sizes=(200, 100)),
                                dict(edge_sizes=(5, 3, 9))], ids=["growth1", "growth0.5", "vertex-order", "edge-order"])
def test_bucket_policy_validation_matches_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        RefPolicy(**kw)
    with pytest.raises(ValueError) as err:
        BucketPolicy(**kw)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("family", FAMILIES)
def test_problem_dims_matches_reference(family):
    ref, prob = _pair(ref_build(family, ref_erdos(40, 100, seed=0)))
    assert problem_dims(prob) == ref_dims(ref) == (40, 100)
    # inferred from the operators once the graph handle is gone
    assert problem_dims(dataclasses.replace(prob, graph=None)) == (40, 100)


# -------------------------------------------------------------- padding --
def _same(ref, got, path="problem"):
    """Every array of a reference operator tree equal to the port's (numpy, exact)."""
    if isinstance(ref, R.LinOp):
        assert type(got).__name__ == type(ref).__name__, path
        for f in dataclasses.fields(ref):
            _same(getattr(ref, f.name), getattr(got, f.name), f"{path}.{f.name}")
    elif isinstance(ref, tuple) and ref and isinstance(ref[0], R.LinOp):
        assert len(got) == len(ref), path
        for i, (r, g) in enumerate(zip(ref, got)):
            _same(r, g, f"{path}[{i}]")
    elif ref is None:
        assert got is None, path
    elif isinstance(ref, (jax.Array, np.ndarray)):
        want, have = np.asarray(ref), got.cpu().numpy()
        assert have.dtype.kind == want.dtype.kind and have.shape == want.shape, (path, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=path)
    else:
        assert got == ref, (path, got, ref)


PAD_CASES = [(f, (40, 100, 3), RefSpec(64, 256)) for f in FAMILIES] + [
    ("match", (50, 120, 1), RefSpec(128, 1024)), ("gen-match", None, RefSpec(16, 16))]


@pytest.mark.parametrize("family,graph,bucket", PAD_CASES, ids=[f"{f}-{b}" for f, _, b in PAD_CASES])
def test_pad_problem_matches_reference(family, graph, bucket):
    """Every padded operator array, both masks, the objective and the
    static fields equal the reference's padded problem."""
    ref, prob = _pair(_star_gen_match() if family == "gen-match" else ref_build(family, ref_erdos(*graph)))
    want = ref_pad(ref, bucket)
    got = pad_problem(prob, BucketSpec(bucket.n_vertices, bucket.n_edges))
    for f in ("P", "C", "c", "p_mask", "c_mask"):
        _same(getattr(want, f), getattr(got, f), f)
    for f in ("name", "kind", "sense", "bound_mode", "lo", "hi", "n_vars", "nnz"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.device, got.dtype) == (prob.device, prob.dtype)
    assert problem_dims(got) == problem_dims(prob)  # the graph handle reports the request
    assert padding_waste(prob, got_bucket := BucketSpec(bucket.n_vertices, bucket.n_edges)) == \
        1.0 - problem_dims(prob)[1] / got_bucket.n_edges


def test_pad_problem_refusals_match_reference():
    ref, prob = _pair(ref_build("match", ref_erdos(40, 100, seed=0)))
    for r, p in ((ref, prob), (dataclasses.replace(ref, bound_mode="callable", make_ops=lambda b: None),
                               dataclasses.replace(prob, bound_mode="callable", make_ops=lambda b: None))):
        bucket = (64, 64) if r is ref else (64, 256)
        with pytest.raises(ValueError) as ref_err:
            ref_pad(r, RefSpec(*bucket))
        with pytest.raises(ValueError) as err:
            pad_problem(p, BucketSpec(*bucket))
        assert str(err.value) == str(ref_err.value)


def test_pad_problems_share_a_bucket_and_stack():
    probs = [build("match", erdos(*SIZE_TIERS[i], seed=i), device="cpu") for i in range(3)]
    padded, bucket = pad_problems(probs)
    assert bucket == BucketSpec(128, 256)
    stacked = stack_problems(padded)  # raises without padding
    assert stacked.P.u.shape == (3, 256) and stacked.p_mask.shape == (3, 128)
    with pytest.raises(ValueError, match="at least one"):
        pad_problems([])


@pytest.mark.parametrize("family", FAMILIES)
def test_padded_solve_matches_reference(family):
    """The port's padded solve against the reference's padded solve at the
    solver bars, and padding parity in the port: its padded and unpadded
    solves agree within eps and padded coordinates stay at their start."""
    ref, prob = _pair(ref_build(family, ref_erdos(40, 100, seed=3)))
    want = RefSolver(REF_OPTS, batch_width=1).solve(ref_pad(ref, RefSpec(64, 256)))
    solver = Solver(OPTS, batch_width=1)
    got = solver.solve(pad_problem(prob, BucketSpec(64, 256)))
    assert got.status == int(want.status) and got.found == want.found
    assert got.bound == pytest.approx(want.bound, rel=1e-5)
    assert got.objective == pytest.approx(float(want.objective), rel=2 * EPS)
    plain = solver.solve(prob)
    value = (lambda s: s.bound) if family == "dense-sub" else (lambda s: s.objective)
    assert abs(value(got) - value(plain)) <= EPS * max(abs(value(plain)), 1.0)
    assert np.ptp(got.x[prob.n_vars:]) == 0.0


def test_padded_feasibility_only_matches_reference():
    ref, prob = _pair(_star_gen_match())
    want = RefSolver(REF_OPTS).solve(ref_pad(ref, RefSpec(16, 16)))
    got = Solver(OPTS).solve(pad_problem(prob, BucketSpec(16, 16)))
    assert got.feasible and got.status == int(want.status) and np.isnan(got.objective)
    assert np.ptp(got.x[prob.n_vars:]) == 0.0


def test_padded_feasibility_status_per_bound():
    """Per-probe parity: the padded LP answers every bound the unpadded way."""
    prob = build("match", erdos(50, 120, seed=1), device="cpu")
    padded = pad_problem(prob, BucketSpec(64, 256))
    solver = Solver(OPTS)
    for b in np.geomspace(prob.lo, prob.hi, 3):
        assert solver.feasible(prob, float(b)).status == solver.feasible(padded, float(b)).status


# --------------------------------------------------------- bound search --
@pytest.mark.parametrize("family", ["match", "vcover"])
def test_bound_search_replays_sequential_solver(family):
    """Driven by the port's feasibility oracle, the incremental search gives
    Solver.solve at batch_width 1: the same calls, the same objective."""
    prob = build(family, erdos(50, 120, seed=2), device="cpu")
    seq = Solver(OPTS, batch_width=1)
    ref = seq.solve(prob)
    bs = BoundSearch(prob, rel_tol=OPTS.eps / 2, max_calls=64)
    while not bs.done:
        b = bs.next_bound()
        bs.update(b, seq.feasible(prob, b))
    assert bs.solution.found == ref.found
    assert bs.solution.feasibility_calls == ref.feasibility_calls
    assert bs.solution.objective == pytest.approx(ref.objective, rel=1e-12)


def test_bound_search_not_found():
    prob = build("match", erdos(40, 100, seed=0), device="cpu")
    bad = dataclasses.replace(prob, lo=40.0, hi=80.0)  # a matching on 40 vertices never reaches 40
    seq = Solver(OPTS, batch_width=1)
    bs = BoundSearch(bad, rel_tol=OPTS.eps / 2, max_calls=64)
    while not bs.done:
        b = bs.next_bound()
        bs.update(b, seq.feasible(bad, b))
    assert not bs.solution.found and bs.solution.objective == 0.0


# --------------------------------------------------------------- engine --
def _mixed(count):
    """Reference and port problems: match and vcover alternating over the tiers."""
    refs = [ref_build(("match", "vcover")[i % 2], ref_erdos(*SIZE_TIERS[i % 3], seed=i)) for i in range(count)]
    return refs, [_pair(r)[1] for r in refs]


def test_engine_matches_reference_engine():
    """Mixed sizes and families through both engines: the same found and
    feasible per request, objectives within rel 2*eps of the reference's
    and within 3*eps of the port's sequential solve, x unpadded, the same
    stats keys and buckets, and batching that batches."""
    refs, probs = _mixed(6)
    want = RefEngine(RefConfig(opts=REF_OPTS, lanes=4))
    want_sols = want.solve_many(refs)
    engine = LPEngine(LPServeConfig(opts=OPTS, lanes=4))
    sols = engine.solve_many(probs)
    seq = Solver(OPTS, batch_width=1)
    for i, (p, sol, ref) in enumerate(zip(probs, sols, want_sols)):
        assert (sol.found, sol.feasible) == (ref.found, bool(ref.feasible)) == (True, True), i
        assert sol.objective == pytest.approx(float(ref.objective), rel=2 * EPS), i
        assert abs(sol.objective - seq.solve(p).objective) <= 3 * EPS * max(sol.objective, 1.0), i
        assert sol.x.shape == (p.n_vars,)
    st, ref_st = engine.stats(), want.stats()
    assert set(st) == set(ref_st) and set(st["buckets"]) == set(ref_st["buckets"])
    for key, b in st["buckets"].items():
        assert set(b) == set(ref_st["buckets"][key]) and b["requests"] == ref_st["buckets"][key]["requests"]
        assert b["completed"] == b["requests"] and 0.0 <= b["padding_waste"] < 1.0
    assert st["requests"] == st["completed"] == len(probs) and st["not_found"] == 0
    assert st["batches"] < st["feasibility_calls"]
    assert 0.0 < st["lane_occupancy"] <= 1.0
    assert st["compiles"] == len(st["buckets"]) and st["compile_cache_hits"] == st["batches"] - st["compiles"]
    assert np.isfinite(st["latency_p50_s"]) and st["latency_p50_s"] <= st["latency_p99_s"] + 1e-12


def test_engine_round_lanes_equal_feasible(monkeypatch):
    """A round's lanes, over each request's padded operators (kept for the
    request's life: the same operator objects every round), equal
    feasible() of the padded request at its bound, bit for bit; x comes
    back unpadded, on the host."""
    probs = [build("match", erdos(*SIZE_TIERS[i % 2], seed=i), device="cpu") for i in range(3)]
    engine = LPEngine(LPServeConfig(opts=OPTS, lanes=4))
    rounds = []
    solve_stack = Solver.solve_stack

    def record(self, problems, bounds):
        batch = solve_stack(self, problems, bounds)
        rounds.append((list(problems), list(bounds), batch))
        return batch

    monkeypatch.setattr(Solver, "solve_stack", record)
    for p in probs:
        engine.submit(p)
    padded = [engine._requests[r].padded for r in range(3)]
    engine.run()
    solver = Solver(OPTS)
    assert len(rounds) >= 2
    for problems, bounds, batch in rounds:
        assert len(problems) == 4  # pad_lanes: the idle slot re-runs a live probe
        assert all(any(p is q for q in padded) for p in problems)
        for j, (p, b) in enumerate(zip(problems, bounds)):
            res = solver.feasible(p, b)
            assert (int(batch.status[j]), int(batch.iters[j]), int(batch.ls_probes[j])) == \
                (res.status, res.iters, res.ls_probes)
            assert _bits(float(batch.max_px[j])) == _bits(res.max_px) and torch.equal(batch.x[j], res.x)
    for r, p in enumerate(probs):
        sol = engine.result(r)
        assert sol.feasible and sol.x.shape == (p.n_vars,) and isinstance(sol.x, np.ndarray)


def test_solve_stack_equals_stacked_solve_batch():
    """Solver.solve_stack is solve_batch of the stacked problems, bit for
    bit, with stack_problems' refusals."""
    padded, _ = pad_problems([build("vcover", erdos(*t, seed=i), device="cpu") for i, t in enumerate(SIZE_TIERS)])
    bounds = [p.hi for p in padded]
    solver = Solver(OPTS)
    a = solver.solve_stack(padded, bounds)
    b = solver.solve_batch(stack_problems(padded), bounds, batched_problem=True)
    assert torch.equal(a.x, b.x) and list(a.iters) == list(b.iters) and list(a.status) == list(b.status)
    with pytest.raises(ValueError, match="2 bounds for 3 stacked problems"):
        solver.solve_stack(padded, bounds[:2])
    with pytest.raises(ValueError, match="static field 'n_vars'"):
        solver.solve_stack([build("match", erdos(*t, seed=0), device="cpu") for t in SIZE_TIERS[:2]], [1.0, 1.0])


def test_engine_audit_launches_leaves_state():
    probs = [build("match", erdos(40, 100, seed=s), device="cpu") for s in (0, 1, 2)]
    engine = LPEngine(LPServeConfig(opts=OPTS, lanes=2))
    for p in probs:
        engine.submit(p)
    before = engine.stats()
    launches = engine.audit_launches()
    ((key, (stacked, bounds)),) = launches.items()
    assert key[0] == "match" and key[-1] == BucketSpec(64, 256)
    assert stacked.P.u.shape == (2, 256) and bounds.shape == (2,)
    assert repr(engine.stats()) == repr(before) and len(engine._buckets[key].queue) == 3  # NaN latencies: by repr


def test_engine_not_found_request():
    prob = build("match", erdos(40, 100, seed=0), device="cpu")
    engine = LPEngine(LPServeConfig(opts=OPTS, lanes=2))
    sols = engine.solve_many([dataclasses.replace(prob, lo=40.0, hi=80.0)])
    assert not sols[0].found and sols[0].objective == 0.0
    assert engine.stats()["not_found"] == 1


def test_engine_feasibility_only_request():
    _, prob = _pair(_star_gen_match())
    engine = LPEngine(LPServeConfig(opts=OPTS, lanes=2, policy=BucketPolicy(vertex_floor=8, edge_floor=8)))
    sols = engine.solve_many([prob])
    assert sols[0].feasible and np.isnan(sols[0].objective)
    assert sols[0].feasibility_calls == 1  # bound_mode="none": a single probe


def test_engine_unpadded_lanes_mode():
    """pad_lanes=False launches exactly the active lane count."""
    probs = [build("match", erdos(40, 100, seed=s), device="cpu") for s in (0, 1)]
    engine = LPEngine(LPServeConfig(opts=OPTS, lanes=4, pad_lanes=False))
    assert all(s.feasible for s in engine.solve_many(probs))
    assert engine.stats()["lane_occupancy"] == 1.0


def test_engine_rejects_bad_config():
    with pytest.raises(ValueError, match="lanes") as err:
        LPServeConfig(lanes=0)
    with pytest.raises(ValueError) as ref_err:
        RefConfig(lanes=0)
    assert str(err.value) == str(ref_err.value)
    # lane slots must split evenly over the mesh's data axis
    with pytest.raises(ValueError, match="data axis") as err:
        LPServeConfig(lanes=3, mesh=MeshPlan(pod=1, data=2))
    with pytest.raises(ValueError) as ref_err:
        RefConfig(lanes=3, mesh=RefMeshPlan(pod=1, data=2))
    assert str(err.value) == str(ref_err.value)


MESH_CODE = """
from repro_torch.dist import MeshPlan
from repro_torch.graphs import build, erdos
from repro_torch.lpserve import LPEngine, LPServeConfig

probs = [build("match", erdos(30 + 10 * i, 80 + 25 * i, seed=i), device="cpu") for i in range(5)]
probs += [build("vcover", erdos(40, 110, seed=9), device="cpu")]
eng = LPEngine(LPServeConfig(lanes=4, mesh=MeshPlan(pod=2, data=2)))
sols = eng.solve_many(probs)
st = eng.stats()
print(json.dumps({"dst": [[s.feasible, s.objective] for s in sols], "mesh": st["mesh"],
                  "completed": st["completed"], "keys": sorted(st)}))
"""


def test_engine_mesh_sharded_lanes():
    """LPEngine on a (2, 2) plan over four gloo ranks against the reference's
    sequential engine (tests/test_dist_solver.py::test_lpserve_mesh_sharded_lanes):
    the same feasibility, objectives within rtol 0.1, the mesh stats; every
    rank serves the same answers."""
    refs = [ref_build("match", ref_erdos(30 + 10 * i, 80 + 25 * i, seed=i)) for i in range(5)]
    refs += [ref_build("vcover", ref_erdos(40, 110, seed=9))]
    want = RefEngine(RefConfig(lanes=4))
    ref = want.solve_many(refs)
    ranks = run_ranks(MESH_CODE, world=4)
    for d in ranks:
        assert d == ranks[0]
    d = ranks[0]
    assert d["completed"] == 6
    assert set(d["keys"]) == set(want.stats()) | {"mesh"}
    for r, (df, do) in zip(ref, d["dst"]):
        assert bool(r.feasible) == df
        if df:
            np.testing.assert_allclose(do, float(r.objective), rtol=0.1)
    mesh = d["mesh"]
    assert mesh["devices"] == 4 and mesh["pod"] == 2 and mesh["data"] == 2
    assert mesh["lanes_per_device"] == 2
    assert mesh["dist_launches"] > 0
    assert mesh["psum_rounds"] > 0  # pod splitting actually communicated
    assert sorted(mesh) == ["data", "devices", "dist_launches", "lane_rounds_per_device", "lanes_per_device", "pod",
                            "psum_rounds"]


def test_serving_demo_on_cpu(capsys):
    """python -m repro_torch.lpserve, the twin of examples/serve_lp_batch.py,
    on the CPU at the example's tiers."""
    assert serve_main(["--device", "cpu", "--requests", "4", "--lanes", "2"]) == 0
    out = capsys.readouterr().out
    assert "all requests feasible; engine objectives match sequential solve" in out
    assert "bucket match/V64xE256" in out and "request  3: vcover" in out
