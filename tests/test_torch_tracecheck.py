"""repro_torch.tracecheck: the gate passes on the real tree and fails on
deliberately broken invariants.

One test for each test of tests/test_tracecheck.py and
tests/test_tracecheck_passes.py (same intent, same name where it makes
sense), run on the CPU: the ``plain`` cases run as they are, and the card
(``kernel``) cases, which this host cannot run, are held through their
reckoning (:func:`repro_torch.tracecheck.capture.reckon_case`: the same
case on the CPU with the operators' products on the card's path). The
card's own runs are tests/test_torch_cuda.py's (``-k tracecheck``).

Held against the reference: the matrix names equal
``repro.tracecheck.matrix.default_matrix``'s under xla -> plain, pallas ->
kernel, quick and full; ``_POD_COLLECTIVES`` and ``DEFAULT_TOLERANCES`` are
read from the reference's source text (its ``capture``, ``rules``,
``diff``, ``report`` and ``cli`` fail at import under jax 0.9, so no test
imports them).
"""
import ast
import copy
import json
import os
from collections import Counter

import pytest
import torch

from repro.tracecheck.matrix import default_matrix as ref_default_matrix
from repro_torch.api import MWUOptions, Solver
from repro_torch.core import mwu, stepsize
from repro_torch.dist import DistSolver, MeshPlan
from repro_torch.graphs import erdos
from repro_torch.graphs import build as build_graph_lp
from repro_torch.launch.dryrun import fake_world
from repro_torch.lpserve import LPEngine, LPServeConfig
from repro_torch.tracecheck import Finding, TraceArtifact, run_rules
from repro_torch.tracecheck import capture as cap
from repro_torch.tracecheck import costmodel
from repro_torch.tracecheck.capture import (_POD_COLLECTIVES, CAPTURE_MAX_ITER, Recorder, build_problem, capture_case,
                                            loop_kernels, reckon_case, record)
from repro_torch.tracecheck.cli import CAPTURE_RULE, run_matrix
from repro_torch.tracecheck.diff import (BACKEND_PARITY_RULE, DIST_PARITY_RULE, canonical_tokens, check_backend_parity,
                                         check_dist_identity)
from repro_torch.tracecheck.matrix import FAMILIES, Case, default_matrix
from repro_torch.tracecheck.report import build_report, load_baseline, prune_baseline, split_findings
from repro_torch.tracecheck.rules import (SMEM_BYTES_PER_BLOCK, DtypeRule, HostReadsRule, KernelPathRule, LaneIteration,
                                          LoopCollectivesRule, SmemFootprintRule, TripCountRule, parse_ptxas)

REF_TRACECHECK = os.path.join(os.path.dirname(__file__), os.pardir, "src", "repro", "tracecheck")


def _mid(problem):
    return cap._mid_bound(problem)


@pytest.fixture(scope="module")
def problem():
    return build_problem("match")


@pytest.fixture(scope="module")
def plain_solve():
    return capture_case(Case("solve", "match", "plain"))


@pytest.fixture(scope="module")
def card_solve():
    """The card's solve of match, reckoned on the CPU."""
    return reckon_case(Case("solve", "match", "kernel"))


def _solve(problem, opts=MWUOptions(max_iter=CAPTURE_MAX_ITER), name="solve", **fields):
    art, out = record(lambda: Solver(opts).feasible(problem, _mid(problem)), name, opts=opts, **fields)
    return art


# --------------------------------------------------------- clean passes --
@pytest.mark.parametrize("backend", ["plain", "kernel"])
def test_clean_solve_artifacts_have_no_findings(backend):
    case = Case("solve", "match", backend)
    art = capture_case(case) if backend == "plain" else reckon_case(case)
    assert art.lane_iterations(), "recorded no loop"
    assert run_rules([art]) == [], f"backend={backend}"


def test_quick_matrix_single_device_passes():
    """The quick sweep is clean on the current tree; the card cases are
    listed as skipped on a host with no card (no fallback to the CPU)."""
    report = run_matrix(quick=True, verbose=False)
    assert report["ok"] and report["findings"] == [], [f["fingerprint"] for f in report["findings"]]
    assert report["artifacts"], "quick matrix captured nothing"
    cards = [c.name for c in default_matrix(quick=True) if c.backend == "kernel"]
    if not torch.cuda.is_available():
        assert report["skipped"] == cards
        assert {n for n in report["reckoned"]} <= {c for c in report["cost_cells"]}


# ------------------------------------------------- broken: kernel path --
def test_kernel_path_missing_kernel_fails(problem, plain_solve):
    """The CPU's run held to the card's expectation (the scatter kernel a
    product): the kernel-path rule must fire."""
    P, C, _, _ = problem.instantiate(_mid(problem))
    art = copy.copy(plain_solve)
    art.name = "broken:scatter-stripped"
    art.expect = dict(art.expect, kernels=dict(loop_kernels(P, C, stepsize.newton_step_record, card=True)))
    findings = KernelPathRule().check(art)
    assert [f.fingerprint for f in findings] == ["kernel-path::broken:scatter-stripped::missing"]
    assert findings[0].detail["missing"] == {"incidence_scatter": 1}


def test_kernel_path_unexpected_kernel_fails(problem, card_solve):
    """A kernel call on a path declared without it is also a violation."""
    P, C, _, _ = problem.instantiate(_mid(problem))
    art = copy.copy(card_solve)
    art.name = "broken:unexpected"
    art.expect = dict(art.expect, kernels=dict(loop_kernels(P, C, stepsize.newton_step_record, card=False)))
    fps = [f.fingerprint for f in KernelPathRule().check(art)]
    assert fps == ["kernel-path::broken:unexpected::unexpected"]


def test_kernel_path_lone_gather_on_a_masked_packing_side_fails(monkeypatch):
    """A served match lane (masked incidence) gathers inside the step
    direction; with its gather form gone, a lone gather appears."""
    eng = LPEngine(LPServeConfig(opts=MWUOptions(max_iter=CAPTURE_MAX_ITER), lanes=2))
    eng.submit(build_graph_lp("match", erdos(24, 60, seed=1), device="cpu", dtype=torch.float32))
    (stacked, bounds), = eng.audit_launches().values()
    run = lambda: eng.solver.solve_batch(stacked, bounds, batched_problem=True)  # noqa: E731
    art, _ = record(run, "lpserve")
    assert KernelPathRule().check(art) == []
    assert all(ln.kernels["incidence_gather"] == 0 for ln in art.lane_iterations())
    from repro_torch.core.operators import Incidence

    monkeypatch.setattr(Incidence, "as_gather", lambda self, y: None)
    monkeypatch.setattr(Incidence, "rmatvec", lambda self, y: cap_gather(self, y))
    broken, _ = record(run, "broken:lone-gather")
    monkeypatch.undo()
    findings = KernelPathRule().check(broken)
    assert [f.key for f in findings] == ["unexpected"] and findings[0].detail["unexpected"] == {"incidence_gather": 1}


def cap_gather(op, y):
    from repro_torch.kernels import incidence_gather

    return incidence_gather(op.u, op.v, y, op.edge_mask, op._weights(y.dtype))


@pytest.mark.parametrize("family", FAMILIES)
def test_card_path_launches_every_loop_kernel(family):
    """Each family's card path (reckoned) calls 2 softmax, 1 step direction,
    1 search, 3 axpy a lane iteration, plus its operators' gathers and
    scatters: the kernel-path rule holds it to that."""
    art = reckon_case(Case("solve", family, "kernel"))
    for ln in art.lane_iterations():
        assert ln.kernels["softmax_weights"] == 2 and ln.kernels["step_direction"] == 1
        assert ln.kernels["newton_search"] == 1 and ln.kernels["axpy_reduce"] == 3
        assert ln.kernels["incidence_scatter"] >= 1
        assert ln.kernels == ln.expected
    assert KernelPathRule().check(art) == []


# ------------------------------------------- broken: loop collectives --
def test_extra_collective_in_loop_fails():
    """A psum in the lane iteration of a plan that declares none."""
    lane = LaneIteration(lane=0, collectives=Counter(psum=1))
    art = TraceArtifact(name="broken:psum", expect={"collectives": {}})
    art.solves = [cap.SolveRecord(iterations=[cap.LoopIteration(lanes=[lane])])]
    findings = LoopCollectivesRule().check(art)
    assert len(findings) == 1
    assert findings[0].detail["got"] == {"psum": 1}
    # a real pod-sharded run held to the identity plan's declaration
    pod = capture_case(Case("dist", "match", "plain", pod=2, data=1))
    pod.expect = dict(pod.expect, collectives={})
    assert LoopCollectivesRule().check(pod)[0].detail["got"] == {"psum": 2, "pmax": 1}


def test_matching_collectives_pass():
    lane = LaneIteration(lane=0, collectives=Counter(psum=1))
    art = TraceArtifact(name="ok:psum", expect={"collectives": {"psum": 1}})
    art.solves = [cap.SolveRecord(iterations=[cap.LoopIteration(lanes=[lane])])]
    assert LoopCollectivesRule().check(art) == []


@pytest.mark.parametrize("family", ["match", "gen-match"])
def test_pod_plans_issue_three_collectives_a_lane_iteration(family):
    """Edge slabs (match) and column slabs (gen-match): the dy and dz
    completions and max(d), a lane iteration, over the fake group; the data
    plan issues none."""
    art = capture_case(Case("dist", family, "plain", pod=2, data=1))
    assert art.lane_iterations() and all(ln.collectives == Counter(_POD_COLLECTIVES) for ln in art.lane_iterations())
    assert LoopCollectivesRule().check(art) == []
    data = capture_case(Case("dist", family, "plain", pod=1, data=2))
    assert data.lane_iterations() and not any(ln.collectives for ln in data.lane_iterations())


# ------------------------------------------------ broken: host reads --
def _read_in_loop(monkeypatch):
    """Make every lane iteration read max(d) to the host (an .item())."""
    inner = mwu.step_direction

    def reading(*a, **k):
        d, d_max = inner(*a, **k)
        d_max.item()
        return d, d_max

    monkeypatch.setattr(mwu, "step_direction", reading)


def test_read_inside_loop_fails(problem, monkeypatch):
    _read_in_loop(monkeypatch)
    art = _solve(problem, name="broken:read")
    monkeypatch.undo()
    findings = HostReadsRule().check(art)
    assert len(findings) == 1
    assert findings[0].key == "item" and findings[0].severity == "error"
    assert findings[0].detail["count"] == CAPTURE_MAX_ITER - 1  # every iteration after the first


def test_traced_solve_read_is_allowed():
    """solve_traced's rows come from the loop's one read: allowed, and
    required (a traced artifact without them warns)."""
    art = capture_case(Case("solve_traced", "match", "plain"))
    assert art.trace_rows == CAPTURE_MAX_ITER
    assert HostReadsRule().check(art) == []
    art.trace_rows = None
    assert [(f.key, f.severity) for f in HostReadsRule().check(art)] == [("missing-trace-hook", "warning")]


def test_reads_once_a_solve_are_outside_the_loop(plain_solve):
    """_start's and _finalize's reads (the MoE router's two a layer) are not
    the loop's; the loop reads once an iteration, for all lanes."""
    s = plain_solve.solves[0]
    assert s.reads["start"] >= 1 and s.reads["finalize"] == 1
    assert all(it.all_reads() == ["loop"] for it in s.iterations)
    batch = capture_case(Case("solve_batch", "match", "plain"))
    assert all(len(it.lanes) == 2 and it.all_reads() == ["loop"] for it in batch.solves[0].iterations)


# --------------------------------------------------- broken: smem budget --
def _ptxas(name: str, smem: int, registers: int, spill: int = 0) -> str:
    return (f"== thing.cu (rc 0)\n"
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 1 barriers, {smem} bytes smem, 400 bytes cmem[0]\n")


def test_smem_footprint_over_budget_fails():
    art = TraceArtifact(name="broken:smem", ptxas=_ptxas("_ZN2rt6kernelEv", SMEM_BYTES_PER_BLOCK + 1024, 128))
    findings = SmemFootprintRule().check(art)
    assert len(findings) == 1
    assert findings[0].detail["bytes"] > findings[0].detail["budget"]
    assert findings[0].key == "rt::kernel:smem"


def test_smem_footprint_at_limit_passes():
    log = _ptxas("_ZN2rt6kernelILi80EEEvv", SMEM_BYTES_PER_BLOCK, 255)
    assert SmemFootprintRule().check(TraceArtifact(name="ok", ptxas=log)) == []
    entries = parse_ptxas(log)
    assert entries["_ZN2rt6kernelILi80EEEvv"]["registers"] == 255 and len(entries) == 1


def test_smem_rule_spills_fail_but_f32_flash_at_256():
    spilled = _ptxas("_ZN2rt16flash_f32_kernelILi128EEEvv", 0, 255, spill=64)
    assert [f.key for f in SmemFootprintRule().check(TraceArtifact(name="s", ptxas=spilled))] == \
        ["rt::flash_f32_kernel<128>:spill"]
    allowed = _ptxas("_ZN2rt16flash_f32_kernelILi256EEEvv", 0, 255, spill=64)
    assert SmemFootprintRule().check(TraceArtifact(name="s", ptxas=allowed)) == []
    # the search's stamped timing instantiation may spill; the instantiation the wrappers launch may not
    stamped = "_ZN2rt13search_kernelIdNS_13NewtonControlELb1EEEvNS_12SearchParamsIT_EE"
    assert SmemFootprintRule().check(TraceArtifact(name="s", ptxas=_ptxas(stamped, 1216, 128, spill=4))) == []
    launched = _ptxas(stamped.replace("Lb1E", "Lb0E"), 1216, 128, spill=4)
    assert [f.key for f in SmemFootprintRule().check(TraceArtifact(name="s", ptxas=launched))] == \
        ["rt::search_kernel<double,NewtonControl,false>:spill"]


# --------------------------------------------------- trip count, dtype --
def test_trip_count_matches_max_iter(problem):
    opts = MWUOptions(max_iter=3)
    art = _solve(problem, opts, expect={"trips": 3})
    assert art.solves[0].stops == {0: ("cap", 3)}
    assert TripCountRule().check(art) == []


def test_trip_count_drift_fails(problem):
    """The loop stopped at a cap other than the configured one."""
    art = _solve(problem, MWUOptions(max_iter=3), expect={"trips": 5})
    findings = TripCountRule().check(art)
    assert len(findings) == 1
    assert findings[0].detail["trips"] == [3]


def test_dtype_rule_flags_f64_leak(problem, monkeypatch):
    """An f32 solve whose loop widens max(d) to f64."""
    inner = mwu.step_direction
    monkeypatch.setattr(mwu, "step_direction", lambda *a, **k: (lambda d, m: (d, m.double().float()))(*inner(*a, **k)))
    art = _solve(problem, name="leak", expect={"dtype": "float32"})
    monkeypatch.undo()
    fps = [f.fingerprint for f in DtypeRule().check(art)]
    assert fps == ["dtype-discipline::leak::ops"]


def test_dtype_rule_respects_f64_problems(plain_solve):
    """An f64 solve has nothing wider to leak into; an f32 solve's f64 record
    row and alpha are its own, not leaks."""
    art = _solve(build_problem("match", dtype=torch.float64), name="f64-ok", expect={"dtype": "float64"})
    assert art.expect["dtype"] == "float64" and DtypeRule().check(art) == []
    assert plain_solve.expect["dtype"] == "float32" and DtypeRule().check(plain_solve) == []


# -------------------------------------------------------- baseline gate --
def test_baseline_suppresses_known_findings(tmp_path):
    f1 = Finding(rule="kernel-path", severity="error", artifact="a", message="m", key="missing")
    f2 = Finding(rule="trip-count", severity="error", artifact="b", message="m")
    allow = {f1.fingerprint}
    new, old = split_findings([f1, f2], allow)
    assert [x.fingerprint for x in new] == [f2.fingerprint]
    assert [x.fingerprint for x in old] == [f1.fingerprint]

    cases = [Case("solve", "match", "plain")]
    rep = build_report(cases, [], [f1], allow)
    assert rep["ok"] and rep["n_baselined"] == 1
    rep = build_report(cases, [], [f1, f2], allow)
    assert not rep["ok"] and rep["n_new_errors"] == 1

    p = tmp_path / "baseline.json"
    p.write_text('{"allow": ["kernel-path::a::missing"]}')
    assert load_baseline(str(p)) == {"kernel-path::a::missing"}


def test_shipped_baseline_is_empty():
    """The tree is clean: the checked-in allowlist must stay empty."""
    assert load_baseline() == set()


# ------------------------------------------------------- lpserve audit --
def test_lpserve_audit_does_not_mutate_engine():
    eng = LPEngine(LPServeConfig(lanes=4))
    for seed in (1, 2):
        eng.submit(build_graph_lp("match", erdos(24, 60, seed=seed), device="cpu"))
    before = {k: (len(s.queue), len(s.active)) for k, s in eng._buckets.items()}
    launches = eng.audit_launches()
    assert launches  # at least one dispatch key assembled
    for key, (stacked, bounds) in launches.items():
        assert len(bounds) == 4  # padded to the lane count
        assert stacked.c.shape[0] == 4
    after = {k: (len(s.queue), len(s.active)) for k, s in eng._buckets.items()}
    assert before == after
    # searches untouched: the engine still drains to completion
    sols = eng.run()
    assert len(sols) == 2


# ------------------------------------------------------ backend parity --
@pytest.mark.parametrize("family", FAMILIES)
def test_backend_parity_clean_on_real_tree(family):
    """The card path (reckoned) differs from the CPU's only in kernel
    regions: the products' scatter kernel where the CPU runs index_add_."""
    cpu = capture_case(Case("solve", family, "plain"))
    card = reckon_case(Case("solve", family, "kernel"))
    assert check_backend_parity(cpu, card, f"parity:{family}:backend") == []
    assert canonical_tokens(cpu.steady_iteration()) != canonical_tokens(card.steady_iteration())


def test_backend_parity_fails_on_structural_perturbation(plain_solve, card_solve, problem, monkeypatch):
    """A host read inside the loop on one side is a structural divergence
    with no kernel to excuse it."""
    _read_in_loop(monkeypatch)
    read = _solve(problem, name="perturbed")
    monkeypatch.undo()
    findings = check_backend_parity(plain_solve, read, "perturbed")
    assert len(findings) == 1
    f = findings[0]
    assert f.rule == BACKEND_PARITY_RULE and f.severity == "error"
    assert "read:item" in f.message


def test_backend_parity_fails_outside_kernel_regions(plain_solve, problem):
    """Ops that differ with no kernel token in their region (another eps:
    another eta in the smoothing) are drift too."""
    other = _solve(problem, MWUOptions(max_iter=CAPTURE_MAX_ITER, eps=0.05), name="eps")
    findings = check_backend_parity(plain_solve, other, "perturbed")
    assert [f.key for f in findings] == ["structural-drift"]
    assert "outside any kernel region" in findings[0].message


# -------------------------------------------------------- dist identity --
@pytest.mark.parametrize("family", FAMILIES)
def test_dist_identity_clean_on_real_tree(family):
    js = capture_case(Case("solve_batch", family, "plain"))
    jd = capture_case(Case("dist", family, "plain", pod=1, data=1))
    assert canonical_tokens(js) == canonical_tokens(jd)
    assert check_dist_identity(js, jd, f"parity:{family}:dist") == []


def test_dist_identity_fails_on_perturbation(problem):
    """Any op-level drift (here: a different eps, so another eta) must
    produce a failing parity finding."""
    bounds = cap._batch_bounds(problem, 2)
    js, _ = record(lambda: Solver(MWUOptions(max_iter=3)).solve_batch(problem, bounds), "a")
    jd, _ = record(lambda: DistSolver(MWUOptions(max_iter=3, eps=0.05)).solve_batch(problem, bounds), "b")
    findings = check_dist_identity(js, jd, "perturbed")
    assert len(findings) == 1
    assert findings[0].rule == DIST_PARITY_RULE
    assert findings[0].detail["n_regions"] >= 1


def test_dist_lower_batch_is_the_recorded_artifact(problem):
    bounds = cap._batch_bounds(problem, 2)
    solver = DistSolver(MWUOptions(max_iter=3))
    art = solver.lower_batch(problem, bounds)
    assert [len(its) for its in art.solves[0].lane_iterations().values()] == [3, 3]
    assert solver.jaxpr_batch(problem, bounds) == canonical_tokens(art)
    with fake_world(2):
        pod = DistSolver(MWUOptions(max_iter=3), plan=MeshPlan(pod=2)).lower_batch(problem, bounds)
    assert all(ln.collectives == Counter(_POD_COLLECTIVES) for ln in pod.lane_iterations())


# ------------------------------------------------------------ costmodel --
def _synthetic(iters: int = 3) -> TraceArtifact:
    """A recorded loop of ``iters`` iterations of one 8x8 @ 8x8 product."""
    a = torch.ones(8, 8)
    rec = Recorder()
    with rec:
        rec.begin_solve()
        rec.begin_loop()
        for _ in range(iters):
            with rec.lane(0):
                a @ a
            rec.loop_read()
        rec.begin_finalize()
        rec.end_solve()
    return rec.artifact("synth")


def test_iteration_cost_counts_body_once():
    cost = costmodel.iteration_cost(_synthetic(3))
    # one 8x8x8 product an iteration: NOT multiplied by the trip count 3
    assert cost["flops"] == 2 * 8 * 8 * 8
    assert cost["n_collectives"] == 0
    assert cost["roofline"]["bottleneck"] in ("compute", "memory", "collective")


def test_iteration_cost_none_without_loop():
    rec = Recorder()
    with rec:
        torch.ones(4) + 1
    assert costmodel.iteration_cost(rec.artifact("empty")) is None


def test_cost_regression_2x_flops_fails():
    cell = costmodel.iteration_cost(_synthetic())
    baseline = {"synth": {m: cell[m] / 2 if m == "flops" else cell[m] for m in costmodel.DEFAULT_TOLERANCES}}
    findings = costmodel.check_costs({"synth": cell}, baseline)
    assert len(findings) == 1
    f = findings[0]
    assert f.rule == costmodel.COST_RULE and f.severity == "error"
    assert f.fingerprint == "cost-regression::synth::flops"
    assert f.detail["current"] == 2 * f.detail["baseline"]


def test_cost_within_tolerance_passes():
    cell = costmodel.iteration_cost(_synthetic())
    base = {m: cell[m] for m in costmodel.DEFAULT_TOLERANCES}
    assert costmodel.check_costs({"synth": cell}, {"synth": base}) == []
    # shrinking never fails (ratcheting down is a baseline regen, not a gate)
    grown = {m: v * 10 for m, v in base.items()}
    assert costmodel.check_costs({"synth": cell}, {"synth": grown}) == []


def test_extra_collective_fails_at_zero_tolerance():
    cell = dict(costmodel.iteration_cost(_synthetic()))
    cell["n_collectives"] = 1
    base = {m: 0 if m == "n_collectives" else cell[m] for m in costmodel.DEFAULT_TOLERANCES}
    findings = costmodel.check_costs({"synth": cell}, {"synth": base})
    assert [f.key for f in findings] == ["n_collectives"]


def test_missing_baseline_warns_not_errors():
    cell = costmodel.iteration_cost(_synthetic())
    findings = costmodel.check_costs({"new-cell": cell}, {})
    assert len(findings) == 1
    assert findings[0].severity == "warning"
    assert findings[0].key == "missing-baseline"


def test_cost_baseline_roundtrip(tmp_path):
    cell = costmodel.iteration_cost(_synthetic())
    path = str(tmp_path / "cost.json")
    costmodel.write_cost_baseline({"synth": cell}, path)
    loaded = costmodel.load_cost_baseline(path)
    assert set(loaded) == {"synth"}
    assert loaded["synth"]["flops"] == cell["flops"]
    assert costmodel.check_costs({"synth": cell}, loaded) == []


def test_shipped_cost_baseline_covers_solve_cells():
    """The committed baseline gates every family x backend solve cell."""
    cells = costmodel.load_cost_baseline()
    for fam in FAMILIES:
        for backend in ("plain", "kernel"):
            assert f"solve:{fam}:{backend}" in cells


def test_recorded_solver_cell_produces_cost(plain_solve, card_solve):
    cost = costmodel.iteration_cost(plain_solve)
    assert cost is not None and cost["flops"] > 0 and cost["hbm_bytes"] > 0
    assert costmodel.check_costs({plain_solve.name: cost}, costmodel.load_cost_baseline()) == []
    card = costmodel.iteration_cost(card_solve)
    assert card["kernel_calls"]["incidence_scatter"] == 1 and "incidence_scatter" not in cost["kernel_calls"]


def test_costs_do_not_depend_on_the_run():
    """Two recordings of one case count alike; a card cell against a
    reckoning that differs fails the device check."""
    case = Case("solve", "vcover", "kernel")
    a, b = costmodel.iteration_cost(reckon_case(case)), costmodel.iteration_cost(reckon_case(case))
    assert costmodel.check_reckoned({"c": a}, {"c": b}) == []
    assert a["flops"] == b["flops"] and a["hbm_bytes"] == b["hbm_bytes"]
    off = dict(b, hbm_bytes=b["hbm_bytes"] * (1 + 1e-5))
    assert [f.key for f in costmodel.check_reckoned({"c": a}, {"c": off})] == ["hbm_bytes"]


# ------------------------------------------- capture-error (satellite) --
def test_capture_failure_is_a_named_finding_not_a_crash():
    """One broken entry must not abort the sweep: the cell becomes an error
    finding naming family/backend, later cases are still checked."""
    report = run_matrix(cases=[Case("bogus", "match", "plain"), Case("solve", "match", "plain")], verbose=False)
    assert not report["ok"]
    errs = [f for f in report["findings"] if f["rule"] == CAPTURE_RULE]
    assert len(errs) == 1
    assert errs[0]["artifact"] == "bogus:match:plain"
    assert "family `match`" in errs[0]["message"]
    assert "backend `plain`" in errs[0]["message"]
    # the sweep continued: the solve artifact was still captured and checked
    assert "solve:match:plain" in report["artifacts"]


# ------------------------------------------- prune-baseline (satellite) --
def test_prune_baseline_drops_stale_keeps_live(tmp_path):
    live = Finding(rule="kernel-path", severity="error", artifact="a", message="m", key="missing")
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"allow": [live.fingerprint, "dead-rule::gone::x"]}))
    removed = prune_baseline([live], str(path))
    assert removed == ["dead-rule::gone::x"]
    assert json.loads(path.read_text()) == {"allow": [live.fingerprint]}
    # idempotent: nothing left to prune
    assert prune_baseline([live], str(path)) == []


# ------------------------------------------------------------------ CLI --
def test_cli_list_and_quick_matrix(capsys, tmp_path):
    from repro_torch.tracecheck.__main__ import main

    assert main(["--list", "--quick"]) == 0
    assert capsys.readouterr().out.split() == [c.name for c in default_matrix(quick=True)]
    out = tmp_path / "TRACECHECK.json"
    assert main(["--matrix", "--quick", "--out", str(out), "--costmodel-out", str(tmp_path / "COST.json")]) == 0
    written = json.loads(out.read_text())
    assert written["ok"] and set(written["skipped"]) == ({c.name for c in default_matrix(quick=True)
                                                          if c.backend == "kernel"}
                                                         if not torch.cuda.is_available() else set())
    assert main([]) == 2


# ------------------------------------------------ held against the reference --
_BACKEND = {"xla": "plain", "pallas": "kernel"}


@pytest.mark.parametrize("quick", [True, False])
def test_default_matrix_names_match_the_reference(quick):
    ref = [c.name for c in ref_default_matrix(quick=quick)]
    mapped = [":".join(_BACKEND.get(p, p) for p in name.split(":")) for name in ref]
    assert [c.name for c in default_matrix(quick=quick)] == mapped
    assert [c.name for c in default_matrix(quick=quick)] == [
        c.name for c in (Case(r.entry, r.family, _BACKEND[r.backend], r.pod, r.data, r.lanes, r.op)
                         for r in ref_default_matrix(quick=quick))]


def _constant(module: str, name: str):
    tree = ast.parse(open(os.path.join(REF_TRACECHECK, module)).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_pod_collectives_are_the_references():
    assert _POD_COLLECTIVES == _constant("capture.py", "_POD_COLLECTIVES") == {"psum": 2, "pmax": 1}


def test_cost_tolerances_are_the_references():
    assert costmodel.DEFAULT_TOLERANCES == _constant("costmodel.py", "DEFAULT_TOLERANCES")
