"""Continuous-batching LP engine, in PyTorch.

Port of ``repro.lpserve.engine``. The unit of work is one *feasibility
probe* of one request's bound search. Each request is a declarative
:class:`~repro_torch.api.Problem`; its binary search is unrolled into an
incremental :class:`BoundSearch` state machine so the engine can
interleave many searches:

1. ``submit`` pads the problem into its shape bucket (:mod:`.bucketing`)
   and enqueues it under a ``(family, bucket)`` dispatch key. The padded
   problem, and with it its operators and their scatter CSR (built at the
   first round on the card), is kept for the request's whole life; the
   objective is copied to the host once, for the certificates;
2. each ``step`` picks the busiest key, refills that bucket's fixed lane
   slots from the queue (continuous batching — free lanes are refilled
   every round, no waiting for a full batch), collects every active
   request's next probe bound, and runs ONE batched feasibility loop
   across the lanes (``Solver.solve_stack``: the arithmetic of the
   reference's stacked ``solve_batch``, each lane over its request's own
   padded operators). Padded rows reach the kernels as row masks, so a
   padded lane reads the host once a loop iteration, as any lane does;
3. the lanes' x comes back to the host in one copy, is unpadded to the
   original variables and fed to each request's search; finished
   requests certify into per-request :class:`~repro_torch.api.Solution`s
   and free their lane.

With a ``mesh`` (a :class:`~repro_torch.dist.MeshPlan`) the rounds run on
:class:`~repro_torch.dist.DistSolver`: lane slots split over the plan's
``data`` groups and each lane's variables over its ``pod`` ranks. Every
rank runs the same engine on the same requests (a rank's engine is one of
the plan's ``torch.distributed`` processes) and gets every answer.

Every launch under a dispatch key has identical shapes (slot count is
static; unused lanes re-run a duplicate). The port has no jit cache: its
kernels are built once for every shape, so ``compiles`` and
``compile_cache_hits`` count the first and the later dispatches of each
(dispatch key, lane count) shape, the reference's own fallback where it
cannot read its cache.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..api.problem import Problem
from ..api.solver import Solution, Solver, certify_solution, feasibility_solution, not_found_solution, stack_problems
from ..core.mwu import MWUOptions, MWUResult, Status
from ..dist import DistSolver, MeshPlan
from .bucketing import BucketPolicy, BucketSpec, pad_problem, problem_dims
from .stats import BucketStats, aggregate

__all__ = ["LPServeConfig", "LPEngine", "BoundSearch"]


@dataclass(frozen=True)
class LPServeConfig:
    """Engine knobs (frozen so a config can key caches/logs).

    ``mesh`` (a :class:`repro_torch.dist.MeshPlan`, optional) splits each
    dispatch across the plan's ranks: lane slots fan out over the ``data``
    axis and each lane's variable space slabs over ``pod``. ``None`` keeps
    the single-device ``Solver`` path bit for bit.
    """

    opts: MWUOptions = field(default_factory=MWUOptions)
    lanes: int = 8  # batch slots per dispatch key
    policy: BucketPolicy = field(default_factory=BucketPolicy)
    rel_tol: float | None = None  # bound-search granularity (default eps/2)
    max_calls: int = 64  # per-request feasibility budget
    pad_lanes: bool = True  # always launch the full slot count (shape-static)
    mesh: MeshPlan | None = None  # split lane slots across this plan's ranks

    def __post_init__(self):
        if self.lanes < 1:
            raise ValueError("lanes must be >= 1")
        if self.mesh is not None and self.lanes % self.mesh.data != 0:
            raise ValueError(
                f"lanes ({self.lanes}) must be a multiple of the mesh data "
                f"axis ({self.mesh.data}) so lane slots shard evenly"
            )


class BoundSearch:
    """Incremental port of ``Solver._bound_search`` (one probe per round).

    ``next_bound`` yields the bound this request wants evaluated;
    ``update`` consumes the (unpadded) feasibility result and advances
    the bracket. ``solution`` is set exactly when the search finishes,
    built by the same certification helpers the sequential solver uses,
    so engine answers are bit-compatible with ``Solver.solve`` at
    ``batch_width=1``.
    """

    def __init__(self, problem: Problem, rel_tol: float, max_calls: int):
        self.problem = problem
        self.rel = rel_tol
        self.max_calls = max_calls
        self.stats = {"calls": 0, "iters": 0, "probes": 0}
        self.best: MWUResult | None = None
        self.best_bound: float | None = None
        self.solution: Solution | None = None
        self.lo = float(problem.lo) if problem.bound_mode != "none" else 0.0
        self.hi = float(problem.hi) if problem.bound_mode != "none" else 0.0
        self.is_max = problem.feasible_side == "lo"
        if problem.bound_mode == "none":
            self.phase = "single"
        elif self.is_max:
            self.phase = "bisect"
            self._maybe_finish()
        else:
            # min-like senses check the easy endpoint first (cheap
            # not-found exit, mirroring the legacy drivers)
            self.phase = "endpoint"

    @property
    def done(self) -> bool:
        return self.solution is not None

    def _bracket_open(self) -> bool:
        return self.hi / max(self.lo, 1e-300) > 1.0 + self.rel and self.stats["calls"] < self.max_calls

    def next_bound(self) -> float:
        assert not self.done, "search already finished"
        if self.phase == "single":
            return 1.0  # ignored by bound_mode="none" instantiation
        if self.phase == "endpoint":
            return self.hi
        if self.phase == "final_lo":
            return self.lo
        # geometric midpoint, written exactly as Solver._bound_search's
        # K=1 probe (lo * r ** (1/2)) so probe sequences are bit-identical
        return self.lo * (self.hi / max(self.lo, 1e-300)) ** 0.5

    def update(self, bound: float, res: MWUResult) -> None:
        assert not self.done, "search already finished"
        ok = int(res.status) == Status.FEASIBLE
        st = self.stats
        st["calls"] += 1
        st["iters"] += int(res.iters)
        st["probes"] += int(res.ls_probes)

        if self.phase == "single":
            self.solution = feasibility_solution(self.problem, res, st)
            return
        if self.phase == "endpoint":
            if not ok:
                self.solution = not_found_solution(self.problem, self.hi, res, st)
                return
            self.best, self.best_bound = res, self.hi
            self.phase = "bisect"
            self._maybe_finish()
            return
        if self.phase == "final_lo":
            if ok:
                self.solution = certify_solution(self.problem, res, self.lo, st)
            else:
                self.solution = not_found_solution(self.problem, self.lo, res, st)
            return
        # bisect: shrink the bracket toward the feasible side
        if self.is_max:
            if ok:
                self.lo, self.best, self.best_bound = bound, res, bound
            else:
                self.hi = bound
        else:
            if ok:
                self.hi, self.best, self.best_bound = bound, res, bound
            else:
                self.lo = bound
        self._maybe_finish()

    def _maybe_finish(self) -> None:
        if self._bracket_open():
            return
        if self.best is None:
            # only reachable for max-sense: lo itself was never probed
            self.phase = "final_lo"
            return
        self.solution = certify_solution(self.problem, self.best, self.best_bound, self.stats)


@dataclass
class _Request:
    rid: int
    problem: Problem  # original (unpadded) spec
    padded: Problem
    bucket: BucketSpec
    search: BoundSearch
    t_submit: float
    t_done: float | None = None


class _BucketState:
    """Live state of one (family, bucket) dispatch key."""

    def __init__(self, family: str, bucket: BucketSpec):
        self.bucket = bucket
        self.queue: deque[_Request] = deque()
        self.active: list[_Request] = []
        self.stats = BucketStats(family=family, bucket=str(bucket))

    @property
    def backlog(self) -> int:
        return len(self.queue) + len(self.active)


def _host_objective(problem: Problem) -> Problem:
    """``problem`` with its objective on the host: the search certifies with
    it, so a round's certificates read nothing from the card."""
    return problem if problem.c is None else dataclasses.replace(problem, c=problem.c.cpu())


class LPEngine:
    """Shape-bucketed continuous-batching server for graph-LP requests."""

    def __init__(self, config: LPServeConfig | None = None):
        self.cfg = config if config is not None else LPServeConfig()
        if self.cfg.mesh is not None:
            self.solver: Solver = DistSolver(self.cfg.opts, plan=self.cfg.mesh, batch_width=1,
                                             max_calls=self.cfg.max_calls)
        else:
            self.solver = Solver(self.cfg.opts, batch_width=1, max_calls=self.cfg.max_calls)
        self.rel_tol = self.cfg.rel_tol if self.cfg.rel_tol is not None else self.cfg.opts.eps / 2
        self._buckets: dict[tuple, _BucketState] = {}
        self._done: dict[int, Solution] = {}
        self._requests: dict[int, _Request] = {}
        self._next_rid = 0
        self._seen_shapes: set[tuple] = set()

    # ---------------------------------------------------------- intake --
    def _dispatch_key(self, prob: Problem, bucket: BucketSpec) -> tuple:
        return (prob.name, prob.kind, prob.sense, prob.bound_mode, bucket)

    def submit(self, problem: Problem) -> int:
        """Enqueue one request; returns its request id."""
        n, m = problem_dims(problem)
        bucket = self.cfg.policy.bucket_for(n, m)
        padded = pad_problem(problem, bucket)
        key = self._dispatch_key(problem, bucket)
        state = self._buckets.get(key)
        if state is None:
            state = self._buckets[key] = _BucketState(problem.name, bucket)
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(
            rid=rid,
            problem=problem,
            padded=padded,
            bucket=bucket,
            search=BoundSearch(_host_objective(problem), self.rel_tol, self.cfg.max_calls),
            t_submit=time.perf_counter(),
        )
        self._requests[rid] = req
        state.queue.append(req)
        state.stats.requests += 1
        # a request can be born finished (degenerate bracket, zero probes)
        if req.search.done:
            state.queue.pop()
            self._finish(state, req)
        return rid

    # -------------------------------------------------------- dispatch --
    def _pick_bucket(self) -> _BucketState | None:
        busiest = None
        for state in self._buckets.values():
            if state.backlog and (busiest is None or state.backlog > busiest.backlog):
                busiest = state
        return busiest

    def _finish(self, state: _BucketState, req: _Request) -> None:
        req.t_done = time.perf_counter()
        sol = req.search.solution
        self._done[req.rid] = sol
        state.stats.completed += 1
        state.stats.latencies_s.append(req.t_done - req.t_submit)
        if not sol.found:
            state.stats.not_found += 1

    def _lanes(self, active: list) -> tuple[list, list]:
        """(real lanes, launched lanes): ``(request, bound)`` pairs, the
        idle slots re-running live probes when ``pad_lanes``."""
        real = [(req, req.search.next_bound()) for req in active]
        lanes = list(real)
        if self.cfg.pad_lanes:
            while len(lanes) < self.cfg.lanes:  # idle lanes re-run a live probe
                lanes.append(lanes[len(lanes) % len(real)])
        return real, lanes

    def step(self) -> bool:
        """One dispatch round on the busiest bucket; False when idle."""
        state = self._pick_bucket()
        if state is None:
            return False
        # continuous batching: refill free lanes from the queue
        while len(state.active) < self.cfg.lanes and state.queue:
            state.active.append(state.queue.popleft())

        real, lanes = self._lanes(state.active)
        shape_key = (self._dispatch_key(lanes[0][0].problem, state.bucket), len(lanes))
        t0 = time.perf_counter()
        batch = self.solver.solve_stack([req.padded for req, _ in lanes], [b for _, b in lanes])
        x = batch.x[:len(real)].cpu()  # the real lanes' x in one copy (it waits for the round)
        dt = time.perf_counter() - t0
        hit = shape_key in self._seen_shapes
        self._seen_shapes.add(shape_key)

        st = state.stats
        st.batches += 1
        st.batch_seconds += dt
        st.lane_rounds += len(lanes)
        st.occupied_lane_rounds += len(real)
        st.feasibility_calls += len(real)
        st.compile_cache_hits += int(hit)
        st.compiles += int(not hit)
        for req, _ in real:
            _, m = problem_dims(req.problem)
            st.edge_slots_used += state.bucket.n_edges
            st.real_edges_used += m

        for j, (req, bound) in enumerate(real):
            res = dataclasses.replace(batch.lane(j), x=x[j, :req.problem.n_vars].clone())
            st.mwu_iters += int(res.iters)
            req.search.update(bound, res)
            if req.search.done:
                self._finish(state, req)
        state.active = [r for r in state.active if not r.search.done]
        return True

    # ------------------------------------------------------- inspection --
    def audit_launches(self) -> dict[tuple, tuple[Problem, np.ndarray]]:
        """The (stacked problem, bounds) each dispatch key would launch next.

        For every bucket with backlog, assembles the lanes exactly like
        :meth:`step` — refill simulation, live probe bounds, idle-lane
        duplication, :func:`stack_problems` — WITHOUT mutating any engine
        state (queues, searches and stats are untouched). Keyed by the
        ``(name, kind, sense, bound_mode, bucket)`` dispatch key.
        """
        out: dict[tuple, tuple[Problem, np.ndarray]] = {}
        for key, state in self._buckets.items():
            would_be_active = list(state.active)
            backlog = list(state.queue)
            while len(would_be_active) < self.cfg.lanes and backlog:
                would_be_active.append(backlog.pop(0))
            if not would_be_active:
                continue
            _, lanes = self._lanes(would_be_active)
            out[key] = (stack_problems([req.padded for req, _ in lanes]), np.asarray([b for _, b in lanes]))
        return out

    # ------------------------------------------------------------ sync --
    def run(self) -> dict[int, Solution]:
        """Drain every pending request; returns {rid: Solution}."""
        while self.step():
            pass
        return dict(self._done)

    def solve_many(self, problems: list[Problem]) -> list[Solution]:
        """Submit + drain a batch; Solutions in submission order."""
        rids = [self.submit(p) for p in problems]
        self.run()
        return [self._done[r] for r in rids]

    def result(self, rid: int) -> Solution | None:
        return self._done.get(rid)

    def stats(self) -> dict:
        """Aggregated serving counters (see :mod:`repro_torch.lpserve.stats`).

        With a mesh the dict gains a ``"mesh"`` section: the plan shape,
        per-rank lane occupancy (lane rounds divided across the ``data``
        axis), and the distributed solver's launch / all_reduce-round
        counters (the reference's key: ``psum_rounds``).
        """
        out = aggregate(s.stats for s in self._buckets.values())
        plan = self.cfg.mesh
        if plan is not None:
            lane_rounds = sum(s.stats.lane_rounds for s in self._buckets.values())
            ds = self.solver.dist_stats
            out["mesh"] = {
                "pod": plan.pod,
                "data": plan.data,
                "devices": plan.n_devices,
                "lanes_per_device": self.cfg.lanes // plan.data,
                "lane_rounds_per_device": lane_rounds // plan.data,
                "dist_launches": ds["launches"],
                "psum_rounds": ds["psum_rounds"],
            }
        return out
