"""The one load generator: it reads a mix's file and drives the program.

Two modes, chosen by the mix's ``"mode"``:

* ``solver``: ``clients`` (1) client calls ``Solver(opts,
  batch_width=...).solve(problem)`` back to back, closed loop, over the
  cell's instances (one, or a configuration's fixed labellings), each pass
  a seeded permutation of them, in whole passes until ``seconds`` have
  passed: the solve running then finishes and counts, and so does the rest
  of its pass. Each solve is timed on the host clock up to its returned
  ``Solution`` (``x`` on the host) and a synchronize.
* ``engine``: ``clients`` clients each submit a request to one
  ``LPEngine`` and the next when it has come back, closed loop; the
  requests walk the instance pool in a seeded order, each pass over the
  pool a new permutation of it, so every seed serves the same sizes. After
  ``seconds`` no client submits again, and the engine is stepped until
  every request is back (at most ``drain_s`` more). Each request is timed
  from its ``submit`` to the step after which its ``Solution`` is there.

Both wrap the calls into the program's layers in the benchmark's spans
(``solve``; ``engine.step``, ``submit``, ``result``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
from torch.profiler import record_function


@dataclass
class Window:
    answers: list = field(default_factory=list)  # (instance index, Solution)
    walls: list = field(default_factory=list)  # seconds a solve / a request
    rounds: list = field(default_factory=list)  # (loop iterations, lane iterations) a feasibility loop
    seconds: float = 0.0  # the window, first call to last answer
    lost: int = 0  # requests that never came back
    edge_slots: tuple | None = None  # (real edges, bucket edge slots) over the engine's occupied lanes


def recording_solver(opts, batch_width: int, rounds: list):
    """A ``Solver`` that notes each feasibility loop's loop and lane
    iterations (a round's lanes share its loop iterations)."""
    from repro_torch.api import Solver

    class RecordingSolver(Solver):
        def solve_batch(self, problem, bounds, **kw):
            res = super().solve_batch(problem, bounds, **kw)
            rounds.append((int(np.max(res.iters)), int(np.sum(res.iters))))
            return res

        def feasible(self, problem, bound=None, trace=False):
            res = super().feasible(problem, bound, trace)
            rounds.append((int(res.iters), int(res.iters)))
            return res

    return RecordingSolver(opts, batch_width=batch_width)


def solver_window(traffic: dict, opts, problems: list, seconds: float, sync, rng) -> Window:
    w = Window()
    solver = recording_solver(opts, int(traffic["batch_width"]), w.rounds)
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:  # whole passes over the instances
        for k in rng.permutation(len(problems)).tolist():
            with record_function("solve"):
                t0 = time.perf_counter()
                sol = solver.solve(problems[k])
                sync()
                w.walls.append(time.perf_counter() - t0)
            sol.last_result = None  # the lanes' x stays on the card otherwise
            w.answers.append((k, sol))
    w.seconds = time.perf_counter() - t_start
    return w


def pool_order(n_pool: int, rng: np.random.Generator):
    """Pool indices without end: passes over the pool, each a permutation."""
    while True:
        yield from rng.permutation(n_pool).tolist()


def engine_window(traffic: dict, opts, problems: list, seconds: float, sync, rng) -> Window:
    from repro_torch.lpserve import LPEngine, LPServeConfig

    w = Window()
    engine = LPEngine(LPServeConfig(opts=opts, lanes=int(traffic["lanes"])))
    order = pool_order(len(problems), rng)
    live: dict = {}  # rid -> (pool index, submit time)

    def submit():
        k = next(order)
        with record_function("submit"):
            live[engine.submit(problems[k])] = (k, time.perf_counter())

    t_start = time.perf_counter()
    for _ in range(int(traffic["clients"])):
        submit()
    while live:
        with record_function("engine.step"):
            stepped = engine.step()
        now = time.perf_counter()
        for rid in list(live):
            with record_function("result"):
                sol = engine.result(rid)
            if sol is None:
                continue
            k, t0 = live.pop(rid)
            w.walls.append(now - t0)
            w.answers.append((k, sol))
            if now - t_start < seconds:
                submit()
        if not stepped or now - t_start > seconds + float(traffic["drain_s"]):
            break
    sync()
    w.seconds = time.perf_counter() - t_start
    w.lost = len(live)
    # the engine's own counters, unrounded (``LPEngine.stats()`` rounds them)
    counters = [state.stats for state in engine._buckets.values()]
    w.edge_slots = (sum(c.real_edges_used for c in counters), sum(c.edge_slots_used for c in counters))
    return w


def warm_engine(traffic: dict, opts, problems: list, steps: int = 2) -> None:
    """Run ``steps`` rounds of each bucket the pool fills, at the mix's lane
    count, on engines thrown away after."""
    from repro_torch.lpserve import LPEngine, LPServeConfig

    seen = set()
    for prob in problems:
        engine = LPEngine(LPServeConfig(opts=opts, lanes=int(traffic["lanes"])))
        engine.submit(prob)
        bucket = next(iter(engine.stats()["buckets"]))
        if bucket in seen:
            continue
        seen.add(bucket)
        for _ in range(steps):
            engine.step()

