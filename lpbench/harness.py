"""One run of one cell: set-up, the measured window, the trace, the check.

:func:`run_cell` does everything but look for the chip, so that the tests
can drive a whole run on the CPU at a tiny size with the kernels' plain
versions; ``run.py`` looks for the chip and prints.
"""
from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import load, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclass
class Instance:
    n: int
    u: np.ndarray  # int32 endpoints, on the host: the benchmark's copy
    v: np.ndarray
    split: int | None
    base: int  # which draw of the generator this is a labelling of
    problem: object = None  # the program's Problem


@dataclass
class Record:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    mode: str
    window: load.Window
    roof_bytes: float | None = None  # the needed HBM bytes of the window's work
    hbm_bytes_per_s: float | None = None
    trace: trace.TraceSummary | None = None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _seeded(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def make_instances(config: dict, params: dict, device, base: int, label_seeds: list, root=spec.ROOT) -> list:
    """Labellings of one draw of the configuration's generator (drawn from
    its ``graph_seed`` and ``base``), one per seed of ``label_seeds``, with a
    host copy of their edges.

    A labelling renames the vertices, and so every index and memory access
    pattern, but keeps every edge, the edge order and so every search bound
    (the greedy bounds walk the edges in order).
    """
    draw = _seeded(device, int(config["graph_seed"]) * 1_000_003 + base)
    g = spec.generator(config, root).generate(params, draw, device)
    n, split, u0, v0 = int(g["n"]), g["bipartite_split"], g["u"].long(), g["v"].long()
    del g
    out = []
    for seed in label_seeds:
        gen = _seeded(device, seed)
        if split is None:
            perm = torch.randperm(n, device=device, generator=gen)
            a, b = perm[u0], perm[v0]
            u, v = torch.minimum(a, b), torch.maximum(a, b)
        else:  # users among users, items among items: u < split <= v stays
            perm = torch.cat([torch.randperm(split, device=device, generator=gen),
                              split + torch.randperm(n - split, device=device, generator=gen)])
            u, v = perm[u0], perm[v0]
        out.append(Instance(n=n, u=u.to(torch.int32).cpu().numpy(), v=v.to(torch.int32).cpu().numpy(), split=split,
                            base=base))
        del perm, u, v
    return out


def relabelled(problem, inst: Instance, device):
    """``problem`` (built by the program's builder on another labelling of
    ``inst``'s draw) with ``inst``'s endpoints in its incidence operators.
    The builder would return just this: its bounds depend only on the edge
    order, which a labelling keeps."""
    import dataclasses

    from repro_torch.core.operators import Incidence, LinOp
    from repro_torch.graphs import Graph

    u, v = torch.as_tensor(inst.u, device=device), torch.as_tensor(inst.v, device=device)

    def swap(op):
        if isinstance(op, Incidence):
            return dataclasses.replace(op, u=u, v=v)
        if isinstance(op, LinOp) and dataclasses.is_dataclass(op):
            kw = {f.name: swap(getattr(op, f.name)) for f in dataclasses.fields(op)
                  if isinstance(getattr(op, f.name), LinOp)}
            return dataclasses.replace(op, **kw) if kw else op
        return op

    graph = Graph(n=inst.n, u=inst.u, v=inst.v, name=problem.graph.name, bipartite_split=inst.split)
    return dataclasses.replace(problem, P=swap(problem.P), C=swap(problem.C), graph=graph)


def warm_operators(problem, dtype) -> None:
    """One product each way of each operator: what an operator builds at its
    first product on the card (the scatter's CSR) is built in set-up."""
    for op in (problem.P, problem.C):
        if op is not None:
            rows, cols = op.shape
            op.matvec(torch.zeros(cols, dtype=dtype, device=problem.device))
            op.rmatvec(torch.zeros(rows, dtype=dtype, device=problem.device))


def build_problem(inst: Instance, family: str, device, dtype):
    from repro_torch.graphs import Graph, build

    graph = Graph(n=inst.n, u=inst.u, v=inst.v, name=family, bipartite_split=inst.split)
    return build(family, graph, device=device, dtype=dtype)


def _roof_bytes(roof, w: load.Window, instances: list, mode: str) -> float:
    if mode == "solver":  # the labellings share their shapes
        per_loop, per_lane = roof.iteration_bytes(instances[0].n, instances[0].u.size)
        return sum(loop * per_loop + lane * per_lane for loop, lane in w.rounds)
    total = 0.0
    for k, sol in w.answers:  # each request's lanes run over its own operators
        per_loop, per_lane = roof.iteration_bytes(instances[k].n, instances[k].u.size)
        total += sol.mwu_iters_total * (per_loop + per_lane)
    return total


def judge_window(ref, eps: float, w: load.Window, instances: list, device, limits: dict) -> tuple[dict, int]:
    """Every answer of the window against the plain reference ``ref``
    (``reference/<family>.py``): the worst reading of each number, and how
    many answers failed."""
    from repro_torch.core.mwu import Status

    worst = {"unsolved": 0.0, "feas_excess": -math.inf, "obj_err": 0.0, "opt_gap": -math.inf, "bound_gap": -math.inf}
    failed = w.lost
    by_instance: dict = {}
    for k, sol in w.answers:
        by_instance.setdefault(k, []).append(sol)
    optimum: dict = {}  # labellings of one draw share it
    for k, sols in by_instance.items():
        inst = instances[k]
        if inst.base not in optimum:
            optimum[inst.base] = ref.exact_optimum(inst.n, inst.u, inst.v, inst.split)
        opt = optimum[inst.base]
        u = torch.as_tensor(inst.u, device=device)
        v = torch.as_tensor(inst.v, device=device)
        for sol in sols:
            if sol.x is None or sol.status != Status.FEASIBLE:
                worst["unsolved"] += 1
                failed += 1
                continue
            got = ref.judge(inst.n, u, v, sol.x, sol.objective, sol.bound, opt, eps)
            bad = False
            for name, value in got.items():
                worst[name] = max(worst[name], value) if not math.isnan(value) else math.inf
                bad |= not value <= limits[name]
            failed += bad
        del u, v
    worst["unsolved"] += w.lost
    return worst, failed


def run_cell(cell_name: str, seed: int, seconds: float, trace_on: bool, *, device="cuda", t_process=None,
             overrides: dict | None = None, dtype: str | None = None, root=spec.ROOT) -> dict:
    """One run of a cell; returns the result line's fields (and ``log``,
    lines for standard error)."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell = spec.resolve(cell_name, root)
    overrides = overrides or {}
    cfg = {**cell.config, **overrides.get("config", {})}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    params = {**cfg["params"], **overrides.get("params", {})}
    family = cfg["family"]
    dt = DTYPES[dtype or cfg["dtype"]]
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    log: list = []

    from repro_torch.api import MWUOptions

    opts = MWUOptions(eps=float(cfg["eps"]), step_rule=cfg["step_rule"])
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import loader

        _, built_s = loader.build()
        log.append(f"kernel library: {built_s:.1f} s to find or build")
        torch.cuda.reset_peak_memory_stats()

    # set-up: the instances, the program's problems, the warm-up
    rng = np.random.default_rng(int(seed))
    if traffic["mode"] == "solver":
        fixed = int(cfg.get("labellings", 0))
        if fixed:  # the same labellings in every run; the seed orders them
            seeds = [int(cfg["graph_seed"]) * 1_000_003 + (1 << 40) + k for k in range(fixed)]
        else:
            seeds = [int(seed) * 1_000_003]
        instances = make_instances(cfg, params, device, 0, seeds, root)
        instances[0].problem = build_problem(instances[0], family, device, dt)
        for inst in instances[1:]:
            inst.problem = relabelled(instances[0].problem, inst, device)
            warm_operators(inst.problem, dt)
    else:
        instances = []
        for k, entry in enumerate(overrides.get("pool", traffic["pool"])):
            inst, = make_instances(cfg, {**params, **entry}, device, k, [int(seed) * 1_000_003 + k], root)
            inst.problem = build_problem(inst, family, device, dt)
            instances.append(inst)
    problems = [inst.problem for inst in instances]
    log.append(f"instances (vertices, edges): {sorted({(inst.n, int(inst.u.size)) for inst in instances})}")
    if traffic["mode"] == "solver":
        load.recording_solver(opts, int(traffic["batch_width"]), []).solve(problems[0])
    else:
        load.warm_engine(traffic, opts, problems)
    sync()
    gc.collect()
    setup_s = time.perf_counter() - t_process

    # the window; with --trace 1 the profiler covers all of it, and is
    # stopped (seconds of host work) only once the window has closed
    window = load.solver_window if traffic["mode"] == "solver" else load.engine_window
    prof = None
    if trace_on:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        with prof, torch.profiler.record_function("window"):
            w = window(traffic, opts, problems, seconds, sync, rng)
            sync()
    else:
        w = window(traffic, opts, problems, seconds, sync, rng)
    summary = trace.summarize(prof.profiler.kineto_results.events()) if prof is not None else None
    del prof

    peak = int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0
    kind = torch.cuda.get_device_name() if torch.device(device).type == "cuda" else "cpu"
    # free the program's state before the reference runs
    for inst in instances:
        inst.problem = None
    del problems
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    roof = spec.roofline(cfg, root)
    peaks = spec.load_peaks(root)
    rec = Record(mode=traffic["mode"], window=w, trace=summary,
                 hbm_bytes_per_s=peaks.get(kind, {}).get("hbm_bytes_per_s"),
                 roof_bytes=_roof_bytes(roof, w, instances, traffic["mode"]))
    if trace_on:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], root).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "solve_s": (statistics.fmean(w.walls) if traffic["mode"] == "solver" and w.walls else None),
            "lp_per_s": (len(w.answers) / w.seconds if traffic["mode"] == "engine" and w.seconds > 0 else None),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end
                   if e2e.get(m["name"]) is not None}

    limits = {**cfg["limits"], "unsolved": 0}
    worst, failed = judge_window(spec.reference(cfg, root), float(cfg["eps"]), w, instances, device, limits)
    checks = {name: {"value": value, "limit": limits[name]} for name, value in worst.items()}
    correct = failed == 0 and len(w.answers) > 0
    attempted = len(w.answers) + w.lost
    device_info = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    log.append(f"window: {len(w.answers)} answers in {w.seconds:.3f} s; set-up {setup_s:.3f} s; "
               f"lane iterations {[s.mwu_iters_total for _, s in w.answers]}; seconds {[round(t, 3) for t in w.walls]}")
    for name, c in checks.items():
        log.append(f"check {name} {c['value']!r} limit {c['limit']!r}")
    out["checks"] = checks
    out["log"] = log
    return out
