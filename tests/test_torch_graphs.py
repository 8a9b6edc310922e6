"""Host graph layer of the port vs the reference: generators, baselines, builders.

``repro_torch.graphs`` keeps numpy copies of the reference's graph,
generator and baseline modules; the same seed must give the same edges
and the same baseline values. The builders must give the same bounds and,
for each bound, the same materialized P and C.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.graphs import baselines as ref_baselines
from repro.graphs import build as ref_build
from repro.graphs import generators as ref_gen
from repro.graphs.graph import Graph as RefGraph
from repro.graphs.problems import generalized_matching_problem as ref_gen_match
from repro_torch.graphs import Graph, baselines, build, generators, generalized_matching_problem

GENERATORS = [
    ("rgg", (9,), {"seed": 3}),
    ("rgg", (8,), {"seed": 0, "target_degree": 9.0}),
    ("kron", (8,), {"seed": 2, "edgefactor": 8}),
    ("erdos", (200, 600), {"seed": 3}),
    ("erdos", (50, 2000), {"seed": 1}),
    ("grid2d", (6,), {}),
    ("bipartite_ratings", (60, 40), {"avg_ratings": 12.0, "seed": 0}),
    ("bipartite_ratings", (500, 120), {"avg_ratings": 20.0, "seed": 7}),
]


def _same_graph(a, b):
    assert (a.n, a.name, a.bipartite_split) == (b.n, b.name, b.bipartite_split)
    np.testing.assert_array_equal(a.u, b.u)
    np.testing.assert_array_equal(a.v, b.v)
    assert a.u.dtype == b.u.dtype == np.int32


def _port(g: RefGraph) -> Graph:
    return Graph(n=g.n, u=g.u, v=g.v, name=g.name, bipartite_split=g.bipartite_split)


@pytest.mark.parametrize("name,args,kw", GENERATORS, ids=[f"{g[0]}{g[1]}" for g in GENERATORS])
def test_generators_same_edges(name, args, kw):
    _same_graph(getattr(generators, name)(*args, **kw), getattr(ref_gen, name)(*args, **kw))


def test_graph_helpers(small_graphs):
    for g in small_graphs.values():
        p = _port(g)
        np.testing.assert_array_equal(p.degrees(), g.degrees())
        for a, b in zip(p.adjacency_lists(), g.adjacency_lists()):
            np.testing.assert_array_equal(a, b)
        assert p.validate()
    e = np.array([[3, 1], [1, 3], [2, 2], [0, 4], [4, 0]])
    _same_graph(Graph.from_edges(5, e, "x"), RefGraph.from_edges(5, e, "x"))


@pytest.mark.parametrize("gname", ["grid6", "rgg10", "kron8", "er", "path", "star", "triangle"])
def test_baselines_same_values(gname, small_graphs):
    g = small_graphs[gname]
    p = _port(g)
    assert baselines.greedy_maximal_matching(p) == ref_baselines.greedy_maximal_matching(g)
    assert baselines.greedy_dominating_set(p) == ref_baselines.greedy_dominating_set(g)
    assert baselines.matching_vertex_cover(p) == ref_baselines.matching_vertex_cover(g)
    assert baselines.charikar_peel(p) == ref_baselines.charikar_peel(g)


def test_exact_baselines_same_values():
    g = ref_gen.bipartite_ratings(60, 40, avg_ratings=12.0, seed=0)
    assert baselines.hopcroft_karp_bmatch(_port(g)) == ref_baselines.hopcroft_karp_bmatch(g)
    g = ref_gen.grid2d(4)
    for problem in ("match", "vcover", "dom-set", "dense-sub"):
        assert baselines.exact_lp(problem, _port(g))[0] == ref_baselines.exact_lp(problem, g)[0]


def _bounds(prob):
    return [prob.lo, 0.5 * (prob.lo + prob.hi), prob.hi]


@pytest.mark.parametrize("family", ["match", "bmatch", "vcover", "dom-set", "dense-sub"])
def test_builders_same_problem(family):
    g = ref_gen.bipartite_ratings(12, 7, avg_ratings=3.0, seed=1) if family == "bmatch" else ref_gen.grid2d(4)
    ref = ref_build(family, g)
    prob = build(family, _port(g), device="cpu")
    assert (prob.name, prob.kind, prob.sense, prob.bound_mode) == (ref.name, ref.kind, ref.sense, ref.bound_mode)
    assert (prob.lo, prob.hi, prob.n_vars, prob.nnz) == (ref.lo, ref.hi, ref.n_vars, ref.nnz)
    for b in _bounds(ref):
        P, C, pm, cm = prob.instantiate(b)
        rP, rC, rpm, rcm = ref.instantiate(b)
        np.testing.assert_allclose(P.materialize().numpy(), np.asarray(rP.materialize()), rtol=1e-15)
        np.testing.assert_allclose(C.materialize().numpy(), np.asarray(rC.materialize()), rtol=1e-15)
        assert (pm is None) == (rpm is None) and (cm is None) == (rcm is None)


def test_gen_match_builder_same_problem():
    g = ref_gen.bipartite_ratings(10, 6, avg_ratings=3.0, seed=2)
    lb = np.where(np.arange(g.n) < 10, 1.0, 0.0)
    ub = np.full(g.n, 3.0)
    ref = ref_gen_match(g, lb, ub)
    prob = generalized_matching_problem(_port(g), lb, ub, device="cpu")
    assert prob.nnz == ref.nnz and prob.n_vars == ref.n_vars
    np.testing.assert_allclose(prob.P.materialize().numpy(), np.asarray(ref.P.materialize()), rtol=1e-15)
    np.testing.assert_allclose(prob.C.materialize().numpy(), np.asarray(ref.C.materialize()), rtol=1e-15)
    np.testing.assert_array_equal(prob.c_mask.numpy(), np.asarray(ref.c_mask))


def test_builders_keep_int32_edges():
    prob = build("match", _port(ref_gen.grid2d(3)), device="cpu", dtype=torch.float32)
    assert prob.P.u.dtype == torch.int32 and prob.P.v.dtype == torch.int32
    assert prob.c.dtype == torch.float32


def test_import_without_jax():
    """repro_torch imports, solves and runs an encoder forward on the CPU, with jax unimportable."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.api, repro_torch.graphs, repro_torch.kernels\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.kernels.flash_attention\n"
        "from repro_torch.api import MWUOptions, Solver\n"
        "from repro_torch.graphs import build, grid2d\n"
        "sol = Solver(MWUOptions(eps=0.1), batch_width=2).solve(build('match', grid2d(3), device='cpu'))\n"
        "assert sol.feasible and 3.4 <= sol.objective <= 4.0 + 1e-9, sol.objective\n"
        "import torch\n"
        "from dataclasses import replace\n"
        "cfg = replace(repro_torch.configs.get('hubert-xlarge').reduced(), attn_impl='pallas')\n"
        "m = repro_torch.models.Model(cfg, device='cpu')\n"
        "x = m.logits(m({'frames': torch.zeros(1, 20, cfg.d_model)}))\n"
        "assert x.shape == (1, 20, cfg.padded_vocab) and bool(torch.isfinite(x).all())\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
