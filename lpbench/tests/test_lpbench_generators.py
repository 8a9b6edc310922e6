"""The frozen generators give canonical graphs that repeat per seed, and a
labelling keeps the graph and its edge order."""
import numpy as np
import pytest
import torch

from lpbench import harness, spec

PARAMS = {
    "bipartite_ratings": {"n_users": 500, "n_items": 60, "avg_ratings": 15, "min_ratings": 10, "zipf_a": 1.5},
    "kron": {"scale": 8, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19},
}


def _gen(name, seed):
    gen = torch.Generator().manual_seed(seed)
    return spec.load_module(spec.here() / "generators" / f"{name}.py").generate(PARAMS[name], gen, "cpu")


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_canonical(name):
    g = _gen(name, 3)
    u, v = g["u"].long(), g["v"].long()
    assert g["u"].dtype == torch.int32 and u.numel() > 0
    assert bool((u < v).all()) and int(v.max()) < g["n"]
    key = u * g["n"] + v
    assert bool((key[1:] > key[:-1]).all()), "sorted by (u, v), no repeats"
    if g["bipartite_split"] is not None:
        assert bool((u < g["bipartite_split"]).all()) and bool((v >= g["bipartite_split"]).all())


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_repeats_per_seed(name):
    a, b, c = _gen(name, 5), _gen(name, 5), _gen(name, 6)
    assert torch.equal(a["u"], b["u"]) and torch.equal(a["v"], b["v"])
    assert a["u"].numel() != c["u"].numel() or not torch.equal(a["v"], c["v"])


def test_bipartite_ratings_shape():
    g = _gen("bipartite_ratings", 1)
    per_user = torch.bincount(g["u"].long(), minlength=PARAMS["bipartite_ratings"]["n_users"])
    assert int(per_user.min()) >= 1  # at least 10 draws a user; repeats merge
    items = torch.bincount(g["v"].long() - g["bipartite_split"])
    assert int(items[0]) > int(items[-1]), "item popularity falls with the item's rank"


@pytest.mark.parametrize("config", ["bmatch-netflix", "vcover-kron"])
def test_labelling_keeps_graph_and_order(config):
    cfg = spec.resolve(f"{config}.solve").config
    params = {**cfg["params"], **({"n_users": 400, "n_items": 50} if "n_users" in cfg["params"] else {"scale": 7})}
    a, b = harness.make_instances(cfg, params, "cpu", 0, [1, 2])
    a2, = harness.make_instances(cfg, params, "cpu", 0, [1])
    assert np.array_equal(a.u, a2.u) and np.array_equal(a.v, a2.v), "a labelling repeats per seed"
    assert not np.array_equal(a.u, b.u)
    assert (a.u < a.v).all() and (b.u < b.v).all()
    # the same edges in the same order under a renaming: edge e joins
    # vertices of the same degrees in both
    def degree_pairs(g):
        deg = np.bincount(np.concatenate([g.u, g.v]), minlength=g.n)
        return np.sort(np.stack([deg[g.u], deg[g.v]]), axis=0)

    assert np.array_equal(degree_pairs(a), degree_pairs(b))
    if a.split is not None:
        assert (a.u < a.split).all() and (b.v >= b.split).all()


def test_greedy_bounds_survive_a_labelling():
    """The reason a labelling may reuse the builder's bounds."""
    from repro_torch.graphs import Graph, baselines

    cfg = spec.resolve("bmatch-netflix.solve").config
    params = {**cfg["params"], "n_users": 400, "n_items": 50}
    a, b = harness.make_instances(cfg, params, "cpu", 0, [1, 2])
    ga = Graph(n=a.n, u=a.u, v=a.v, bipartite_split=a.split)
    gb = Graph(n=b.n, u=b.u, v=b.v, bipartite_split=b.split)
    assert baselines.greedy_maximal_matching(ga) == baselines.greedy_maximal_matching(gb)
    pa = harness.build_problem(a, "bmatch", "cpu", torch.float64)
    pb = harness.relabelled(pa, b, "cpu")
    pb_built = harness.build_problem(b, "bmatch", "cpu", torch.float64)
    assert (pb.lo, pb.hi, pb.n_vars, pb.nnz) == (pb_built.lo, pb_built.hi, pb_built.n_vars, pb_built.nnz)
    assert torch.equal(pb.P.u, pb_built.P.u) and torch.equal(pb.P.v, pb_built.P.v)
