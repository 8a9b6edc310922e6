"""Synthetic graph generators mirroring the paper's input suite (Table 1).

* ``rgg(k)``   — random geometric graphs rgg-k (2^k vertices, planar-like),
                 matching SuiteSparse's rgg_n_2_k family: radius chosen so
                 expected degree ~ 15 (paper lists |E| ~ 15 |V|).
* ``kron(k)``  — Graph500-style stochastic Kronecker graphs kron-k
                 (2^k vertices, |E| ~ 80 |V|... here edgefactor is an
                 argument, default 16 to keep CPU benchmarks tractable),
                 strong community structure / power-law degrees.
* ``erdos``    — Erdős–Rényi G(n, m) control.
* ``bipartite_ratings`` — Netflix/KDD-like user-item bipartite graphs for
                 the generalized-matching study (Appendix A.1/A.2).

All generators are deterministic in ``seed`` (numpy Generator) and give
the same graphs as ``repro.graphs.generators``, seed for seed.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph

__all__ = ["rgg", "kron", "erdos", "bipartite_ratings", "grid2d"]


def rgg(scale: int, seed: int = 0, target_degree: float = 15.0) -> Graph:
    """Random geometric graph with 2^scale vertices on the unit square.

    Connects points within radius r where pi r^2 n = target_degree.
    Uses a cell grid for O(n) expected neighbor search.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    pts = rng.random((n, 2))
    r = float(np.sqrt(target_degree / (np.pi * n)))
    cells = max(1, int(1.0 / r))
    cx = np.minimum((pts[:, 0] * cells).astype(np.int64), cells - 1)
    cy = np.minimum((pts[:, 1] * cells).astype(np.int64), cells - 1)
    cell_id = cx * cells + cy
    order = np.argsort(cell_id, kind="stable")
    sorted_cell = cell_id[order]
    # cell -> slice of `order`
    starts = np.searchsorted(sorted_cell, np.arange(cells * cells))
    ends = np.searchsorted(sorted_cell, np.arange(cells * cells), side="right")

    edges = []
    r2 = r * r
    for dxy in ((0, 0), (1, 0), (0, 1), (1, 1), (1, -1)):
        dx, dy = dxy
        # pair points in cell (i,j) with cell (i+dx, j+dy)
        src_cells = np.arange(cells * cells)
        sx, sy = src_cells // cells, src_cells % cells
        tx, ty = sx + dx, sy + dy
        ok = (tx >= 0) & (tx < cells) & (ty >= 0) & (ty < cells)
        for c_src, c_tgt in zip(src_cells[ok], (tx * cells + ty)[ok]):
            a = order[starts[c_src] : ends[c_src]]
            b = order[starts[c_tgt] : ends[c_tgt]]
            if len(a) == 0 or len(b) == 0:
                continue
            d = pts[a][:, None, :] - pts[b][None, :, :]
            close = (d * d).sum(-1) <= r2
            ia, ib = np.nonzero(close)
            if dx == 0 and dy == 0:
                keep = a[ia] < b[ib]
                ia, ib = ia[keep], ib[keep]
            if len(ia):
                edges.append(np.stack([a[ia], b[ib]], axis=1))
    e = np.concatenate(edges) if edges else np.zeros((0, 2), np.int64)
    return Graph.from_edges(n, e, name=f"rgg-{scale}")


def kron(scale: int, seed: int = 0, edgefactor: int = 16) -> Graph:
    """Graph500 stochastic Kronecker generator (A=.57,B=.19,C=.19,D=.05)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edgefactor * n
    A, B, C = 0.57, 0.19, 0.19
    ij = np.zeros((2, m), np.int64)
    ab = A + B
    c_norm = C / (1 - ab)
    a_norm = A / ab
    for ib in range(scale):
        ii_bit = rng.random(m) > ab
        jj_bit = rng.random(m) > np.where(ii_bit, c_norm, a_norm)
        ij[0] += (1 << ib) * ii_bit
        ij[1] += (1 << ib) * jj_bit
    perm = rng.permutation(n)  # relabel to hide locality (Graph500 step)
    ij = perm[ij]
    return Graph.from_edges(n, ij.T, name=f"kron-{scale}")


def erdos(n: int, m: int, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(int(m * 1.3) + 8, 2))
    g = Graph.from_edges(n, e, name=f"er-{n}")
    if g.m > m:
        keep = rng.choice(g.m, size=m, replace=False)
        g = Graph(n=n, u=g.u[keep], v=g.v[keep], name=g.name)
        order = np.argsort(g.u * n + g.v)
        g = Graph(n=n, u=g.u[order], v=g.v[order], name=g.name)
    return g


def grid2d(side: int) -> Graph:
    """side x side grid graph — known matching/cover numbers for tests."""
    idx = np.arange(side * side).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return Graph.from_edges(side * side, np.concatenate([right, down]), name=f"grid-{side}")


def bipartite_ratings(
    n_users: int,
    n_items: int,
    avg_ratings: float = 20.0,
    seed: int = 0,
    zipf_a: float = 1.5,
) -> Graph:
    """User-item bipartite graph with power-law item popularity.

    Mirrors the Netflix/KDD structure of Appendix A.2: users on the left
    [0, n_users), items on the right [n_users, n_users + n_items); edges =
    ratings. Item popularity ~ Zipf, user activity ~ Poisson(avg_ratings),
    min 10 ratings per user (the paper excludes <10-rating users).
    """
    rng = np.random.default_rng(seed)
    n_ratings = np.maximum(rng.poisson(avg_ratings, size=n_users), 10)
    total = int(n_ratings.sum())
    users = np.repeat(np.arange(n_users), n_ratings)
    # zipf-ish item choice via inverse-CDF on a truncated power law
    ranks = (rng.pareto(zipf_a - 1.0, size=total) + 1.0)
    items = (n_items / ranks).astype(np.int64) % n_items
    items = n_users + items
    e = np.stack([users, items], axis=1)
    g = Graph.from_edges(n_users + n_items, e, name=f"ratings-{n_users}x{n_items}",
                         bipartite_split=n_users)
    return g
