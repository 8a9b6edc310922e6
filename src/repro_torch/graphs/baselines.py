"""Combinatorial + exact baselines (paper §6.2 comparison targets).

A numpy/scipy copy of ``repro.graphs.baselines``.

Stand-ins for the paper's external baselines, all runnable offline:

* ``scipy.optimize.linprog`` (HiGHS) — plays CPLEX/Gurobi: exact
  fractional LP solutions.
* ``scipy.sparse.csgraph.maximum_bipartite_matching`` (Hopcroft–Karp in
  C) — plays *ms-bfs-graft* for bmatch.
* ``charikar_peel`` — Charikar's greedy 2-approximation for densest
  subgraph — plays *GBBS*.
* greedy maximal matching / greedy dominating set / matching-based
  2-approx vertex cover — classic heuristics used both as comparison
  points and as binary-search bound providers for the MWU drivers.
"""
from __future__ import annotations

import heapq
import time

import numpy as np
import scipy.sparse as sp

from .graph import Graph

__all__ = [
    "greedy_maximal_matching",
    "hopcroft_karp_bmatch",
    "greedy_dominating_set",
    "matching_vertex_cover",
    "charikar_peel",
    "exact_lp",
]


def greedy_maximal_matching(g: Graph) -> int:
    """Size of a greedy maximal matching (>= 1/2 of maximum).

    The reference's edge-order loop over Python ints and a bytearray, one
    chunk of edges at a time: same result, a few times faster on graphs
    of ~100M edges, with the host memory of one chunk.
    """
    used = bytearray(g.n)
    cnt = 0
    chunk = 1 << 20
    for s in range(0, g.m, chunk):
        for a, b in zip(g.u[s:s + chunk].tolist(), g.v[s:s + chunk].tolist()):
            if not used[a] and not used[b]:
                used[a] = used[b] = 1
                cnt += 1
    return cnt


def hopcroft_karp_bmatch(g: Graph) -> int:
    """Exact maximum bipartite matching via scipy (C Hopcroft–Karp)."""
    assert g.bipartite_split is not None
    s = g.bipartite_split
    rows = g.u
    cols = g.v - s
    biadj = sp.csr_matrix(
        (np.ones(g.m, np.int8), (rows, cols)), shape=(s, g.n - s)
    )
    match = sp.csgraph.maximum_bipartite_matching(biadj, perm_type="column")
    return int((match >= 0).sum())


def greedy_dominating_set(g: Graph) -> int:
    """Greedy set cover specialization: lazy-heap max-coverage."""
    ptr, adj, _ = g.adjacency_lists()
    covered = np.zeros(g.n, bool)
    # gain(v) = |{v} ∪ N(v) uncovered|
    gain = (ptr[1:] - ptr[:-1]) + 1
    heap = [(-int(gain[i]), i) for i in range(g.n)]
    heapq.heapify(heap)
    n_cov = 0
    size = 0
    while n_cov < g.n:
        negg, v = heapq.heappop(heap)
        # lazy re-evaluation
        nbrs = adj[ptr[v] : ptr[v + 1]]
        cur = int(~covered[v]) + int((~covered[nbrs]).sum())
        if cur == 0:
            continue
        if -negg != cur:
            heapq.heappush(heap, (-cur, v))
            continue
        size += 1
        if not covered[v]:
            covered[v] = True
            n_cov += 1
        newly = nbrs[~covered[nbrs]]
        covered[newly] = True
        n_cov += len(newly)
    return size


def matching_vertex_cover(g: Graph) -> int:
    """2-approx vertex cover: both endpoints of a maximal matching."""
    return 2 * greedy_maximal_matching(g)


def charikar_peel(g: Graph):
    """Charikar's greedy peel: exact on the peel sequence, 2-approx of rho*.

    Returns (best_density, best_size).
    """
    ptr, adj, _ = g.adjacency_lists()
    deg = (ptr[1:] - ptr[:-1]).astype(np.int64)
    alive = np.ones(g.n, bool)
    m_alive = g.m
    n_alive = g.n
    heap = [(int(deg[i]), i) for i in range(g.n)]
    heapq.heapify(heap)
    best = (m_alive / max(n_alive, 1), n_alive)
    while n_alive > 1:
        d, v = heapq.heappop(heap)
        if not alive[v] or d != deg[v]:
            continue
        alive[v] = False
        m_alive -= deg[v]
        n_alive -= 1
        for w in adj[ptr[v] : ptr[v + 1]]:
            if alive[w]:
                deg[w] -= 1
                heapq.heappush(heap, (int(deg[w]), int(w)))
        dens = m_alive / max(n_alive, 1)
        if dens > best[0]:
            best = (dens, n_alive)
    return best


# ----------------------------------------------------------------------
# Exact LP baselines via scipy/HiGHS (the CPLEX/Gurobi role)
# ----------------------------------------------------------------------

def _incidence_sparse(g: Graph) -> sp.csr_matrix:
    rows = np.concatenate([g.u, g.v])
    cols = np.tile(np.arange(g.m), 2)
    return sp.csr_matrix((np.ones(2 * g.m), (rows, cols)), shape=(g.n, g.m))


def exact_lp(problem: str, g: Graph):
    """Solve the exact LP relaxation with HiGHS; returns (value, seconds).

    Problems: match/bmatch (max 1.x : Mx<=1), vcover (min 1.x : M^T x>=1),
    dom-set (min 1.x : (I+A)x>=1), dense-sub (min D : Wz>=1, Oz<=D).
    """
    from scipy.optimize import linprog

    t0 = time.perf_counter()
    if problem in ("match", "bmatch"):
        M = _incidence_sparse(g)
        res = linprog(
            c=-np.ones(g.m), A_ub=M, b_ub=np.ones(g.n), bounds=(0, None), method="highs"
        )
        val = -res.fun
    elif problem == "vcover":
        M = _incidence_sparse(g)
        res = linprog(
            c=np.ones(g.n), A_ub=-M.T.tocsr(), b_ub=-np.ones(g.m), bounds=(0, None), method="highs"
        )
        val = res.fun
    elif problem == "dom-set":
        rows = np.concatenate([g.u, g.v, np.arange(g.n)])
        cols = np.concatenate([g.v, g.u, np.arange(g.n)])
        IA = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(g.n, g.n))
        res = linprog(
            c=np.ones(g.n), A_ub=-IA, b_ub=-np.ones(g.n), bounds=(0, None), method="highs"
        )
        val = res.fun
    elif problem == "dense-sub":
        # vars = (z in R^{2m}, D); min D ; -Wz <= -1 ; Oz - D 1 <= 0
        m, n = g.m, g.n
        W = sp.csr_matrix(
            (np.ones(2 * m), (np.repeat(np.arange(m), 2), np.arange(2 * m))),
            shape=(m, 2 * m),
        )
        O = sp.csr_matrix(
            (
                np.ones(2 * m),
                (
                    np.stack([g.u, g.v], axis=1).ravel(),
                    np.arange(2 * m),
                ),
            ),
            shape=(n, 2 * m),
        )
        A1 = sp.hstack([-W, sp.csr_matrix((m, 1))])
        A2 = sp.hstack([O, sp.csr_matrix(-np.ones((n, 1)))])
        A = sp.vstack([A1, A2]).tocsr()
        b = np.concatenate([-np.ones(m), np.zeros(n)])
        c = np.zeros(2 * m + 1)
        c[-1] = 1.0
        res = linprog(c=c, A_ub=A, b_ub=b, bounds=(0, None), method="highs")
        val = res.fun
    else:
        raise ValueError(problem)
    if not res.success:
        raise RuntimeError(f"HiGHS failed on {problem}: {res.message}")
    return float(val), time.perf_counter() - t0
