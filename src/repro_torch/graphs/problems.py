"""Graph problems as declarative positive LPs (paper §3), in PyTorch.

Port of ``repro.graphs.problems``. Each builder returns a
:class:`repro_torch.api.Problem` bundling the implicit operators, the
objective, search bounds from combinatorial heuristics (``baselines``,
on the host) and the metadata the :class:`repro_torch.api.Solver` needs.
Builders take ``device`` (default ``"cuda"``) and ``dtype`` (default
float64, the reference's x64 setting); edge indices go to the device
once, as int32.

| problem    | LP                                   | type          |
|------------|--------------------------------------|---------------|
| match      | max 1.x : M x <= 1                   | pure packing  |
| bmatch     | same, bipartite input                | pure packing  |
| vcover     | min 1.x : M^T x >= 1                 | pure covering |
| dom-set    | min 1.x : (I+A) x >= 1               | pure covering |
| dense-sub  | min D : W z >= 1, O z <= D 1         | mixed, D-search |
| gen-match  | exists x: lb <= M x <= ub, x <= 1    | mixed feasibility |
"""
from __future__ import annotations

import numpy as np
import torch

from ..api.problem import Problem
from ..core.operators import (
    AdjacencyPlusId,
    Coo,
    Incidence,
    InterweavedId,
    ScaledRows,
    Transposed,
    VertexEdgePair,
    VStack,
)
from . import baselines
from .graph import Graph

__all__ = ["matching_lp", "bmatching_lp", "vcover_lp", "domset_lp", "densest_subgraph_lp",
           "generalized_matching_lp", "generalized_matching_problem", "build", "PROBLEMS"]

F64 = torch.float64


def _edges(g: Graph, device):
    return torch.as_tensor(g.u, device=device), torch.as_tensor(g.v, device=device)


def matching_lp(g: Graph, name="match", *, device="cuda", dtype=F64) -> Problem:
    """max <1,x> : Mx <= 1 (eq. 6). Bounds via greedy maximal matching:
    greedy g_m has nu_int <= 2 g_m, and LP <= 3/2 nu_int <= 3 g_m."""
    u, v = _edges(g, device)
    P = Incidence(u=u, v=v, n_vertices=g.n)
    gm = max(baselines.greedy_maximal_matching(g), 1)
    lo, hi = float(gm), float(min(3.0 * gm, g.n / 2.0) + 1.0)
    return Problem(
        name=name, kind="packing", sense="max", bound_mode="objective_covering",
        P=P, c=torch.ones(g.m, dtype=dtype, device=device), lo=lo, hi=hi, n_vars=g.m, nnz=P.nnz, graph=g,
        device=device, dtype=dtype,
    )


def bmatching_lp(g: Graph, *, device="cuda", dtype=F64) -> Problem:
    """Bipartite matching: LP is integral (no gap); bounds [g_m, 2 g_m]."""
    if g.bipartite_split is None:
        raise ValueError("bmatch requires a bipartite graph")
    u, v = _edges(g, device)
    P = Incidence(u=u, v=v, n_vertices=g.n)
    gm = max(baselines.greedy_maximal_matching(g), 1)
    lo, hi = float(gm), float(2.0 * gm + 1.0)
    return Problem(
        name="bmatch", kind="packing", sense="max", bound_mode="objective_covering",
        P=P, c=torch.ones(g.m, dtype=dtype, device=device), lo=lo, hi=hi, n_vars=g.m, nnz=P.nnz, graph=g,
        device=device, dtype=dtype,
    )


def vcover_lp(g: Graph, *, device="cuda", dtype=F64) -> Problem:
    """min <1,x> : M^T x >= 1 (eq. 10). LP duality: LP(vcover) = LP(match),
    so greedy matching g_m gives bounds [g_m, 2 g_m]."""
    u, v = _edges(g, device)
    C = Transposed(Incidence(u=u, v=v, n_vertices=g.n))
    gm = max(baselines.greedy_maximal_matching(g), 1)
    lo, hi = max(float(gm) * 0.5, 0.5), float(2.0 * gm)
    return Problem(
        name="vcover", kind="covering", sense="min", bound_mode="objective_packing",
        C=C, c=torch.ones(g.n, dtype=dtype, device=device), lo=lo, hi=hi, n_vars=g.n, nnz=C.nnz, graph=g,
        device=device, dtype=dtype,
    )


def domset_lp(g: Graph, *, device="cuda", dtype=F64) -> Problem:
    """min <1,x> : (I+A) x >= 1 (eq. 8). Greedy set-cover bound:
    greedy g_d <= (ln(Delta+1)+1) LP  =>  LP in [g_d / (ln(D+1)+1), g_d]."""
    u, v = _edges(g, device)
    C = AdjacencyPlusId(u=u, v=v, n_vertices=g.n)
    gd = max(baselines.greedy_dominating_set(g), 1)
    dmax = int(g.degrees().max(initial=1))
    lo = max(float(gd) / (np.log(dmax + 1.0) + 1.0) * 0.5, 0.25)
    hi = float(gd) + 1.0
    return Problem(
        name="dom-set", kind="covering", sense="min", bound_mode="objective_packing",
        C=C, c=torch.ones(g.n, dtype=dtype, device=device), lo=lo, hi=hi, n_vars=g.n, nnz=C.nnz, graph=g,
        device=device, dtype=dtype,
    )


def densest_subgraph_lp(g: Graph, *, device="cuda", dtype=F64) -> Problem:
    """min D : Wz >= 1, Oz <= D (eq. 15). Charikar peel rho_g: rho* in
    [rho_g, 2 rho_g]; D feasible iff D >= rho*. The density bound D scales
    the packing rows (``bound_mode="scale_packing"``)."""
    u, v = _edges(g, device)
    W = InterweavedId(n_edges=g.m, device=device)
    O = VertexEdgePair(u=u, v=v, n_vertices=g.n)
    rho_g, _ = baselines.charikar_peel(g)
    rho_g = max(rho_g, 0.5)
    lo, hi = rho_g * 0.999, 2.0 * rho_g + 1.0
    return Problem(
        name="dense-sub", kind="densest", sense="min", bound_mode="scale_packing",
        P=O, C=W, lo=lo, hi=hi, n_vars=2 * g.m, nnz=W.nnz + O.nnz, graph=g, device=device, dtype=dtype,
    )


def generalized_matching_lp(g: Graph, lb: np.ndarray, ub: np.ndarray, *, device="cuda", dtype=F64):
    """Feasibility: lb <= M x <= ub, x in [0,1]^m (Appendix A.1).

    Returns (P, C, c_mask): rows are normalized to 1-RHS
    (P = diag(1/ub) M ; C = diag(1/lb) M with lb==0 rows masked). The
    x <= 1 box is appended as packing rows via an identity Coo.
    """
    u, v = _edges(g, device)
    M = Incidence(u=u, v=v, n_vertices=g.n)
    ub = np.maximum(np.asarray(ub, np.float64), 1e-12)
    lb = np.asarray(lb, np.float64)
    degree_rows = ScaledRows(scale=torch.as_tensor(1.0 / ub, device=device).to(dtype), inner=M)
    eye = torch.arange(g.m, dtype=torch.int32, device=device)
    box_rows = Coo(rows=eye, cols=eye, vals=torch.ones(g.m, dtype=dtype, device=device), _shape=(g.m, g.m))
    P = VStack(ops=(degree_rows, box_rows))
    lb_safe = np.where(lb > 0, lb, 1.0)
    C = ScaledRows(scale=torch.as_tensor(1.0 / lb_safe, device=device).to(dtype), inner=M)
    c_mask = torch.as_tensor(lb > 0, device=device)
    return P, C, c_mask


def generalized_matching_problem(g: Graph, lb: np.ndarray, ub: np.ndarray, *, device="cuda",
                                 dtype=F64) -> Problem:
    """Declarative :class:`Problem` form of :func:`generalized_matching_lp`."""
    P, C, c_mask = generalized_matching_lp(g, lb, ub, device=device, dtype=dtype)
    return Problem(
        name="gen-match", kind="mixed", sense="feasibility", bound_mode="none",
        P=P, C=C, c_mask=c_mask, n_vars=g.m, nnz=P.nnz + C.nnz, graph=g, device=device, dtype=dtype,
    )


PROBLEMS = {
    "match": matching_lp,
    "bmatch": bmatching_lp,
    "vcover": vcover_lp,
    "dom-set": domset_lp,
    "dense-sub": densest_subgraph_lp,
}


def build(problem: str, g: Graph, *, device="cuda", dtype=F64) -> Problem:
    return PROBLEMS[problem](g, device=device, dtype=dtype)
