"""Host-side graphs, generators, baselines and the problem builders.

Numpy copies of ``repro.graphs.{graph,generators,baselines}`` (the same
graphs and baseline values, seed for seed) and the PyTorch builders of
``problems.py``.
"""
from .graph import Graph
from .generators import bipartite_ratings, erdos, grid2d, kron, rgg
from .problems import (
    PROBLEMS,
    bmatching_lp,
    build,
    densest_subgraph_lp,
    domset_lp,
    generalized_matching_lp,
    generalized_matching_problem,
    matching_lp,
    vcover_lp,
)

__all__ = [
    "Graph",
    "rgg",
    "kron",
    "erdos",
    "grid2d",
    "bipartite_ratings",
    "PROBLEMS",
    "build",
    "matching_lp",
    "bmatching_lp",
    "vcover_lp",
    "domset_lp",
    "densest_subgraph_lp",
    "generalized_matching_lp",
    "generalized_matching_problem",
]
