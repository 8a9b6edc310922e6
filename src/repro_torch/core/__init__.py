"""Core MWU positive-LP solver in PyTorch: operators, smoothing, step size, the loop."""
from .mwu import MWUOptions, MWUResult, Status, solve, solve_lanes, solve_traced
from .operators import (
    AdjacencyPlusId,
    Coo,
    Dense,
    Incidence,
    InterweavedId,
    LinOp,
    OnesRow,
    ScaledRows,
    Transposed,
    VertexEdgePair,
    VStack,
)

__all__ = [
    "MWUOptions",
    "MWUResult",
    "Status",
    "solve",
    "solve_lanes",
    "solve_traced",
    "LinOp",
    "Dense",
    "Coo",
    "Incidence",
    "AdjacencyPlusId",
    "VertexEdgePair",
    "InterweavedId",
    "Transposed",
    "ScaledRows",
    "OnesRow",
    "VStack",
]
