"""Core MWU positive-LP solver in PyTorch: operators, smoothing, step size, the loop.

Also the MPCSolver baseline of the Figure-3 study (``gradient_descent``:
``MPCOptions``, ``mpc_solve``) and the deprecated binary-search shims of
``feasibility`` (``maximize_packing``, ``minimize_covering``,
``densest_subgraph_search``, ``BinarySearchResult``) and ``mwu_dist`` (the
distributed shims over ``repro_torch.dist``), which the package resolves
lazily (PEP 562): the first use of one warns once, and importing
``repro_torch.core`` itself stays silent.
"""
from .gradient_descent import MPCOptions, mpc_solve
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
    "MPCOptions",
    "mpc_solve",
    "BinarySearchResult",
    "maximize_packing",
    "minimize_covering",
    "densest_subgraph_search",
]

# the deprecated shims: name -> (warning key, replacement)
_DEPRECATED = {
    name: ("repro_torch.core.feasibility", "repro_torch.api.Solver.solve")
    for name in ("maximize_packing", "minimize_covering", "densest_subgraph_search")
}
_DEPRECATED["BinarySearchResult"] = ("repro_torch.core.feasibility", "repro_torch.api.Solution")


def __getattr__(name):
    if name == "mwu_dist":  # the deprecated distributed shims; the module warns once on import
        import importlib

        return importlib.import_module(".mwu_dist", __name__)
    entry = _DEPRECATED.get(name)
    if entry is None:
        raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
    from ..utils.deprecation import warn_once
    from . import feasibility

    key, replacement = entry
    warn_once(key, f"{key} is deprecated; use {replacement}")
    return getattr(feasibility, name)
