"""repro_torch.api — the public surface for graph-LP solving on PyTorch.

Build a :class:`Problem` with the builders of :mod:`repro_torch.graphs`
(or by hand from :mod:`repro_torch.core` operators), then::

    from repro_torch.api import Solver
    from repro_torch.graphs import build, rgg

    sol = Solver().solve(build("match", rgg(10)))            # on the GPU
    sol = Solver().solve(build("match", rgg(10), device="cpu"))
    print(sol.objective, sol.feasibility_calls)

``Solver.solve_batch(problem, bounds)`` solves several bounds as the lanes
of one loop; with :func:`stack_problems` and ``batched_problem=True``,
several same-shape instances.
"""
from ..core.mwu import MWUOptions, MWUResult, Status
from .problem import BOUND_MODES, SENSES, Problem, problem_from_numpy
from .solver import Solution, Solver, stack_problems

__all__ = [
    "Problem",
    "Solution",
    "Solver",
    "MWUOptions",
    "MWUResult",
    "Status",
    "SENSES",
    "BOUND_MODES",
    "problem_from_numpy",
    "stack_problems",
]
