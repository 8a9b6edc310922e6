"""repro_torch.dist — the rank-distributed solver layer (paper §5), on ``torch.distributed``.

Port of ``repro.dist``, the distributed translation of the paper's MPI
scheme:

* :class:`MeshPlan` — host-side (pod, data) rank description, resolved
  into this rank's process groups (:class:`Mesh`) from the caller's
  default group (frozen, hashable).
* :mod:`repro_torch.dist.shard` — the slab layout of a ``Problem`` plus
  the :class:`PodSum` / :class:`SlabCols` operator wrappers that
  all_reduce-complete the constraint-space coupling.
* :class:`DistSolver` — ``repro_torch.api.Solver`` with its feasibility
  primitives run over the mesh; bit-identical on ``MeshPlan()``,
  edge-slab-parallel on pod-split plans.

``repro_torch.lpserve`` accepts a ``MeshPlan`` in its config to split lane
slots across the ranks; ``core.mwu_dist`` is the deprecated predecessor
kept as a shim over this package. The reference's ``problem_specs`` (a
``shard_map`` spec tree) has no counterpart: each rank cuts its own slab,
:func:`pod_slab`.

Run it on the CPU with gloo processes, or on GPUs with ``torchrun``::

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file:///tmp/init", rank=r, world_size=4)
    sol = DistSolver(plan=MeshPlan(pod=2, data=2)).solve(build("match", g, device="cpu"))
"""
from .mesh import DATA_AXIS, POD_AXIS, Mesh, MeshPlan
from .shard import PodSum, SlabCols, global_columns, pod_mode, pod_slab, slab_pad_problem
from .solver import DistSolver

__all__ = [
    "MeshPlan",
    "Mesh",
    "POD_AXIS",
    "DATA_AXIS",
    "DistSolver",
    "PodSum",
    "SlabCols",
    "pod_mode",
    "pod_slab",
    "slab_pad_problem",
    "global_columns",
]
