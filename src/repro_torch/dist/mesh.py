"""Rank planning for the distributed solver layer, over ``torch.distributed``.

Port of ``repro.dist.mesh``. A :class:`MeshPlan` is a frozen, hashable
(pod, data) request; :meth:`MeshPlan.build` resolves it into this rank's
process groups (a :class:`Mesh`) from the default group the caller
initialised (``torch.distributed.init_process_group``, or ``torchrun``),
with the caller's backend (gloo, nccl). Nothing here picks a backend.

Two axes (paper §5 mapped onto ranks):

* ``data`` — the embarrassingly-parallel fan-out axis: independent
  feasibility lanes (binary-search bounds, stacked graph instances,
  lpserve lane slots) split here with no communication, the MPI
  rank-level parallelism of the paper's bound sweep.
* ``pod``  — the within-solve axis: one LP's *variable space* is
  slab-partitioned here (:mod:`repro_torch.dist.shard`), with the
  smax/smin coupling completed by per-iteration ``all_reduce``s — the
  paper's edge-partitioned OpenMP+MPI scheme, the all_reduce standing in
  for its neighbor exchange.

The ranks are laid out row-major over (pod, data), as the reference lays
out its devices: rank = pod_index * data + data_index. A pod group (the
ranks that cooperate on one lane group) is {d, data + d, 2 data + d, ...};
a data group (the ranks that hold one pod slab of every lane group) is
{p data, ..., p data + data - 1}.

The reference's ``MeshPlan.shard_map`` and its ``utils.compat`` kwargs
(``check_vma``/``check_rep``) have no counterpart: they are jax's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["MeshPlan", "Mesh", "POD_AXIS", "DATA_AXIS"]

POD_AXIS = "pod"
DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a built :class:`MeshPlan`: its indices on both
    axes and its two process groups (None on an axis of size 1)."""

    pod_index: int
    data_index: int
    pod_group: Any  # the ranks of this rank's lane group, one per pod slab
    data_group: Any  # the ranks holding this rank's pod slab, one per lane group


# one Mesh per plan per default group: creating a group is collective over
# the default group, so every rank creates the plan's groups once, together
_MESH_CACHE: dict = {}


def world_timeout():
    """The default group's timeout, which the plan's groups take on (the
    default timeout where its backend has no options: the fake backend of
    ``repro_torch.launch.dryrun``)."""
    backend = dist.get_backend()
    device = torch.device("cuda" if backend == "nccl" else "cpu")
    options = dist.group.WORLD._get_backend(device).options
    return dist.default_pg_timeout if options is None else options._timeout


@dataclass(frozen=True)
class MeshPlan:
    """A hashable (pod, data) rank request, resolved host-side.

    ``pod`` ranks cooperate on each solve (variable-space slabs +
    all_reduce); ``data`` groups run independent lanes. ``MeshPlan()`` is
    the 1-rank identity plan, which needs no process group: the
    distributed solver run under it is bit-identical to the single-device
    ``Solver`` path.
    """

    pod: int = 1
    data: int = 1

    def __post_init__(self):
        if self.pod < 1 or self.data < 1:
            raise ValueError(f"MeshPlan axes must be >= 1, got pod={self.pod} data={self.data}")

    @property
    def n_devices(self) -> int:
        return self.pod * self.data

    @property
    def axes(self) -> tuple[str, str]:
        return (POD_AXIS, DATA_AXIS)

    def build(self) -> Mesh:
        """This rank's :class:`Mesh`: its groups of the plan over the default
        group, whose world size must be ``pod * data``. Every rank of the
        default group must call it (group creation is collective)."""
        if self.n_devices == 1:
            return _MESH_CACHE.setdefault((self, None), Mesh(0, 0, None, None))
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.n_devices:
            raise ValueError(
                f"MeshPlan(pod={self.pod}, data={self.data}) needs {self.n_devices} ranks but the default "
                f"process group has {world} (start {self.n_devices} processes with "
                "torch.distributed.init_process_group(world_size=...) or torchrun --nproc-per-node)"
            )
        key = (self, dist.group.WORLD)
        mesh = _MESH_CACHE.get(key)
        if mesh is not None:
            return mesh
        timeout = world_timeout()
        # every rank creates every group of an axis longer than 1, in one order
        pod_groups = [dist.new_group([p * self.data + d for p in range(self.pod)], timeout=timeout)
                      for d in range(self.data)] if self.pod > 1 else None
        data_groups = [dist.new_group([p * self.data + d for d in range(self.data)], timeout=timeout)
                       for p in range(self.pod)] if self.data > 1 else None
        p, d = divmod(dist.get_rank(), self.data)
        mesh = Mesh(p, d, pod_groups and pod_groups[d], data_groups and data_groups[p])
        _MESH_CACHE[key] = mesh
        return mesh
