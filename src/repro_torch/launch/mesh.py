"""Production meshes over ``torch.distributed``, and the placements of a spec tree.

Port of ``repro.launch.mesh``. Functions, not module constants: importing
this module touches no process group and no device. Each mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process group
that the caller initialised (fake, gloo or nccl); nothing here picks a
backend. The dry run (:mod:`repro_torch.launch.dryrun`) fabricates 512 ranks
with PyTorch's fake process group, as the reference fabricates 512 host
devices with ``XLA_FLAGS``; a real deployment gets the same shapes from its
ranks.

How this relates to ``repro_torch.dist.mesh``: a ``MeshPlan`` there is the
MWU solver's (pod, data) rank request, resolved into the two process
groups its loop reduces over. The meshes here carry the LM plane's named
axes ("pod", "data", "model") for the models' partition specs
(``repro_torch.models.common.P``). The dry run's MWU cell runs a
``MeshPlan`` over the same fake ranks.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..models.common import P

__all__ = ["make_production_mesh", "make_mesh", "sharding_for", "axis_sizes", "local_shape", "local_bytes",
           "map_specs"]


def make_mesh(shape, axes, devices=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the ranks ``devices`` (default:
    the first ``prod(shape)`` ranks of the default group), row-major. Tests
    use (1, 1) and (2, 2) meshes; the default group must already exist."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: {len(shape)} dims {shape} for {len(axes)} axes {axes}")
    n = math.prod(shape)
    ranks = torch.arange(n) if devices is None else torch.as_tensor(list(devices), dtype=torch.int64)
    if ranks.numel() != n:
        raise ValueError(f"make_mesh: {ranks.numel()} ranks for a mesh of {n}")
    if not dist.is_initialized() or dist.get_world_size() < n:
        world = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(f"make_mesh: a mesh of {n} ranks needs a default process group of at least {n} "
                         f"(initialised: {world}); call torch.distributed.init_process_group first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks.reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) over ("data", "model"): one pod of 256 ranks; or (2, 16, 16)
    over ("pod", "data", "model"): two pods, 512 ranks."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def axis_sizes(mesh) -> dict:
    """Axis name -> its size on ``mesh`` (a ``DeviceMesh``, or such a dict)."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def local_shape(shape, spec: P, mesh) -> tuple:
    """A tensor's shard on one rank (the largest, rank 0's): each dim split
    over its spec entry's axes, rounded up where they do not divide it, as
    DTensor's first chunk and XLA's padded shard are."""
    sizes = axis_sizes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)} has dims")
    out = list(shape)
    for i, entry in enumerate(spec):
        out[i] = -(-out[i] // math.prod(sizes[a] for a in _axes(entry)))
    return tuple(out)


def local_bytes(t: torch.Tensor, spec: P, mesh) -> int:
    """Bytes of ``t``'s shard on one rank under ``spec``."""
    return math.prod(local_shape(t.shape, spec, mesh)) * t.element_size()


def map_specs(fn, tree):
    """``fn`` applied to every ``P`` of a spec tree (dicts, tuples and
    NamedTuples, lists), the tree's structure kept."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return tree


def sharding_for(mesh: DeviceMesh, spec_tree):
    """Spec tree -> the same tree of placements on ``mesh``: for each ``P``,
    one placement a mesh dim, ``Shard(i)`` where the dim's axis splits
    tensor dim i, else ``Replicate()`` (``distribute_tensor``'s argument)."""
    names = mesh.mesh_dim_names

    def placements(spec: P):
        dims = {a: i for i, entry in enumerate(spec) for a in _axes(entry)}
        unknown = set(dims) - set(names)
        if unknown:
            raise ValueError(f"spec {spec} names axes {sorted(unknown)} that the mesh {names} lacks")
        return [Shard(dims[a]) if a in dims else Replicate() for a in names]

    return map_specs(placements, tree=spec_tree)
