"""Launch: production meshes and the dry run.

Port of ``repro.launch``. :mod:`.mesh` builds the named meshes over
``torch.distributed`` and maps partition specs to placements;
:mod:`.dryrun` reckons every (arch x shape x mesh) cell and the paper's
MWU cell on the meta device, with no card (``python -m
repro_torch.launch.dryrun --list``).
"""
from .mesh import make_mesh, make_production_mesh, sharding_for

__all__ = ["make_mesh", "make_production_mesh", "sharding_for"]
