"""Edge partitions of the implicit incidence matrix and the grid products
over them (paper §5.2), in numpy and ``torch.distributed``.

Port of ``repro.sparsela``: :mod:`.partition` holds the host-side layouts
(the 1-D edge slabs of :mod:`repro_torch.dist`, the 2-D grid cells of the
legacy solver), :mod:`.distributed` the products over a G x G rank grid.
"""
from .partition import Partition2D, partition_edges, partition_edges_1d

__all__ = ["Partition2D", "partition_edges", "partition_edges_1d"]
